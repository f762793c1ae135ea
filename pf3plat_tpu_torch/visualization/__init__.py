"""Validation panels, trajectories and videos of the port."""
