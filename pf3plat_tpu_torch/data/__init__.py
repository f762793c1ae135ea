"""Host-side data pipeline of the port (numpy; chunk files to batches)."""
