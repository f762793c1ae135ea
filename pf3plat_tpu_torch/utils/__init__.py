"""Config, logging and profiling helpers of the port."""
