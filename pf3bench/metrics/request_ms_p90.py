"""request_ms_p90 (ms): the 90th percentile of every request's wall time in
the window."""
from pf3bench.stats import percentile


def read(run):
    return percentile(run["record"]["wall_ms"], 90)
