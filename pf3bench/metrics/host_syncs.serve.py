"""host_syncs.serve (count): the blocking CUDA runtime calls (stream, device
and event synchronisations, copies without "Async") on any thread that
start inside a `pf3.forward` range of the profiled sub-window, per
request."""
from pf3bench import spans


def read(run):
    return spans.syncs_per(run, "pf3.forward")
