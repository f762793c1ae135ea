"""host_syncs.train (count): the blocking CUDA runtime calls on any thread
(the backward's on the autograd thread by their time) that start inside a
`pf3.train_step` range of the profiled sub-window, per step."""
from pf3bench import spans


def read(run):
    return spans.syncs_per(run, "pf3.train_step")
