"""aggregator_ms.vggt (ms): the device time of VGGT's `aggregator` stage (the 24
frame/global attention pairs, `pf3.vggt.aggregator`), from CUDA events at the
stage's `timer` boundary, averaged over the window's requests."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "aggregator")
