"""dpt_ms.vggt (ms): the device time of VGGT's `dpt` stage (the depth and point
DPT heads, `pf3.vggt.dpt`), from CUDA events at the stage's `timer` boundary,
averaged over the window's requests."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "dpt")
