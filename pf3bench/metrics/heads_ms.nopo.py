"""heads_ms.nopo (ms): the device time of NoPoSplat's `heads` stage (the
four DPT heads and the Gaussian adapter, `pf3.nopo.heads`), from CUDA events
at the stage's `timer` boundary, averaged over the window's steps."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "heads")
