"""optimizer_ms.nopo (ms): the device time of the `optimizer` stage of
NoPoSplat's train step (clipping and Adam over every trained leaf), from
CUDA events at the stage's `timer` boundary, averaged over the window's
steps."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "optimizer")
