"""optimizer_ms.train (ms): the device time of the `optimizer` stage, from CUDA events
at the stage's `timer` boundary, summed over a training step and averaged over the
window's."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "optimizer")
