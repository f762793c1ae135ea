"""encoder_ms.serve (ms): the device time of the `encoder` stage, from CUDA events
at the stage's `timer` boundary, summed over a request and averaged over the
window's."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "encoder")
