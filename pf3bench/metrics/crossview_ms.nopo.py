"""crossview_ms.nopo (ms): the device time of NoPoSplat's `crossview` stage
(the two ViT-B decoders in lockstep, `pf3.nopo.crossview`), from CUDA events
at the stage's `timer` boundary, averaged over the window's steps."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "crossview")
