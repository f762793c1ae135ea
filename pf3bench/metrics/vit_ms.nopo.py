"""vit_ms.nopo (ms): the device time of NoPoSplat's `vit` stage (the
ViT-L encoder over both views, `pf3.nopo.vit`), from CUDA events at the
stage's `timer` boundary, averaged over the window's steps."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "vit")
