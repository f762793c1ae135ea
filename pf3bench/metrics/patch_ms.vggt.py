"""patch_ms.vggt (ms): the device time of VGGT's `patch` stage (the DINOv2
ViT-L/14 patch embedding of every frame, `pf3.vggt.patch`), from CUDA events
at the stage's `timer` boundary, averaged over the window's requests."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "patch")
