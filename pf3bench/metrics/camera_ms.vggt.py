"""camera_ms.vggt (ms): the device time of VGGT's `camera` stage (the camera
head's 4 passes, `pf3.vggt.camera`), from CUDA events at the stage's `timer`
boundary, averaged over the window's requests."""
from pf3bench.stats import stage_mean


def read(run):
    return stage_mean(run["record"]["stage_ms"], "camera")
