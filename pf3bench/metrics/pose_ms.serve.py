"""pose_ms.serve (ms): the host time of the pose stage (`pf3.encoder.pose`:
the RANSAC inputs, Procrustes RANSAC per view pair and camera
synchronisation), summed over the profiled sub-window's ranges and divided
by its requests (`pf3.forward` ranges). The stage waits on the device at
each of its host syncs, so its host time is its time."""
from pf3bench import spans


def read(run):
    return spans.span_ms_per(run, "pf3.encoder.pose", "pf3.forward")
