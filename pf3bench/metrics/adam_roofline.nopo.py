"""adam_roofline.nopo (%): the least time of a step's Adam update over the
`optimizer` stage's device ms (CUDA events, the window's mean). The least
time is the program's counted elements a step (`adam.elements` over
`train_steps`, from the profiled sub-window's counters) times 32 bytes at
the memory peak: the gradient read for its norm and for the update, and the
parameter and both moments each read and written once, in float32."""
from pf3bench import spans
from pf3bench.stats import PEAK_HBM_BYTES, stage_mean

BYTES_PER_ELEMENT = 32


def read(run):
    c = spans.counters(run)
    ms = stage_mean(run["record"]["stage_ms"], "optimizer")
    if not c or not c.get("adam.elements") or not c.get("train_steps") or not ms:
        return None
    elements = c["adam.elements"] / c["train_steps"]
    return 100.0 * elements * BYTES_PER_ELEMENT / PEAK_HBM_BYTES * 1e3 / ms
