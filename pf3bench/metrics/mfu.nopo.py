"""mfu.nopo (%): the model FLOPs of one NoPoSplat training step
(`cells/<workload>.json`, counted by `pf3bench.flops` over the reference)
over its mean wall time in the window, against the card's bf16 dense peak."""
from pf3bench.stats import mfu


def read(run):
    flops = run["work"].get("model_flops")
    if not flops:
        return None
    rec = run["record"]
    return mfu(flops, rec["window_s"] / rec["count"])
