"""attn_roofline.nopo (%): the least time of a training step's forward
attention calls (`cells/<workload>.json` `attention_calls`, counted by
`pf3bench.flops` over the reference: 4*b*h*n*m*d operations at the bf16 peak
or q, k, v and o moved once at the memory peak, whichever is longer) over
the device time of the forward attention kernels in the profiled
sub-window, per step. The kernels are found by the names that
`attn_roofline.serve` reads (the port's forward kernel and the library's
fused attention kernels), less the library's backward kernels, which a
training step also runs under some of those names (cuDNN's `..._bprop_...`,
the CUTLASS `fmha_cutlassB...`, `flash_bwd...`)."""
from pf3bench.stats import attention_least_seconds

NAMES = ("attention_fwd_kernel", "cudnn_generated_fort_native_sdpa", "fmha_cutlass", "flash_fwd")
BACKWARD = ("bprop", "fmha_cutlassB", "bwd")


def read(run):
    calls = run["work"].get("attention_calls")
    t = run["record"].get("trace")
    if not calls or t is None:
        return None
    device = sum(s for name, s, _ in t["ops"] if any(k in name for k in NAMES)
                 and not any(k in name for k in BACKWARD))
    if device <= 0:
        return None
    return 100.0 * attention_least_seconds(calls) * t["count"] / device
