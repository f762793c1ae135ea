"""attn_roofline.serve (%): the least time of every attention call of a
request (`cells/<workload>.json` `attention_calls`, counted by `pf3bench.flops`:
4*b*h*n*m*d operations at the bf16 peak or q, k, v and o moved once at the
memory peak, whichever is longer) over the device time of the kernels that
implement them in the profiled sub-window, per request.

The kernels are found by name: the port's hand-written forward kernel
(`csrc/attention_fwd.cu`) and the library's fused attention kernels that
`F.scaled_dot_product_attention` runs. A change that moves attention to a
kernel whose name is not matched here leaves its time out and needs a
`benchmark` change to add the name."""
from pf3bench.stats import attention_least_seconds

NAMES = ("attention_fwd_kernel", "cudnn_generated_fort_native_sdpa", "fmha_cutlass", "flash_fwd")


def read(run):
    calls = run["work"].get("attention_calls")
    t = run["record"].get("trace")
    if not calls or t is None:
        return None
    device = sum(s for name, s, _ in t["ops"] if any(k in name for k in NAMES))
    if device <= 0:
        return None
    return 100.0 * attention_least_seconds(calls) * t["count"] / device
