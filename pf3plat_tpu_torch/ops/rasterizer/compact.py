"""Pair compaction for the streamed rasterizer (kernel B1 + plain version).

Port of `pf3plat_tpu/ops/rasterizer/compact.py` (`pairs_budget`,
`compact_pairs`). The JAX package expands every gaussian into `max_dup`
slot-major candidate pairs and compacts the valid ones into a static
`budget`-row plane before the binning sort. The port keeps the candidate
stream as structure-of-arrays (valid flag, tile key, depth key, pair id,
9 feature rows) instead of a bitcast 16-row plane, and compacts it with:

  * `compact_candidates_cuda` — the hand-written kernel
    (`csrc/compact_pairs.cu`, replacing `compact.py:_compact_kernel`);
  * `compact_candidates_plain` — the same function in plain PyTorch.

`compact_candidates` takes the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. Both are bit-exact: rows,
order, the overflow rule and both counts match the JAX kernel.
"""

from __future__ import annotations

import torch

from . import kernels
from .binning import INT32_MAX, depth_sort_key, tile_alpha_cull, tile_bounds
from .types import RasterizeConfig, ScreenGaussians

N_FEAT = 9  # x, y, ca, cb, cc, op, c0, c1, c2


def pairs_budget(config: RasterizeConfig, b: int, n: int) -> int:
    """Static compacted-pair budget: `pairs_budget_factor` of the full
    b*n*max_dup expansion plus one block of slack, capped at the
    always-exact bound, rounded to max(128, chunk)."""
    total = b * n * config.max_dup
    cx = config.compact_window + 128
    q = max(128, config.chunk)

    def up(x):
        return -(-x // q) * q

    want = up(int(total * config.pairs_budget_factor) + cx)
    return max(up(cx + 128), min(want, up(total + cx)))


def depth_levels(depth, visible, bits_d: int) -> torch.Tensor:
    """Range-normalized quantized depth in [0, 2^bits_d), in float32
    exactly as the JAX fused key computes it."""
    dvalid = visible & (depth > 0)
    inf = torch.tensor(float("inf"), dtype=depth.dtype, device=depth.device)
    dmin = torch.amin(torch.where(dvalid, depth, inf))
    dmax = torch.amax(torch.where(dvalid, depth, -inf))
    levels = torch.tensor(float((1 << bits_d) - 1), dtype=torch.float32)
    span = torch.clamp(dmax - dmin, min=1e-12)
    dq = torch.clamp((depth - dmin) / span, 0.0, 1.0) * levels.to(depth.device)
    return torch.clamp(dq.to(torch.int32), max=(1 << bits_d) - 1)


def fused_bits(total_tiles: int) -> int:
    return 31 - max(1, total_tiles - 1).bit_length() - 1


def build_candidates(
    screen: ScreenGaussians, image_shape: tuple[int, int], config: RasterizeConfig
) -> dict:
    """Slot-major (max_dup, b, n) candidate stream, flattened.

    Returns dict(valid (P,) bool, tile (P,) i32 flat batch*tile key,
    dkey (P,) i32 depth sort key, pid (P,) i32 g-major pair id,
    feats (9, P) f32 sanitized features, bits_d or None)."""
    h, w = image_shape
    ts = config.tile_size
    tiles_x = -(-w // ts)
    tiles_y = -(-h // ts)
    num_tiles = tiles_x * tiles_y
    b, n = screen.depth.shape
    side = config.max_tiles_per_gaussian_side
    max_dup = config.max_dup
    total_pairs = b * n * max_dup
    total_tiles = b * num_tiles
    if total_tiles * 2 >= 2**31:
        raise ValueError("too many tiles for the int32 tile key")
    dev = screen.xy.device

    bounds = tile_bounds(screen, image_shape, config)
    visible = (bounds.tw > 0) & (bounds.th > 0)

    slot = torch.arange(max_dup, dtype=torch.int32, device=dev)[:, None, None]
    dy = slot // side
    dx = slot % side
    in_box = (dy < bounds.th[None]) & (dx < bounds.tw[None])
    if config.tight_cull:
        in_box &= tile_alpha_cull(
            screen.xy[None, ..., 0], screen.xy[None, ..., 1],
            screen.conic[None, ..., 0], screen.conic[None, ..., 1],
            screen.conic[None, ..., 2], screen.opacity[None],
            bounds.tx0[None] + dx, bounds.ty0[None] + dy,
            config,
        )
    tile = (bounds.ty0[None] + dy) * tiles_x + (bounds.tx0[None] + dx)
    b_off = (torch.arange(b, dtype=torch.int32, device=dev) * num_tiles)[None, :, None]
    g_idx = torch.arange(b * n, dtype=torch.int32, device=dev).reshape(1, b, n)
    pid = (g_idx * max_dup + slot).reshape(total_pairs)

    def pairify(x):
        return x[None].expand(max_dup, b, n).reshape(total_pairs)

    def feat(x):
        # Culled gaussians may carry inf/NaN from projection; zero them so
        # no masked arithmetic downstream meets inf * 0.
        return pairify(torch.where(visible, x, torch.zeros_like(x)).to(torch.float32))

    channels = screen.color.shape[-1]
    if channels > 3:
        raise ValueError("the streamed pipeline supports at most 3 channels")
    rows = [
        feat(screen.xy[..., 0]), feat(screen.xy[..., 1]),
        feat(screen.conic[..., 0]), feat(screen.conic[..., 1]),
        feat(screen.conic[..., 2]), feat(screen.opacity),
    ] + [feat(screen.color[..., c]) for c in range(channels)]
    rows += [torch.zeros(total_pairs, device=dev)] * (N_FEAT - len(rows))

    if config.fused_sort_key:
        bits_d = fused_bits(total_tiles)
        dkey = pairify(depth_levels(screen.depth, visible, bits_d))
    else:
        bits_d = None
        dkey = pairify(depth_sort_key(screen.depth, visible))

    return dict(
        valid=in_box.reshape(total_pairs),
        tile=(tile + b_off).to(torch.int32).reshape(total_pairs),
        dkey=dkey.contiguous(),
        pid=pid.contiguous(),
        feats=torch.stack(rows, dim=0).contiguous(),
        bits_d=bits_d,
    )


def _outputs(budget: int, device):
    return dict(
        tile=torch.empty(budget, dtype=torch.int32, device=device),
        dkey=torch.empty(budget, dtype=torch.int32, device=device),
        ids=torch.empty(budget, dtype=torch.int32, device=device),
        feats=torch.empty((N_FEAT, budget), dtype=torch.float32, device=device),
        counts=torch.empty(2, dtype=torch.int32, device=device),
    )


def compact_candidates_plain(cand: dict, budget: int, window: int) -> dict:
    """Plain PyTorch version of kernel B1 (same outputs, bit for bit)."""
    valid = cand["valid"]
    dev = valid.device
    n_cand = valid.numel()
    n_blocks = -(-n_cand // window)
    flags = torch.zeros(n_blocks * window, dtype=torch.int64, device=dev)
    flags[:n_cand] = valid.to(torch.int64)
    cnt = flags.view(n_blocks, window).sum(dim=1)
    before = torch.cumsum(cnt, 0) - cnt  # rows written before each block
    # W is non-decreasing, so the appended blocks form a prefix.
    fits = (before // 128) * 128 + window + 128 <= budget
    n_fit = int(fits.sum())
    w = int(cnt[:n_fit].sum())
    total = int(cnt.sum())
    written = w
    if w % 128 and (w // 128) * 128 + 128 > budget:
        written = (w // 128) * 128
    src = torch.nonzero(valid[: n_fit * window]).squeeze(1)[:written]

    out = _outputs(budget, dev)
    for key, name in (("tile", "tile"), ("dkey", "dkey"), ("ids", "pid")):
        out[key].fill_(INT32_MAX)
        out[key][:written] = cand[name][src]
    out["feats"].zero_()
    out["feats"][:, :written] = cand["feats"][:, src]
    out["counts"] = torch.tensor([written, total], dtype=torch.int32, device=dev)
    return out


def compact_candidates_cuda(cand: dict, budget: int, window: int) -> dict:
    """Kernel B1 on the card (`csrc/compact_pairs.cu`)."""
    valid = cand["valid"]
    dev = valid.device
    n_cand = valid.numel()
    if dev.type != "cuda":
        raise ValueError("compact_candidates_cuda needs CUDA tensors")
    for name, dtype, shape in (
        ("tile", torch.int32, (n_cand,)), ("dkey", torch.int32, (n_cand,)),
        ("pid", torch.int32, (n_cand,)), ("feats", torch.float32, (N_FEAT, n_cand)),
    ):
        t = cand[name]
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"candidate {name}: want {dtype} {shape} contiguous on {dev}")
    if valid.dtype != torch.bool or not valid.is_contiguous():
        raise ValueError("candidate valid: want a contiguous bool tensor")
    if window % 128 or budget % 128:
        raise ValueError("window and budget must be multiples of 128")
    n_blocks = -(-n_cand // window)
    out = _outputs(budget, dev)
    scratch = torch.empty((2, n_blocks), dtype=torch.int32, device=dev)
    lib = kernels.load("compact_pairs")
    fn = lib.pf3_compact_pairs
    fn.restype = kernels.ctypes.c_int
    vp = kernels.ctypes.c_void_p
    fn.argtypes = [vp] * 5 + [
        kernels.ctypes.c_longlong, kernels.ctypes.c_int, kernels.ctypes.c_longlong,
    ] + [vp] * 8
    rc = fn(
        kernels.ptr(valid.view(torch.uint8)), kernels.ptr(cand["tile"]),
        kernels.ptr(cand["dkey"]), kernels.ptr(cand["pid"]),
        kernels.ptr(cand["feats"]), n_cand, window, budget,
        kernels.ptr(scratch[0]), kernels.ptr(scratch[1]), kernels.ptr(out["counts"]),
        kernels.ptr(out["tile"]), kernels.ptr(out["dkey"]), kernels.ptr(out["ids"]),
        kernels.ptr(out["feats"]), kernels.stream_ptr(dev),
    )
    kernels.check("compact_pairs", rc)
    kernels.LAUNCHES["compact_pairs"] += 1
    return out


def compact_candidates(cand: dict, budget: int, window: int) -> dict:
    """Kernel B1 for CUDA tensors, its plain version for CPU tensors."""
    if cand["valid"].device.type == "cpu":
        return compact_candidates_plain(cand, budget, window)
    return compact_candidates_cuda(cand, budget, window)


def compact_pairs(
    screen: ScreenGaussians, image_shape: tuple[int, int], config: RasterizeConfig
) -> dict:
    """Expand candidate pairs (slot-major) and compact the valid rows into
    a static `budget`-row layout.

    Returns dict(tile, dkey, ids (budget,) i32 with INT32_MAX pad,
    feats (9, budget) f32 with zero pad, written () i32, total () i32,
    budget int, bits_d)."""
    b, n = screen.depth.shape
    cand = build_candidates(screen, image_shape, config)
    budget = pairs_budget(config, b, n)
    out = compact_candidates(cand, budget, config.compact_window)
    return dict(
        tile=out["tile"], dkey=out["dkey"], ids=out["ids"], feats=out["feats"],
        written=out["counts"][0], total=out["counts"][1], budget=budget,
        bits_d=cand["bits_d"],
    )
