"""Pair compaction for the streamed rasterizer (kernel B1) and the
per-gaussian gradient reduce of its backward (kernel B4), each with its
plain version.

Port of `pf3plat_tpu/ops/rasterizer/compact.py` (`pairs_budget`,
`compact_pairs`, `banded_dup_reduce`). The JAX package expands every gaussian into `max_dup`
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

`dup_reduce` (kernel B4, `csrc/dup_reduce.cu`, replacing
`compact.py:_banded_reduce_kernel`) sums each gaussian's <= max_dup
gradient rows; `dup_reduce_plain` is its plain version, bit for bit.
"""

from __future__ import annotations

import torch

from ... import kernels
from ...utils.profiling import count, tracing
from .binning import (
    INT32_MAX,
    depth_levels,
    depth_sort_key,
    fused_bits,
    tile_alpha_cull,
    tile_bounds,
)
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


def build_candidates(
    screen: ScreenGaussians, image_shape: tuple[int, int], config: RasterizeConfig,
    tile_lo: int | None = None, tile_hi: int | None = None,
) -> dict:
    """Slot-major (max_dup, b, n) candidate stream, flattened.

    `tile_lo` / `tile_hi`: keep only pairs whose flat batch*tile key lies in
    [tile_lo, tile_hi), the ownership mask of the shard-local mesh path
    (applied to `valid` before compaction, `compact.py:343-345`).

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
    if tile_lo is not None:
        key = tile + b_off
        in_box = in_box & (key >= tile_lo) & (key < tile_hi)
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


def window_fit(cnt, budget: int, window: int) -> tuple[int, int, int]:
    """Kernel B1's overflow rule over the windows' valid-row counts `cnt`
    (int64) -> (windows appended, rows written, rows valid). The rows
    written before a window do not decrease, so the appended windows form a
    prefix; the sub-128 remainder of the last one is trimmed unless a whole
    128-row block fits (never where window and budget are multiples of
    128)."""
    before = torch.cumsum(cnt, 0) - cnt  # rows written before each window
    fits = (before // 128) * 128 + window + 128 <= budget
    n_fit = int(fits.sum())
    w = int(cnt[:n_fit].sum())
    written = w
    if w % 128 and (w // 128) * 128 + 128 > budget:
        written = (w // 128) * 128
    return n_fit, written, int(cnt.sum())


def compact_candidates_plain(cand: dict, budget: int, window: int) -> dict:
    """Plain PyTorch version of kernel B1 (same outputs, bit for bit)."""
    valid = cand["valid"]
    dev = valid.device
    n_cand = valid.numel()
    n_blocks = -(-n_cand // window)
    flags = torch.zeros(n_blocks * window, dtype=torch.int64, device=dev)
    flags[:n_cand] = valid.to(torch.int64)
    cnt = flags.view(n_blocks, window).sum(dim=1)
    n_fit, written, total = window_fit(cnt, budget, window)
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
    n_windows = -(-n_cand // window)
    out = _outputs(budget, dev)
    # the windows' status words and the ticket, zeroed by the kernel's memset
    scratch = torch.empty(n_windows + 1, dtype=torch.int64, device=dev)
    kernels.launch("pf3_compact_pairs", valid.view(torch.uint8), cand["tile"], cand["dkey"],
                   cand["pid"], cand["feats"], n_cand, window, budget, scratch, out["counts"],
                   out["tile"], out["dkey"], out["ids"], out["feats"])
    return out


def compact_candidates(cand: dict, budget: int, window: int) -> dict:
    """Kernel B1 for CUDA tensors, its plain version for CPU tensors. While
    a profiler session records, the counters `raster.pairs_wanted` (valid
    candidates), `raster.pairs_written` and `raster.pairs_budget` add this
    call's counts: wanted above written is the overflow that the budget
    drops."""
    if cand["valid"].device.type == "cpu":
        out = compact_candidates_plain(cand, budget, window)
    else:
        out = compact_candidates_cuda(cand, budget, window)
    if tracing():
        count("raster.pairs_wanted", out["counts"][1])
        count("raster.pairs_written", out["counts"][0])
        count("raster.pairs_budget", budget)
    return out


def compact_pairs(
    screen: ScreenGaussians, image_shape: tuple[int, int], config: RasterizeConfig,
    tile_lo: int | None = None, tile_hi: int | None = None,
    budget_override: int | None = None,
) -> dict:
    """Expand candidate pairs (slot-major) and compact the valid rows into
    a static `budget`-row layout. `tile_lo` / `tile_hi` keep only the pairs
    of that flat tile-key range, `budget_override` sets the budget directly
    (the shard-local mesh path: each shard compacts its own tile rows into
    its own budget).

    Returns dict(tile, dkey, ids (budget,) i32 with INT32_MAX pad,
    feats (9, budget) f32 with zero pad, written () i32, total () i32,
    budget int, bits_d)."""
    b, n = screen.depth.shape
    cand = build_candidates(screen, image_shape, config, tile_lo, tile_hi)
    budget = pairs_budget(config, b, n) if budget_override is None else budget_override
    out = compact_candidates(cand, budget, config.compact_window)
    return dict(
        tile=out["tile"], dkey=out["dkey"], ids=out["ids"], feats=out["feats"],
        written=out["counts"][0], total=out["counts"][1], budget=budget,
        bits_d=cand["bits_d"],
    )


def dup_reduce_plain(grads, ids, n_gauss: int, max_dup: int):
    """Plain PyTorch version of kernel B4 (the same sums, bit for bit).

    grads (9, budget) f32 in ascending pair-id order, ids (budget,) i32
    ascending with INT32_MAX pads -> (9, n_gauss): each gaussian's sum over
    the rows it owns (owner = id // max_dup), added in ascending-id order
    from 0.0. Rows scatter into (n_gauss * max_dup, 9) slots at their id
    (pads are dropped), then the slots are added one after the other."""
    slots = torch.zeros((n_gauss * max_dup, grads.shape[0]), dtype=grads.dtype,
                        device=grads.device)
    real = ids < n_gauss * max_dup
    slots[ids[real].to(torch.int64)] = grads[:, real].T
    slots = slots.view(n_gauss, max_dup, grads.shape[0])
    out = torch.zeros((n_gauss, grads.shape[0]), dtype=grads.dtype, device=grads.device)
    for k in range(max_dup):
        out = out + slots[:, k]
    return out.T.contiguous()


def dup_reduce_cuda(grads, ids, n_gauss: int, max_dup: int):
    """Kernel B4 on the card (`csrc/dup_reduce.cu`)."""
    dev = grads.device
    if dev.type != "cuda":
        raise ValueError("dup_reduce_cuda needs CUDA tensors")
    if grads.dtype != torch.float32 or grads.dim() != 2 or grads.shape[0] != N_FEAT \
            or not grads.is_contiguous():
        raise ValueError("grads: want a contiguous (9, n) float32 tensor")
    if ids.device != dev or ids.dtype != torch.int32 or tuple(ids.shape) != (grads.shape[1],) \
            or not ids.is_contiguous():
        raise ValueError(f"ids: want a contiguous ({grads.shape[1]},) int32 tensor on {dev}")
    out = torch.empty((N_FEAT, n_gauss), dtype=torch.float32, device=dev)
    kernels.launch("pf3_dup_reduce", grads, grads.shape[1], ids, n_gauss, max_dup, out)
    return out


def dup_reduce(grads, ids, n_gauss: int, max_dup: int):
    """Kernel B4 for CUDA tensors, its plain version for CPU tensors."""
    fn = dup_reduce_plain if grads.device.type == "cpu" else dup_reduce_cuda
    return fn(grads, ids, n_gauss, max_dup)
