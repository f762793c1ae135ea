"""Streamed rasterizer forward: pair sort + per-tile compositing (kernel B2).

Port of the forward half of `pf3plat_tpu/ops/rasterizer/streamed.py`
(single device, no mesh). Gaussians expand into slot-major candidate
pairs (compacted to a static budget by kernel B1 when the scene is large
enough), ONE `torch.sort` on the int64 key `fused << 32 | pair id` puts
them in the JAX order exactly ((fused, id) is unique), segment starts come
from `torch.searchsorted`, and kernel B2 composites each 16x16 tile's
segment from the sorted feature rows.

Compositing dispatch: `composite_fwd_cuda` (the hand-written kernel,
`csrc/composite_fwd.cu`, replacing `streamed.py:_streamed_fwd_kernel`) for
CUDA tensors, `composite_fwd_plain` (the same function in plain PyTorch)
for CPU tensors.

Forward only: the backward kernels (B3, B4) belong to the training slice.
"""

from __future__ import annotations

import torch

from . import kernels
from .binning import INT32_MAX
from .compact import (
    N_FEAT,
    build_candidates,
    compact_candidates,
    pairs_budget,
)
from .types import RasterizeConfig, ScreenGaussians


def use_compaction(config: RasterizeConfig, b: int, n: int) -> bool:
    """Compaction engages only when enabled and the scene has at least
    `compact_min_pairs` candidates."""
    return (
        config.pairs_budget_factor > 0
        and b * n * config.max_dup >= config.compact_min_pairs
    )


def _sort_pairs(tile, dkey, ids, feats, bits_d):
    """Sort rows by (tile | depth level, pair id) -> (tile_sorted, ids, feats)."""
    max_t = torch.full_like(tile, INT32_MAX)
    if bits_d is not None:
        fused = torch.where(tile == INT32_MAX, max_t, (tile << bits_d) | dkey)
        key = (fused.to(torch.int64) << 32) | ids.to(torch.int64)
        key_sorted, perm = torch.sort(key)
        fused_sorted = (key_sorted >> 32).to(torch.int32)
        tile_sorted = torch.where(
            fused_sorted == INT32_MAX, torch.full_like(fused_sorted, INT32_MAX),
            fused_sorted >> bits_d,
        )
    else:
        # Exact (tile, depth bits, id) order: stable sorts, least key first.
        perm = torch.argsort(ids, stable=True)
        perm = perm[torch.argsort(dkey[perm], stable=True)]
        perm = perm[torch.argsort(tile[perm], stable=True)]
        tile_sorted = tile[perm]
    return tile_sorted, ids[perm], feats[:, perm]


def pair_sort(screen: ScreenGaussians, image_shape, config: RasterizeConfig):
    """Uncompacted pipeline: every candidate rides the sort.

    Returns (featP (9, padded), ids_sorted, starts (bT+1,), tiles_x,
    tiles_y)."""
    h, w = image_shape
    ts = config.tile_size
    tiles_x, tiles_y = -(-w // ts), -(-h // ts)
    b = screen.depth.shape[0]
    total_tiles = b * tiles_x * tiles_y
    cand = build_candidates(screen, image_shape, config)
    tile = torch.where(
        cand["valid"], cand["tile"], torch.full_like(cand["tile"], INT32_MAX)
    )
    tile_sorted, ids_sorted, feats_sorted = _sort_pairs(
        tile, cand["dkey"], cand["pid"], cand["feats"], cand["bits_d"]
    )
    total_pairs = tile.numel()
    starts = torch.searchsorted(
        tile_sorted,
        torch.arange(total_tiles + 1, dtype=torch.int32, device=tile.device),
    ).to(torch.int32)
    c = config.chunk
    n_chunks = config.tile_capacity // c + 1
    padded = max(-(-total_pairs // c), n_chunks) * c
    featP = torch.zeros((N_FEAT, padded), dtype=torch.float32, device=tile.device)
    featP[:, :total_pairs] = feats_sorted
    return featP, ids_sorted, starts, tiles_x, tiles_y


def pair_sort_compacted(screen: ScreenGaussians, image_shape, config: RasterizeConfig):
    """Compacted pipeline (the production config): kernel B1 compacts the
    candidates to `pairs_budget` rows, then the same sort runs over them.

    Returns (featP (9, budget), ids_sorted, starts, tiles_x, tiles_y,
    counts (2,) i32 = (written, total))."""
    h, w = image_shape
    ts = config.tile_size
    tiles_x, tiles_y = -(-w // ts), -(-h // ts)
    b, n = screen.depth.shape
    total_tiles = b * tiles_x * tiles_y
    cand = build_candidates(screen, image_shape, config)
    budget = pairs_budget(config, b, n)
    c = config.chunk
    n_chunks = config.tile_capacity // c + 1
    if budget < n_chunks * c or budget % c:
        raise ValueError(
            f"pairs budget {budget} must be a chunk multiple covering one "
            f"tile window ({n_chunks * c} rows)"
        )
    cp = compact_candidates(cand, budget, config.compact_window)
    tile_sorted, ids_sorted, featP = _sort_pairs(
        cp["tile"], cp["dkey"], cp["ids"], cp["feats"], cand["bits_d"]
    )
    starts = torch.searchsorted(
        tile_sorted,
        torch.arange(total_tiles + 1, dtype=torch.int32, device=featP.device),
    ).to(torch.int32)
    return featP.contiguous(), ids_sorted, starts, tiles_x, tiles_y, cp["counts"]


def segment_rows(starts, n_cols: int, config: RasterizeConfig):
    """Per tile row: (base, off, counts) of its segment in the sorted array.

    counts = min(segment, capacity); base = the 128-aligned window start,
    clamped so all n_chunks chunk windows stay inside the array."""
    cap = config.tile_capacity
    ck = config.chunk
    n_chunks = cap // ck + 1
    counts = torch.clamp(starts[1:] - starts[:-1], max=cap)
    max_base = n_cols // ck - n_chunks
    base = torch.clamp(torch.div(starts[:-1], ck, rounding_mode="floor"), max=max_base)
    off = starts[:-1] - base * ck
    return (
        base.to(torch.int32).contiguous(),
        off.to(torch.int32).contiguous(),
        counts.to(torch.int32).contiguous(),
    )


def composite_fwd_plain(featP, base, off, counts, tile_ids, bg_rows, tiles_x,
                        channels, config: RasterizeConfig):
    """Plain PyTorch version of kernel B2 -> (img (rows, ch, p),
    tfin (rows, 1, p), tchk (rows, n_chunks, p))."""
    dev = featP.device
    ts = config.tile_size
    p = ts * ts
    ck = config.chunk
    n_chunks = config.tile_capacity // ck + 1
    rows = base.shape[0]
    local = torch.arange(p, device=dev)
    tx = (tile_ids % tiles_x).to(torch.int64)
    ty = torch.div(tile_ids, tiles_x, rounding_mode="floor").to(torch.int64)
    px = (tx[:, None] * ts + local[None] % ts).to(torch.float32) + 0.5  # (rows, p)
    py = (ty[:, None] * ts + local[None] // ts).to(torch.float32) + 0.5
    end = (off + counts).to(torch.int64)
    lane = torch.arange(ck, device=dev)

    tcar = torch.ones((rows, p), device=dev)
    accum = torch.zeros((rows, channels, p), device=dev)
    tchk = torch.zeros((rows, n_chunks, p), device=dev)
    for i in range(n_chunks):
        run = i * ck < end  # (rows,)
        tchk[:, i] = torch.where(run[:, None], tcar, torch.zeros_like(tcar))
        cols = base.to(torch.int64)[:, None] * ck + i * ck + lane[None]  # (rows, ck)
        data = featP[:, cols]  # (9, rows, ck)
        j = i * ck + lane[None]
        seg = (j >= off[:, None]) & (j < end[:, None])  # (rows, ck)
        dx = px[:, :, None] - data[0][:, None, :]  # (rows, p, ck)
        dy = py[:, :, None] - data[1][:, None, :]
        ca, cb, cc, op = (data[k][:, None, :] for k in (2, 3, 4, 5))
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=config.alpha_clamp)
        keep = (power <= 0.0) & (alpha >= config.alpha_min) & seg[:, None, :]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        s = torch.log1p(-alpha)
        incl = torch.cumsum(s, dim=-1)
        t_after = tcar[:, :, None] * torch.exp(incl)
        alive = (t_after >= config.transmittance_min) & seg[:, None, :]
        one_m = torch.clamp(1.0 - alpha, min=1.0 - config.alpha_clamp)
        wgt = torch.where(alive, (t_after / one_m) * alpha, torch.zeros_like(alpha))
        color = data[6 : 6 + channels].permute(1, 0, 2)  # (rows, ch, ck)
        accum = accum + torch.einsum("rcg,rpg->rcp", color, wgt)
        any_alive = alive.any(dim=-1)
        inf = torch.full_like(t_after, float("inf"))
        t_last = torch.amin(torch.where(alive, t_after, inf), dim=-1)
        tcar = torch.where(any_alive, t_last, tcar)
    img = accum + bg_rows[:, :, None] * tcar[:, None, :]
    return img, tcar[:, None, :], tchk


def composite_fwd_cuda(featP, base, off, counts, tile_ids, bg_rows, tiles_x,
                       channels, config: RasterizeConfig):
    """Kernel B2 on the card (`csrc/composite_fwd.cu`)."""
    dev = featP.device
    if dev.type != "cuda":
        raise ValueError("composite_fwd_cuda needs CUDA tensors")
    rows = base.shape[0]
    ts = config.tile_size
    p = ts * ts
    ck = config.chunk
    n_chunks = config.tile_capacity // ck + 1
    if featP.dtype != torch.float32 or featP.dim() != 2 or featP.shape[0] != N_FEAT \
            or not featP.is_contiguous():
        raise ValueError("featP: want a contiguous (9, n) float32 tensor")
    if featP.shape[1] < n_chunks * ck:
        raise ValueError("featP is shorter than one tile window")
    for name, t in (("base", base), ("off", off), ("counts", counts), ("tile_ids", tile_ids)):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (rows,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous ({rows},) int32 tensor on {dev}")
    if bg_rows.dtype != torch.float32 or tuple(bg_rows.shape) != (rows, channels) \
            or not bg_rows.is_contiguous():
        raise ValueError(f"bg_rows: want a contiguous ({rows}, {channels}) float32 tensor")
    if not 1 <= channels <= 3 or p > 1024:
        raise ValueError("composite_fwd supports 1-3 channels and tiles of <= 1024 pixels")
    img = torch.empty((rows, channels, p), dtype=torch.float32, device=dev)
    tfin = torch.empty((rows, 1, p), dtype=torch.float32, device=dev)
    tchk = torch.empty((rows, n_chunks, p), dtype=torch.float32, device=dev)
    ct = kernels.ctypes
    lib = kernels.load("composite_fwd")
    fn = lib.pf3_composite_fwd
    fn.restype = ct.c_int
    fn.argtypes = (
        [ct.c_void_p, ct.c_longlong] + [ct.c_void_p] * 5 + [ct.c_int] * 6
        + [ct.c_float] * 4 + [ct.c_void_p] * 4
    )
    rc = fn(
        kernels.ptr(featP), featP.shape[1], kernels.ptr(base), kernels.ptr(off),
        kernels.ptr(counts), kernels.ptr(tile_ids), kernels.ptr(bg_rows), rows,
        channels, tiles_x, ts, ck, n_chunks, config.alpha_clamp, config.alpha_min,
        1.0 - config.alpha_clamp, config.transmittance_min,
        kernels.ptr(img), kernels.ptr(tfin), kernels.ptr(tchk),
        kernels.stream_ptr(dev),
    )
    kernels.check("composite_fwd", rc)
    kernels.LAUNCHES["composite_fwd"] += 1
    return img, tfin, tchk


def composite_fwd(featP, base, off, counts, tile_ids, bg_rows, tiles_x,
                  channels, config: RasterizeConfig):
    """Kernel B2 for CUDA tensors, its plain version for CPU tensors."""
    fn = composite_fwd_plain if featP.device.type == "cpu" else composite_fwd_cuda
    return fn(featP, base, off, counts, tile_ids, bg_rows, tiles_x, channels, config)


def tiles_to_image(img_tiles, b, tiles_x, tiles_y, channels, ts):
    out = img_tiles.reshape(b, tiles_y, tiles_x, channels, ts, ts)
    return out.permute(0, 1, 4, 2, 5, 3).reshape(b, tiles_y * ts, tiles_x * ts, channels)


def prepare_streamed(screen: ScreenGaussians, image_shape, background, config):
    """Everything before kernel B2: pair sort and per-tile segment rows.

    Returns the keyword arguments of `composite_fwd` plus `stats`
    (compaction counts or None)."""
    b, n = screen.depth.shape
    channels = screen.color.shape[-1]
    stats = None
    if use_compaction(config, b, n):
        featP, _, starts, tiles_x, tiles_y, stats = pair_sort_compacted(
            screen, image_shape, config
        )
    else:
        featP, _, starts, tiles_x, tiles_y = pair_sort(screen, image_shape, config)
    num_tiles = tiles_x * tiles_y
    base, off, counts = segment_rows(starts, featP.shape[1], config)
    dev = featP.device
    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev).repeat(b)
    bg_rows = torch.repeat_interleave(
        background.to(torch.float32), num_tiles, dim=0
    ).contiguous()
    return dict(
        featP=featP, base=base, off=off, counts=counts, tile_ids=tile_ids,
        bg_rows=bg_rows, tiles_x=tiles_x, channels=channels, config=config,
    ), dict(tiles_y=tiles_y, stats=stats)


def composite_streamed_batched(
    screen: ScreenGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (b, c)
    config: RasterizeConfig,
) -> torch.Tensor:
    """Streamed-pipeline rendering of a batch of cameras -> (b, h, w, c)."""
    h, w = image_shape
    b = screen.depth.shape[0]
    args, extra = prepare_streamed(screen, image_shape, background, config)
    img_tiles, _, _ = composite_fwd(**args)
    out = tiles_to_image(
        img_tiles, b, args["tiles_x"], extra["tiles_y"], args["channels"],
        config.tile_size,
    )
    return out[:, :h, :w]
