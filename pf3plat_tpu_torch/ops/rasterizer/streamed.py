"""Streamed rasterizer: pair sort + per-tile compositing, forward (kernel
B2) and backward (kernels B3, B4).

Port of `pf3plat_tpu/ops/rasterizer/streamed.py`. Gaussians expand into slot-major candidate pairs (compacted to a static
budget by kernel B1 when the scene is large enough), ONE `torch.sort` on
the int64 key `fused << 32 | pair id` puts them in the JAX order exactly
((fused, id) is unique), segment starts come from `torch.searchsorted`,
and kernel B2 composites each 16x16 tile's segment from the sorted feature
rows.

`StreamedRasterize` is the `jax.custom_vjp` of the JAX package as a
`torch.autograd.Function`: its backward replays the composite (kernel B3),
unsorts the per-pair gradients with one sort on the pair ids, and sums them
per gaussian (kernel B4 when compaction is on, a reshape-sum over
`max_dup` when it is off).

With a `mesh` of more than one shard (`parallel.Mesh`) the (batch * tile)
rows split evenly over the shards. With compaction on, the whole pipeline
runs per shard (`shard_local.py`). Without it the pair sort and the unsort
stay global: kernel B2 runs once per shard on its slice of the tile rows
with the whole sorted feature array, and the backward runs kernel B5 per
shard, which emits per-(tile, chunk) gradient blocks instead of writing
into the shared array; `merge_blocks` adds the blocks into sorted order.

Dispatch: each kernel wrapper (`composite_fwd`, `composite_bwd`,
`composite_bwd_blocks`, `compact.dup_reduce`) launches the hand-written
kernel for CUDA tensors and takes its plain PyTorch version for CPU
tensors.
"""

from __future__ import annotations

import torch

from ... import kernels
from .binning import INT32_MAX, sort_by_tile_depth
from .compact import (
    N_FEAT,
    build_candidates,
    compact_candidates,
    dup_reduce,
    pairs_budget,
)
from ...parallel.collectives import gather_in_shard_order, mesh_batch, shard_rows
from ...utils.profiling import span
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
    tile_sorted, perm = sort_by_tile_depth(tile, dkey, ids, bits_d)
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


def pair_sort_compacted(screen: ScreenGaussians, image_shape, config: RasterizeConfig,
                        tile_lo: int | None = None, n_tiles_out: int | None = None,
                        budget_override: int | None = None):
    """Compacted pipeline (the production config): kernel B1 compacts the
    candidates to `pairs_budget` rows, then the same sort runs over them.

    `tile_lo` + `n_tiles_out` (+ `budget_override`) restrict the pipeline to
    the flat tile-key range [tile_lo, tile_lo + n_tiles_out): the
    shard-local mesh path, where each shard compacts and sorts only its own
    tile rows into its own budget.

    Returns (featP (9, budget), ids_sorted, starts (n_tiles_out + 1,)
    relative to the range, tiles_x, tiles_y, counts (2,) i32 = (written,
    total))."""
    h, w = image_shape
    ts = config.tile_size
    tiles_x, tiles_y = -(-w // ts), -(-h // ts)
    b, n = screen.depth.shape
    if n_tiles_out is None:
        n_tiles_out = b * tiles_x * tiles_y
    t0 = 0 if tile_lo is None else tile_lo
    budget = pairs_budget(config, b, n) if budget_override is None else budget_override
    c = config.chunk
    n_chunks = config.tile_capacity // c + 1
    if budget < n_chunks * c or budget % c:
        raise ValueError(
            f"pairs budget {budget} must be a chunk multiple covering one "
            f"tile window ({n_chunks * c} rows)"
        )
    with span("pf3.decoder.compact"):
        cand = build_candidates(screen, image_shape, config, tile_lo,
                                None if tile_lo is None else tile_lo + n_tiles_out)
        cp = compact_candidates(cand, budget, config.compact_window)
    with span("pf3.decoder.sort"):
        tile_sorted, ids_sorted, featP = _sort_pairs(
            cp["tile"], cp["dkey"], cp["ids"], cp["feats"], cand["bits_d"]
        )
        starts = torch.searchsorted(
            tile_sorted,
            t0 + torch.arange(n_tiles_out + 1, dtype=torch.int32, device=featP.device),
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


def running_sum(s: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis, added left to right: the
    order of the kernels' running sums (B2's log-transmittance, B3's
    suffix), so the plain versions round as the kernels do. (A parallel
    cumsum differs by up to ~3e-5 in T over a full 1,024-pair segment.)"""
    acc = torch.zeros_like(s[..., 0])
    out = []
    for j in range(s.shape[-1]):
        acc = acc + s[..., j]
        out.append(acc)
    return torch.stack(out, dim=-1)


def _pixel_centres(tile_ids, tiles_x: int, ts: int):
    """Per tile row, its pixels' centres -> (px, py), each (rows, ts*ts)."""
    local = torch.arange(ts * ts, device=tile_ids.device)
    tx = (tile_ids % tiles_x).to(torch.int64)
    ty = torch.div(tile_ids, tiles_x, rounding_mode="floor").to(torch.int64)
    px = (tx[:, None] * ts + local[None] % ts).to(torch.float32) + 0.5
    py = (ty[:, None] * ts + local[None] // ts).to(torch.float32) + 0.5
    return px, py


def _chunk_alpha(data, px, py, seg, config: RasterizeConfig):
    """One chunk's features (9, rows, ck) at every pixel -> alpha
    (rows, p, ck), zeroed outside the segment `seg` (rows, ck), and the
    residuals dx, dy, gexp, unclamped (`streamed.py:_chunk_alpha_cols`)."""
    dx = px[:, :, None] - data[0][:, None, :]
    dy = py[:, :, None] - data[1][:, None, :]
    ca, cb, cc, op = (data[k][:, None, :] for k in (2, 3, 4, 5))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    gexp = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = op * gexp
    alpha = torch.clamp(alpha_raw, max=config.alpha_clamp)
    keep = (power <= 0.0) & (alpha >= config.alpha_min) & seg[:, None, :]
    alpha = torch.where(keep, alpha, torch.zeros((), device=alpha.device))
    return alpha, dx, dy, gexp, keep & (alpha_raw < config.alpha_clamp)


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
    px, py = _pixel_centres(tile_ids, tiles_x, ts)
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
        alpha = _chunk_alpha(data, px, py, seg, config)[0]  # (rows, p, ck)
        t_after = tcar[:, :, None] * torch.exp(running_sum(torch.log1p(-alpha)))
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
                       channels, config: RasterizeConfig, order=None):
    """Kernel B2 on the card (`csrc/composite_fwd.cu`), the tile rows
    started in `order` (default: `heaviest_first(counts)`)."""
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
    kernels.check_smem("composite_fwd", ts, ck)
    if order is None:
        order = heaviest_first(counts)
    img = torch.empty((rows, channels, p), dtype=torch.float32, device=dev)
    tfin = torch.empty((rows, 1, p), dtype=torch.float32, device=dev)
    tchk = torch.empty((rows, n_chunks, p), dtype=torch.float32, device=dev)
    kernels.launch("pf3_composite_fwd", featP, featP.shape[1], base, off, counts, tile_ids,
                   order, bg_rows, rows, channels, tiles_x, ts, ck, n_chunks,
                   config.alpha_clamp, config.alpha_min, 1.0 - config.alpha_clamp,
                   config.transmittance_min, img, tfin, tchk)
    return img, tfin, tchk


def composite_fwd(featP, base, off, counts, tile_ids, bg_rows, tiles_x,
                  channels, config: RasterizeConfig, order=None):
    """Kernel B2 for CUDA tensors (tile rows started in `order`), its plain
    version for CPU tensors."""
    if featP.device.type == "cpu":
        return composite_fwd_plain(featP, base, off, counts, tile_ids, bg_rows, tiles_x,
                                   channels, config)
    return composite_fwd_cuda(featP, base, off, counts, tile_ids, bg_rows, tiles_x, channels,
                              config, order)


def n_processed(tchk):
    """Chunks the forward processed per tile row: chunk i was processed iff
    its checkpoint is above 0 (written before compositing, and T stays
    positive), so the count is monotone in i (`streamed.py:1196-1203`)."""
    return (tchk.amax(dim=2) > 0.0).sum(dim=1).to(torch.int32)


def _bwd_chunks_plain(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                      g_tiles, tiles_x, channels, config: RasterizeConfig):
    """The reverse walk of kernels B3 and B5 in plain PyTorch
    (`_bwd_chunk_grads` per chunk, last chunk first) -> (chunks, dbg):
    `chunks` lists (i, d_chunk (9, rows, chunk)), the gradients of every
    tile row's window rows base * chunk + i * chunk + lane, exact zeros
    outside the tile's segment and in chunks the forward did not process;
    dbg (rows, ch)."""
    dev = featP.device
    ts = config.tile_size
    ck = config.chunk
    n_chunks = config.tile_capacity // ck + 1
    px, py = _pixel_centres(tile_ids, tiles_x, ts)
    end = (off + counts).to(torch.int64)
    lane = torch.arange(ck, device=dev)
    zero = torch.zeros((), device=dev)

    g = g_tiles  # (rows, ch, p)
    gt = (bg_rows[:, :, None] * g).sum(dim=1)  # (rows, p)
    dbg = (g * tfin).sum(dim=2)
    tail = tfin[:, 0] * gt
    chunks = []
    for i in reversed(range(n_chunks)):
        cols = base.to(torch.int64)[:, None] * ck + i * ck + lane[None]  # (rows, ck)
        data = featP[:, cols]  # (9, rows, ck)
        j = i * ck + lane[None]
        seg = (j >= off[:, None]) & (j < end[:, None]) & (i < nproc)[:, None]
        alpha, dx, dy, gexp, unclamped = _chunk_alpha(data, px, py, seg, config)
        ca, cb, cc = (data[k][:, None, :] for k in (2, 3, 4))
        t_after = tchk[:, i, :, None] * torch.exp(running_sum(torch.log1p(-alpha)))
        alive = (t_after >= config.transmittance_min) & seg[:, None, :]
        one_m = torch.clamp(1.0 - alpha, min=1.0 - config.alpha_clamp)
        t_before = t_after / one_m
        wgt = torch.where(alive, t_before * alpha, zero)
        color = data[6 : 6 + channels].permute(1, 0, 2)  # (rows, ch, ck)
        cg = torch.einsum("rcg,rcp->rpg", color, g)
        m = wgt * cg
        # strict suffix: sum of m over the chunk's later pairs
        rev = torch.flip(running_sum(torch.flip(m, [-1])), [-1])
        suffix = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])], dim=-1)
        suffix = suffix + tail[:, :, None]
        dalpha = torch.where(alive & unclamped, t_before * cg - suffix / one_m, zero)
        dpow = alpha * dalpha
        rows_d = [
            ((ca * dx + cb * dy) * dpow).sum(dim=1),
            ((cc * dy + cb * dx) * dpow).sum(dim=1),
            (-0.5 * dx * dx * dpow).sum(dim=1),
            (-dx * dy * dpow).sum(dim=1),
            (-0.5 * dy * dy * dpow).sum(dim=1),
            (gexp * dalpha).sum(dim=1),
        ] + list(torch.einsum("rcp,rpg->crg", g, wgt))
        rows_d += [torch.zeros_like(rows_d[0])] * (N_FEAT - len(rows_d))
        chunks.append((i, torch.stack(rows_d)))
        tail = tail + m.sum(dim=-1)
    return chunks, dbg


def composite_bwd_plain(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                        g_tiles, tiles_x, channels, config: RasterizeConfig):
    """Plain PyTorch version of kernel B3 -> (dP (9, n) f32 per sorted pair
    row, zero outside every tile segment; dbg (rows, ch))."""
    ck = config.chunk
    chunks, dbg = _bwd_chunks_plain(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin,
                                    tchk, g_tiles, tiles_x, channels, config)
    lane = torch.arange(ck, device=featP.device)
    dP = torch.zeros_like(featP)
    for i, d_chunk in chunks:
        cols = base.to(torch.int64)[:, None] * ck + i * ck + lane[None]  # (rows, ck)
        # Values outside each tile's segment are exact zeros, so adding the
        # overlapping windows leaves every row with its one owner's value.
        dP.index_add_(1, cols.reshape(-1), d_chunk.reshape(N_FEAT, -1))
    return dP, dbg


def composite_bwd_blocks_plain(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                               g_tiles, tiles_x, channels, config: RasterizeConfig):
    """Plain PyTorch version of kernel B5 -> (dblk (rows, n_chunks, 9,
    chunk): block [r, i] holds the gradients of window rows
    base[r] * chunk + i * chunk + lane, exact zeros outside tile r's
    segment and in chunks the forward did not process; dbg (rows, ch))."""
    chunks, dbg = _bwd_chunks_plain(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin,
                                    tchk, g_tiles, tiles_x, channels, config)
    blocks = [d_chunk for _, d_chunk in sorted(chunks, key=lambda c: c[0])]
    return torch.stack(blocks).permute(2, 0, 1, 3).contiguous(), dbg


def bwd_sub_block() -> int:
    """Pairs per sub-block of the compositing walks (`kSub`: kernels B2, B3,
    B5 and B7)."""
    return kernels.call("pf3_composite_bwd_sub_block")


def _check_bwd_args(name, featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                    g_tiles, channels, config: RasterizeConfig):
    """Validate what kernels B3 and B5 take; -> (rows, n_chunks)."""
    dev = featP.device
    if dev.type != "cuda":
        raise ValueError("the compositing backward kernels need CUDA tensors")
    rows = base.shape[0]
    ts = config.tile_size
    p = ts * ts
    ck = config.chunk
    n_chunks = config.tile_capacity // ck + 1
    if not 1 <= channels <= 3 or p > 1024:
        raise ValueError("the compositing backward supports 1-3 channels and tiles of up "
                         "to 1024 pixels")
    if featP.dtype != torch.float32 or featP.dim() != 2 or featP.shape[0] != N_FEAT \
            or not featP.is_contiguous():
        raise ValueError("featP: want a contiguous (9, n) float32 tensor")
    if featP.shape[1] < n_chunks * ck:
        raise ValueError("featP is shorter than one tile window")
    for name_, t in (("base", base), ("off", off), ("counts", counts), ("tile_ids", tile_ids),
                     ("nproc", nproc)):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (rows,) \
                or not t.is_contiguous():
            raise ValueError(f"{name_}: want a contiguous ({rows},) int32 tensor on {dev}")
    for name_, t, shape in (("bg_rows", bg_rows, (rows, channels)),
                            ("tfin", tfin, (rows, 1, p)), ("tchk", tchk, (rows, n_chunks, p)),
                            ("g_tiles", g_tiles, (rows, channels, p))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name_}: want a contiguous {shape} float32 tensor on {dev}")
    kernels.check_smem(name, ts, ck)
    return rows, n_chunks


def heaviest_first(counts):
    """The tile rows by descending pair count, the order in which kernels
    B2, B3, B5 and B7 start them: the longest walks do not end the launch
    alone."""
    return torch.argsort(counts, descending=True, stable=True).to(torch.int32)


def _launch_bwd(name, out, featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                g_tiles, tiles_x, channels, config: RasterizeConfig, order=None):
    """Launch kernel B3 (`composite_bwd`) or B5 (`composite_bwd_blocks`):
    one C signature, `out` being dP or the block set, the tile rows started
    in `order` (default: heaviest first) -> dbg (rows, ch)."""
    dev = featP.device
    rows = base.shape[0]
    n_chunks = config.tile_capacity // config.chunk + 1
    dbg = torch.empty((rows, channels), dtype=torch.float32, device=dev)
    if order is None:
        order = heaviest_first(counts)
    kernels.launch(f"pf3_{name}", featP, featP.shape[1], base, off, counts, tile_ids, nproc,
                   order, bg_rows, tfin, tchk, g_tiles, rows, channels, tiles_x,
                   config.tile_size, config.chunk, n_chunks, config.alpha_clamp,
                   config.alpha_min, 1.0 - config.alpha_clamp, config.transmittance_min, out,
                   dbg)
    return dbg


def composite_bwd_cuda(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                       g_tiles, tiles_x, channels, config: RasterizeConfig, order=None):
    """Kernel B3 on the card (`csrc/composite_bwd.cu`)."""
    _check_bwd_args("composite_bwd", featP, base, off, counts, tile_ids, nproc, bg_rows, tfin,
                    tchk, g_tiles, channels, config)
    dP = torch.zeros((N_FEAT, featP.shape[1]), dtype=torch.float32, device=featP.device)
    dbg = _launch_bwd("composite_bwd", dP, featP, base, off, counts, tile_ids, nproc, bg_rows,
                      tfin, tchk, g_tiles, tiles_x, channels, config, order)
    return dP, dbg


def composite_bwd_blocks_cuda(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                              g_tiles, tiles_x, channels, config: RasterizeConfig):
    """Kernel B5 on the card (`csrc/composite_bwd_blocks.cu`); it writes
    every element of the block set, so that is allocated uncleared."""
    rows, n_chunks = _check_bwd_args("composite_bwd_blocks", featP, base, off, counts, tile_ids,
                                     nproc, bg_rows, tfin, tchk, g_tiles, channels, config)
    dblk = torch.empty((rows, n_chunks, N_FEAT, config.chunk), dtype=torch.float32,
                       device=featP.device)
    dbg = _launch_bwd("composite_bwd_blocks", dblk, featP, base, off, counts, tile_ids, nproc,
                      bg_rows, tfin, tchk, g_tiles, tiles_x, channels, config)
    return dblk, dbg


def composite_bwd(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                  g_tiles, tiles_x, channels, config: RasterizeConfig, order=None):
    """Kernel B3 for CUDA tensors (tile rows started in `order`), its plain
    version for CPU tensors."""
    if featP.device.type == "cpu":
        return composite_bwd_plain(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin,
                                   tchk, g_tiles, tiles_x, channels, config)
    return composite_bwd_cuda(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                              g_tiles, tiles_x, channels, config, order)


def composite_bwd_blocks(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk,
                         g_tiles, tiles_x, channels, config: RasterizeConfig):
    """Kernel B5 for CUDA tensors, its plain version for CPU tensors."""
    fn = composite_bwd_blocks_plain if featP.device.type == "cpu" else composite_bwd_blocks_cuda
    return fn(featP, base, off, counts, tile_ids, nproc, bg_rows, tfin, tchk, g_tiles,
              tiles_x, channels, config)


def merge_blocks(dblk, base, n_cols: int):
    """Kernel B5's blocks (rows, n_chunks, 9, chunk) of all tile rows ->
    dP (9, n_cols) in sorted order: block [r, i] is added to window
    base[r] + i (`streamed.py:1224-1232`).

    Adjacent tiles share a boundary window, so a window may receive several
    blocks. Each pair row has one owner, though, and every other block holds
    an exact zero there, so the sum does not depend on the order in which
    `index_add_` adds them (x + 0 = x in any order): the result is the same
    on every run and for any order of the rows."""
    rows, n_chunks, n_feat, ck = dblk.shape
    win = (base.to(torch.int64)[:, None]
           + torch.arange(n_chunks, device=base.device)[None, :]).reshape(-1)
    acc = torch.zeros((n_cols // ck, n_feat, ck), dtype=dblk.dtype, device=dblk.device)
    acc.index_add_(0, win, dblk.reshape(rows * n_chunks, n_feat, ck))
    return acc.permute(1, 0, 2).reshape(n_feat, n_cols)


def tiles_to_image(img_tiles, b, tiles_x, tiles_y, channels, ts):
    out = img_tiles.reshape(b, tiles_y, tiles_x, channels, ts, ts)
    return out.permute(0, 1, 4, 2, 5, 3).reshape(b, tiles_y * ts, tiles_x * ts, channels)


def image_to_tiles(img, tiles_x, tiles_y, ts):
    """(b, h, w, c) -> (b * tiles_y * tiles_x, c, ts * ts), zero-padded to
    the tile grid (the inverse of `tiles_to_image`)."""
    b, h, w, c = img.shape
    pad = img.new_zeros((b, tiles_y * ts, tiles_x * ts, c))
    pad[:, :h, :w] = img
    out = pad.reshape(b, tiles_y, ts, tiles_x, ts, c).permute(0, 1, 3, 5, 2, 4)
    return out.reshape(b * tiles_y * tiles_x, c, ts * ts).contiguous()


def prepare_streamed(screen: ScreenGaussians, image_shape, background, config):
    """Everything before kernel B2: pair sort and per-tile segment rows.

    Returns the keyword arguments of `composite_fwd` plus `extra`
    (tiles_y, the sorted pair ids, and the compaction counts or None)."""
    b, n = screen.depth.shape
    channels = screen.color.shape[-1]
    stats = None
    if use_compaction(config, b, n):
        featP, ids_sorted, starts, tiles_x, tiles_y, stats = pair_sort_compacted(
            screen, image_shape, config
        )
    else:
        with span("pf3.decoder.sort"):
            featP, ids_sorted, starts, tiles_x, tiles_y = pair_sort(screen, image_shape, config)
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
    ), dict(tiles_y=tiles_y, ids_sorted=ids_sorted, stats=stats)


def unsort_reduce(dP, ids_sorted, b: int, n: int, compacted: bool, config: RasterizeConfig):
    """Per-pair gradients in sorted order -> per-gaussian sums (9, b * n).

    One sort on the pair ids restores pair-id order (`streamed.py:
    1234-1247`); the first len(ids_sorted) rows are the real pairs (pad rows
    sort after them and carry zeros). Compacted: kernel B4 sums each
    gaussian's surviving rows; expanded: every gaussian owns exactly
    max_dup rows, summed by a reshape (`streamed.py:1248-1262`)."""
    total = ids_sorted.numel()
    ids_u, perm = torch.sort(ids_sorted)
    grads = dP[:, :total][:, perm].contiguous()
    if compacted:
        return dup_reduce(grads, ids_u.contiguous(), b * n, config.max_dup)
    return grads.view(N_FEAT, b * n, config.max_dup).sum(dim=-1)


def _on_shards(fn, row_args: dict, shared: dict, mesh):
    """Run `fn(**rows of the shard, **shared)` for each shard this process
    owns, on the shard's device; every row shard's outputs come back to the
    first device, concatenated in shard order (`gather_in_shard_order`).
    `row_args` are split along their first axis."""
    rows = next(iter(row_args.values())).shape[0]
    outs = {}
    for k, lo, hi, dev in shard_rows(rows, mesh):
        sliced = {name: v[lo:hi].to(dev) for name, v in row_args.items()}
        moved = {name: v.to(dev) if isinstance(v, torch.Tensor) else v
                 for name, v in shared.items()}
        outs[k] = fn(**sliced, **moved)
    return [torch.cat(parts) for parts in zip(*gather_in_shard_order(outs, mesh))]


ROW_ARGS = ("base", "off", "counts", "tile_ids", "bg_rows")


class StreamedRasterize(torch.autograd.Function):
    """The streamed pipeline's render with its hand-written backward (the
    JAX package's `custom_vjp`, `streamed.py:1094-1277`). Differentiable
    inputs: xy, conic, opacity, color, background; depth, radius and valid
    only steer binning and get no gradient. `mesh` with more than one shard:
    B2 per shard forward, B5 per shard + `merge_blocks` backward."""

    @staticmethod
    def forward(ctx, xy, conic, opacity, color, background, depth, radius, valid,
                image_shape, config, mesh=None):
        h, w = image_shape
        b, n = depth.shape
        screen = ScreenGaussians(xy=xy, depth=depth, conic=conic, radius=radius,
                                 color=color, opacity=opacity, valid=valid)
        args, extra = prepare_streamed(screen, image_shape, background, config)
        sharded = mesh is not None and mesh.size > 1
        with span("pf3.decoder.composite"):
            if sharded:
                img_tiles, tfin, tchk = _on_shards(
                    composite_fwd, {k: args[k] for k in ROW_ARGS},
                    {k: v for k, v in args.items() if k not in ROW_ARGS}, mesh)
                order = None  # each shard's kernels order its own rows
            else:
                # B2 and B3 start the tile rows in one order, heaviest first
                order = heaviest_first(args["counts"])
                img_tiles, tfin, tchk = composite_fwd(**args, order=order)
        ctx.save_for_backward(args["featP"], extra["ids_sorted"], args["base"], args["off"],
                              args["counts"], args["tile_ids"], args["bg_rows"], tfin, tchk)
        ctx.order = order
        ctx.meta = (b, n, image_shape, args["tiles_x"], extra["tiles_y"], args["channels"],
                    config, use_compaction(config, b, n), mesh if sharded else None)
        out = tiles_to_image(img_tiles, b, args["tiles_x"], extra["tiles_y"],
                             args["channels"], config.tile_size)
        return out[:, :h, :w]

    @staticmethod
    def backward(ctx, g_img):
        featP, ids_sorted, base, off, counts, tile_ids, bg_rows, tfin, tchk = ctx.saved_tensors
        b, n, _, tiles_x, tiles_y, channels, config, compacted, mesh = ctx.meta
        g_tiles = image_to_tiles(g_img.to(torch.float32), tiles_x, tiles_y, config.tile_size)
        nproc = n_processed(tchk)
        if mesh is None:
            dP, dbg = composite_bwd(featP, base, off, counts, tile_ids, nproc, bg_rows,
                                    tfin, tchk, g_tiles, tiles_x, channels, config, ctx.order)
        else:
            dblk, dbg = _on_shards(
                composite_bwd_blocks,
                dict(base=base, off=off, counts=counts, tile_ids=tile_ids, nproc=nproc,
                     bg_rows=bg_rows, tfin=tfin, tchk=tchk, g_tiles=g_tiles),
                dict(featP=featP, tiles_x=tiles_x, channels=channels, config=config), mesh)
            dP = merge_blocks(dblk, base, featP.shape[1])
        d = unsort_reduce(dP, ids_sorted, b, n, compacted, config).T.reshape(b, n, N_FEAT)
        d_bg = dbg.reshape(b, tiles_x * tiles_y, channels).sum(dim=1)
        return (d[..., 0:2], d[..., 2:5], d[..., 5], d[..., 6 : 6 + channels], d_bg,
                None, None, None, None, None, None)


def composite_streamed_batched(
    screen: ScreenGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (b, c)
    config: RasterizeConfig,
    mesh=None,
) -> torch.Tensor:
    """Streamed-pipeline rendering of a batch of cameras -> (b, h, w, c),
    differentiable in xy, conic, opacity, color and background.

    `mesh`: optional `parallel.Mesh`. With compaction on, a mesh of more
    than one shard takes the shard-local pipeline (`shard_local.py`: each
    shard compacts, sorts, composites, unsorts and reduces only its own
    tile rows, and the per-gaussian gradients are summed over the shards).
    Without compaction only the compositing kernels' rows are split; the
    pair sort and the gradient unsort stay global."""
    b, n = screen.depth.shape
    if mesh is not None and mesh.size > 1 and use_compaction(config, mesh_batch(b, mesh), n):
        from .shard_local import composite_shard_local

        return composite_shard_local(screen, image_shape, background, config, mesh)
    return StreamedRasterize.apply(
        screen.xy, screen.conic, screen.opacity, screen.color, background,
        screen.depth, screen.radius, screen.valid, tuple(image_shape), config, mesh,
    )
