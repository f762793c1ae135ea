"""Dense-table rasterizer backend (`impl="pallas"`): per-tile feature tables
composited by kernels B6 (forward) and B7 (backward).

Port of `pf3plat_tpu/ops/rasterizer/pallas_impl.py`.
`binning.bin_gaussians_batched` gives each (camera, tile)
row the ids of its first `tile_capacity` gaussians in depth order; their
features are gathered into a dense table with ordinary PyTorch indexing,
and the boundary of the hand-written backward is exactly the composite

    (table, counts, tile_ids, bg_rows) -> (img_tiles, t_final)

as a `torch.autograd.Function` (the JAX package's `jax.custom_vjp`,
`pallas_impl.py:424-445`): its backward emits d(table) and d(bg_rows), and
autograd scatters d(table) back to the gaussians through the gather.

Table layout. The kernels and their plain versions take the table in the
gather's own order, (rows, cap, F) with F = 6 + channels and slot rows
[x, y, ca, cb, cc, opacity, color...]: a chunk of a row is one contiguous
block. `RasterizeConfig.table_layout` ("f_major" / "slot_major") chooses
between two TPU memory layouts of the same numbers; the port accepts both
values and computes the same result for either.

Semantics (the JAX kernels'): a row's chunks are walked while
`i * chunk < counts[row]`, every slot of a walked chunk is composited
(slots past the count hold zeros: alpha 0), and inside a chunk a slot is
alive iff T after it is >= `transmittance_min`; after the first dead slot
the rest of the chunk is dead, and at the chunk's end T becomes the T after
the last alive slot. So T never drops below the threshold and the walk ends
only with the count: the chunk-reset semantics of the streamed kernels.
`n_chunks = tile_capacity // chunk` here (no extra window chunk).

With a `mesh` of more than one shard (`parallel.Mesh`) the table's (batch *
tile) rows split evenly over the shards and the composite runs once per
shard on its rows, on the shard's device (`pallas_impl.py:531-551`); binning,
the gather and its backward stay global. Over several processes each runs
its own shards, and the image tiles, d(table) and d(bg_rows) of the others
come from their owners (`ShardedTable`).

Dispatch: `composite_table_fwd` / `composite_table_bwd` launch the
hand-written kernels (`csrc/table_fwd.cu`, `csrc/table_bwd.cu`: B6 is the
forward walk of kernel B2 on table rows, `csrc/composite_fwd_walk.cuh`, and
B7 the backward walk of kernel B3, `csrc/composite_bwd_walk.cuh`; both take
any tile of up to 1024 pixels) for CUDA tensors and take the plain PyTorch
versions for CPU tensors.
"""

from __future__ import annotations

import torch

from ... import kernels
from ...parallel.collectives import gather_in_shard_order, shard_rows
from .binning import BinnedTiles
from .streamed import (
    _chunk_alpha,
    _pixel_centres,
    heaviest_first,
    n_processed,
    running_sum,
    tiles_to_image,
)
from .types import RasterizeConfig, ScreenGaussians

TABLE_LAYOUTS = ("f_major", "slot_major")


def _table_dims(table, config: RasterizeConfig, channels: int):
    """(rows, n_chunks, pixels) of a (rows, cap, 6 + channels) table."""
    cap, ck = config.tile_capacity, config.chunk
    if cap % ck:
        raise ValueError("tile_capacity must be divisible by chunk")
    if table.dim() != 3 or tuple(table.shape[1:]) != (cap, 6 + channels):
        raise ValueError(
            f"table: want (rows, {cap}, {6 + channels}), got {tuple(table.shape)}"
        )
    return table.shape[0], cap // ck, config.tile_size**2


def _chunk_data(table, i: int, ck: int):
    """Chunk i of every row, feature-first: (F, rows, ck)."""
    return table[:, i * ck : (i + 1) * ck, :].permute(2, 0, 1)


def composite_table_fwd_plain(table, counts, tile_ids, bg_rows, tiles_x, channels,
                              config: RasterizeConfig):
    """Plain PyTorch version of kernel B6 -> (img (rows, ch, p),
    tfin (rows, 1, p), tchk (rows, n_chunks, p))."""
    rows, n_chunks, p = _table_dims(table, config, channels)
    ck = config.chunk
    px, py = _pixel_centres(tile_ids, tiles_x, config.tile_size)
    tcar = table.new_ones((rows, p))
    accum = table.new_zeros((rows, channels, p))
    tchk = []
    for i in range(n_chunks):
        run = (i * ck < counts)[:, None]  # (rows, 1)
        tchk.append(torch.where(run, tcar, torch.zeros_like(tcar)))
        data = _chunk_data(table, i, ck)
        walked = run.expand(rows, ck)
        alpha = _chunk_alpha(data, px, py, walked, config)[0]  # (rows, p, ck)
        t_after = tcar[:, :, None] * torch.exp(running_sum(torch.log1p(-alpha)))
        alive = (t_after >= config.transmittance_min) & walked[:, None, :]
        one_m = torch.clamp(1.0 - alpha, min=1.0 - config.alpha_clamp)
        wgt = torch.where(alive, (t_after / one_m) * alpha, torch.zeros_like(alpha))
        color = data[6 : 6 + channels].permute(1, 0, 2)  # (rows, ch, ck)
        accum = accum + torch.einsum("rcg,rpg->rcp", color, wgt)
        inf = torch.full_like(t_after, float("inf"))
        t_last = torch.amin(torch.where(alive, t_after, inf), dim=-1)
        tcar = torch.where(alive.any(dim=-1), t_last, tcar)
    img = accum + bg_rows[:, :, None] * tcar[:, None, :]
    return img, tcar[:, None, :], torch.stack(tchk, dim=1)


def composite_table_bwd_plain(table, counts, tile_ids, bg_rows, tfin, tchk, g_img, g_tfin,
                              tiles_x, channels, config: RasterizeConfig):
    """Plain PyTorch version of kernel B7 -> (dtab (rows, cap, F), zero in
    every chunk that is not walked; dbg (rows, ch)). Chunk i of a row is
    walked iff `i * chunk < counts[row]` and its checkpoint is above 0
    somewhere; `g_tfin` (rows, 1, p) is the cotangent of t_final."""
    rows, n_chunks, p = _table_dims(table, config, channels)
    ck = config.chunk
    px, py = _pixel_centres(tile_ids, tiles_x, config.tile_size)
    zero = torch.zeros((), device=table.device)

    gt = (bg_rows[:, :, None] * g_img).sum(dim=1) + g_tfin[:, 0]  # (rows, p)
    dbg = (g_img * tfin).sum(dim=2)
    tail = tfin[:, 0] * gt
    dtab = torch.zeros_like(table)
    for i in reversed(range(n_chunks)):
        run = (i * ck < counts) & (tchk[:, i].amax(dim=1) > 0.0)
        walked = run[:, None].expand(rows, ck)
        data = _chunk_data(table, i, ck)
        alpha, dx, dy, gexp, unclamped = _chunk_alpha(data, px, py, walked, config)
        ca, cb, cc = (data[k][:, None, :] for k in (2, 3, 4))
        t_after = tchk[:, i, :, None] * torch.exp(running_sum(torch.log1p(-alpha)))
        alive = (t_after >= config.transmittance_min) & walked[:, None, :]
        one_m = torch.clamp(1.0 - alpha, min=1.0 - config.alpha_clamp)
        t_before = t_after / one_m
        wgt = torch.where(alive, t_before * alpha, zero)
        color = data[6 : 6 + channels].permute(1, 0, 2)  # (rows, ch, ck)
        cg = torch.einsum("rcg,rcp->rpg", color, g_img)
        m = wgt * cg
        # strict suffix: sum of m over the chunk's later slots
        rev = torch.flip(running_sum(torch.flip(m, [-1])), [-1])
        suffix = torch.cat([rev[..., 1:], torch.zeros_like(rev[..., :1])], dim=-1)
        suffix = suffix + tail[:, :, None]
        dalpha = torch.where(alive & unclamped, t_before * cg - suffix / one_m, zero)
        dpow = alpha * dalpha
        cols = [
            ((ca * dx + cb * dy) * dpow).sum(dim=1),
            ((cc * dy + cb * dx) * dpow).sum(dim=1),
            (-0.5 * dx * dx * dpow).sum(dim=1),
            (-dx * dy * dpow).sum(dim=1),
            (-0.5 * dy * dy * dpow).sum(dim=1),
            (gexp * dalpha).sum(dim=1),
        ] + list(torch.einsum("rcp,rpg->crg", g_img, wgt))
        dtab[:, i * ck : (i + 1) * ck, :] = torch.stack(cols, dim=-1)
        tail = tail + m.sum(dim=-1)
    return dtab, dbg


def _check_table_args(table, counts, tile_ids, bg_rows, channels, config, floats=()):
    """Validate what the CUDA kernels take; -> (rows, n_chunks, p)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("the table kernels need CUDA tensors")
    rows, n_chunks, p = _table_dims(table, config, channels)
    if not 1 <= channels <= 3 or p > 1024:
        raise ValueError("the table kernels support 1-3 channels and tiles of up to 1024 "
                         "pixels")
    for name, x in (("counts", counts), ("tile_ids", tile_ids)):
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != (rows,) \
                or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous ({rows},) int32 tensor on {dev}")
    for name, x, shape in (("table", table, tuple(table.shape)),
                           ("bg_rows", bg_rows, (rows, channels)), *floats):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {shape} float32 tensor on {dev}")
    return rows, n_chunks, p


def composite_table_fwd_cuda(table, counts, tile_ids, bg_rows, tiles_x, channels,
                             config: RasterizeConfig):
    """Kernel B6 on the card (`csrc/table_fwd.cu`), the rows started
    heaviest first."""
    rows, n_chunks, p = _check_table_args(table, counts, tile_ids, bg_rows, channels, config)
    kernels.check_smem("table_fwd", config.tile_size, config.chunk)
    dev = table.device
    order = heaviest_first(counts)
    img = torch.empty((rows, channels, p), dtype=torch.float32, device=dev)
    tfin = torch.empty((rows, 1, p), dtype=torch.float32, device=dev)
    tchk = torch.empty((rows, n_chunks, p), dtype=torch.float32, device=dev)
    kernels.launch("pf3_table_fwd", table, counts, tile_ids, order, bg_rows, rows, channels,
                   config.tile_capacity, tiles_x, config.tile_size, config.chunk, n_chunks,
                   config.alpha_clamp, config.alpha_min, 1.0 - config.alpha_clamp,
                   config.transmittance_min, img, tfin, tchk)
    return img, tfin, tchk


def composite_table_bwd_cuda(table, counts, tile_ids, bg_rows, tfin, tchk, g_img, g_tfin,
                             tiles_x, channels, config: RasterizeConfig):
    """Kernel B7 on the card (`csrc/table_bwd.cu`): the walked chunks are
    the first `n_processed(tchk)` of each row (B6 writes a checkpoint above 0
    for exactly the chunks with i * chunk < count), the rows started
    heaviest first."""
    rows, n_chunks, p = _table_dims(table, config, channels)
    _check_table_args(
        table, counts, tile_ids, bg_rows, channels, config,
        floats=(("tfin", tfin, (rows, 1, p)), ("tchk", tchk, (rows, n_chunks, p)),
                ("g_img", g_img, (rows, channels, p)), ("g_tfin", g_tfin, (rows, 1, p))),
    )
    kernels.check_smem("table_bwd", config.tile_size, config.chunk)
    dev = table.device
    dtab = torch.empty_like(table)
    dbg = torch.empty((rows, channels), dtype=torch.float32, device=dev)
    nproc = n_processed(tchk)
    order = heaviest_first(counts)
    kernels.launch("pf3_table_bwd", table, counts, tile_ids, nproc, order, bg_rows, tfin, tchk,
                   g_img, g_tfin, rows, channels, tiles_x, config.tile_size, config.chunk,
                   n_chunks, config.alpha_clamp, config.alpha_min, 1.0 - config.alpha_clamp,
                   config.transmittance_min, dtab, dbg)
    return dtab, dbg


def composite_table_fwd(table, counts, tile_ids, bg_rows, tiles_x, channels,
                        config: RasterizeConfig):
    """Kernel B6 for CUDA tensors, its plain version for CPU tensors."""
    fn = composite_table_fwd_plain if table.device.type == "cpu" else composite_table_fwd_cuda
    return fn(table, counts, tile_ids, bg_rows, tiles_x, channels, config)


def composite_table_bwd(table, counts, tile_ids, bg_rows, tfin, tchk, g_img, g_tfin,
                        tiles_x, channels, config: RasterizeConfig):
    """Kernel B7 for CUDA tensors, its plain version for CPU tensors."""
    fn = composite_table_bwd_plain if table.device.type == "cpu" else composite_table_bwd_cuda
    return fn(table, counts, tile_ids, bg_rows, tfin, tchk, g_img, g_tfin, tiles_x,
              channels, config)


class CompositeTable(torch.autograd.Function):
    """(table, counts, tile_ids, bg_rows) -> (img_tiles (rows, ch, p),
    t_final (rows, p)), differentiable in table and bg_rows; both outputs
    may carry a cotangent."""

    @staticmethod
    def forward(ctx, table, counts, tile_ids, bg_rows, tiles_x, channels, config):
        table = table.contiguous()
        bg_rows = bg_rows.contiguous()
        img, tfin, tchk = composite_table_fwd(
            table, counts, tile_ids, bg_rows, tiles_x, channels, config)
        ctx.save_for_backward(table, counts, tile_ids, bg_rows, tfin, tchk)
        ctx.meta = (tiles_x, channels, config)
        return img, tfin[:, 0, :]

    @staticmethod
    def backward(ctx, g_img, g_tfin):
        table, counts, tile_ids, bg_rows, tfin, tchk = ctx.saved_tensors
        tiles_x, channels, config = ctx.meta
        dtab, dbg = composite_table_bwd(
            table, counts, tile_ids, bg_rows, tfin, tchk,
            g_img.to(torch.float32).contiguous(),
            g_tfin.to(torch.float32)[:, None, :].contiguous(),
            tiles_x, channels, config)
        return dtab, None, None, dbg, None, None, None


class ShardedTable(torch.autograd.Function):
    """`CompositeTable`'s image over the row shards of a mesh: B6 forward and
    B7 backward once per shard this process owns, on the shard's rows; the
    image tiles (forward) and d(table), d(bg_rows) (backward) of every row
    shard are concatenated in shard order (`gather_in_shard_order`)."""

    @staticmethod
    def forward(ctx, table, counts, tile_ids, bg_rows, tiles_x, channels, config, mesh):
        shards = shard_rows(table.shape[0], mesh)
        saved, imgs = [], {}
        for k, lo, hi, dev in shards:
            piece = [x[lo:hi].to(dev).contiguous() for x in (table, counts, tile_ids, bg_rows)]
            img, tfin, tchk = composite_table_fwd(*piece, tiles_x, channels, config)
            saved += [*piece, tfin, tchk]
            imgs[k] = [img]
        ctx.save_for_backward(*saved)
        ctx.meta = (tiles_x, channels, config, shards, mesh)
        return torch.cat([img for img, in gather_in_shard_order(imgs, mesh)])

    @staticmethod
    def backward(ctx, g_img):
        tiles_x, channels, config, shards, mesh = ctx.meta
        grads = {}
        for i, (k, lo, hi, dev) in enumerate(shards):
            table, counts, tile_ids, bg_rows, tfin, tchk = ctx.saved_tensors[6 * i:6 * i + 6]
            grads[k] = composite_table_bwd(
                table, counts, tile_ids, bg_rows, tfin, tchk,
                g_img[lo:hi].to(dev, torch.float32).contiguous(), torch.zeros_like(tfin),
                tiles_x, channels, config)
        dtab, dbg = (torch.cat(parts) for parts in zip(*gather_in_shard_order(grads, mesh)))
        return dtab, None, None, dbg, None, None, None, None


def prepare_tables(screen: ScreenGaussians, binned: BinnedTiles, background,
                   config: RasterizeConfig) -> dict:
    """Everything before kernel B6: the dense feature tables of a batch of
    cameras -> the keyword arguments of `composite_table_fwd`."""
    if config.table_layout not in TABLE_LAYOUTS:
        raise ValueError(
            f"unknown table_layout {config.table_layout!r}; expected 'f_major' or 'slot_major'"
        )
    tiles_x, tiles_y = binned.num_tiles_x, binned.num_tiles_y
    num_tiles = tiles_x * tiles_y
    channels = screen.color.shape[-1]
    b, n = screen.depth.shape
    dev = screen.xy.device

    # slot rows [x, y, ca, cb, cc, op, color...]. Culled gaussians never
    # enter a table but may carry inf/NaN from the projection: zero them, so
    # the gather's backward meets no inf * 0.
    feat = torch.cat(
        [screen.xy, screen.conic, screen.opacity[..., None], screen.color], dim=-1
    ).to(torch.float32)
    visible = (screen.valid & (screen.radius > 0))[..., None]
    feat = torch.where(visible, feat, torch.zeros_like(feat))
    # Flat row gather. Invalid slots are zeroed afterwards (alpha 0, and no
    # gradient leaks through the gather), so the row they read is free: each
    # reads a different one, because the gather's backward
    # (`index_put_(accumulate=True)`) adds the rows of one index one after
    # another, and hundreds of thousands of empty slots on one gaussian would
    # serialise it.
    b_off = (torch.arange(b, device=dev) * n)[:, None, None]
    slot_valid = binned.indices >= 0
    spread = torch.arange(slot_valid.numel(), device=dev).reshape(slot_valid.shape) % (b * n)
    flat_idx = torch.where(slot_valid, binned.indices + b_off, spread).reshape(-1)
    gathered = feat.reshape(b * n, -1)[flat_idx].reshape(b * num_tiles, -1, 6 + channels)
    table = torch.where(slot_valid.reshape(b * num_tiles, -1, 1), gathered,
                        torch.zeros_like(gathered))
    return dict(
        table=table,
        counts=binned.counts.reshape(-1).to(torch.int32).contiguous(),
        tile_ids=torch.arange(num_tiles, dtype=torch.int32, device=dev).repeat(b),
        bg_rows=torch.repeat_interleave(background.to(torch.float32), num_tiles, dim=0),
        tiles_x=tiles_x, channels=channels, config=config,
    )


def composite_tiles_pallas_batched(
    screen: ScreenGaussians,
    binned: BinnedTiles,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (b, c)
    config: RasterizeConfig,
    mesh=None,
) -> torch.Tensor:
    """Dense-table compositing of a batch of cameras -> (b, h, w, c); the
    batch is folded into the tile rows (rows = b * tiles). With a `mesh` of
    more than one shard the rows are split over all its axes and each shard
    composites its own (kernels B6 / B7 per shard)."""
    h, w = image_shape
    args = prepare_tables(screen, binned, background, config)
    row_args = (args["table"], args["counts"], args["tile_ids"], args["bg_rows"])
    if mesh is not None and mesh.size > 1:
        img_tiles = ShardedTable.apply(*row_args, args["tiles_x"], args["channels"], config,
                                       mesh)
    else:
        img_tiles, _ = CompositeTable.apply(*row_args, args["tiles_x"], args["channels"],
                                            config)
    out = tiles_to_image(img_tiles, screen.depth.shape[0], binned.num_tiles_x,
                         binned.num_tiles_y, args["channels"], config.tile_size)
    return out[:, :h, :w]


def composite_tiles_pallas(
    screen: ScreenGaussians,
    binned: BinnedTiles,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (c,)
    config: RasterizeConfig,
) -> torch.Tensor:
    """Single-camera dense-table compositing -> (h, w, c)."""
    return composite_tiles_pallas_batched(
        ScreenGaussians(*(f[None] for f in screen)),
        BinnedTiles(binned.indices[None], binned.counts[None],
                    binned.num_tiles_x, binned.num_tiles_y),
        image_shape, background[None], config,
    )[0]
