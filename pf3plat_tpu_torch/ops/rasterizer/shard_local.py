"""Shard-local streamed rasterizer: the whole reorder pipeline per shard.

Port of `pf3plat_tpu/ops/rasterizer/shard_local.py`, the mesh path of the
streamed pipeline with pair compaction on:

  * each mesh shard owns a contiguous range of rows / S flat tile rows
    ([k * rps, (k + 1) * rps) of the batch*tile key space);
  * the candidate stream is compacted per shard with the ownership range
    as an extra validity mask (kernel B1) into a per-shard budget of about
    budget / S rows (`shard_pairs_budget`);
  * the pair sort, the segment search, the forward composite (kernel B2),
    the backward composite (kernel B3: a shard only ever touches its own
    gradient plane), the gradient unsort and the per-gaussian reduce
    (kernel B4) all run on the shard's own arrays, on the shard's device;
  * the backward's only merge is the sum over shards of the per-gaussian
    partial sums (9 * b*n floats) and of the small background gradient,
    taken on the first device in shard order (the JAX package's `psum`);
    over several processes each runs only its own shards, and the image
    tiles and partial sums of its tile group's other shards come from their
    owners before the merge (`parallel.collectives.gather_in_shard_order`).

A shard's tiles see the same pairs in the same order as the single-device
pipeline; only each tile's chunk alignment differs (segment starts are
offsets into the shard's own sorted array), which regroups the per-chunk
transmittance product: images and gradients match the single-device path
to float32 rounding wherever no budget overflows.
"""

from __future__ import annotations

import torch

from ...parallel.collectives import gather_in_shard_order, mesh_batch, shard_rows
from ...utils.profiling import span
from .compact import N_FEAT
from .streamed import (
    composite_bwd,
    composite_fwd,
    image_to_tiles,
    n_processed,
    pair_sort_compacted,
    segment_rows,
    tiles_to_image,
    unsort_reduce,
)
from .types import RasterizeConfig, ScreenGaussians

N_SAVED = 9  # tensors kept per shard for the backward


def shard_pairs_budget(config: RasterizeConfig, b: int, n: int, n_shards: int) -> int:
    """Static per-shard compacted-pair budget: the global fraction split
    over shards with `shard_budget_slack` headroom for tile-load imbalance,
    floored at one full tile window (plus the staged-block slack the
    compaction needs), capped at the always-exact bound."""
    total = b * n * config.max_dup
    cx = config.compact_window + 128
    q = max(128, config.chunk)

    def up(x):
        return -(-x // q) * q

    n_chunks = config.tile_capacity // config.chunk + 1
    floor = up(max(cx + 128, n_chunks * config.chunk + cx))
    want = up(
        int(total * config.pairs_budget_factor * config.shard_budget_slack / n_shards) + cx
    )
    return max(floor, min(want, up(total + cx)))


class ShardLocalRasterize(torch.autograd.Function):
    """The shard-local render with its hand-written backward (the JAX
    package's `custom_vjp`, `shard_local.py:234-281`); same differentiable
    inputs as `streamed.StreamedRasterize`."""

    @staticmethod
    def forward(ctx, xy, conic, opacity, color, background, depth, radius, valid,
                image_shape, config, mesh):
        h, w = image_shape
        ts = config.tile_size
        tiles_x, tiles_y = -(-w // ts), -(-h // ts)
        num_tiles = tiles_x * tiles_y
        b, n = depth.shape
        channels = color.shape[-1]
        rows = b * num_tiles
        shards = shard_rows(rows, mesh)
        # sized for the whole mesh, as every shard of the one-process mesh is
        budget_s = shard_pairs_budget(config, mesh_batch(b, mesh), n, mesh.size)
        home = mesh.home
        screen = ScreenGaussians(xy=xy, depth=depth, conic=conic, radius=radius,
                                 color=color, opacity=opacity, valid=valid)
        tile_ids_full = torch.arange(num_tiles, dtype=torch.int32, device=home).repeat(b)
        bg_rows_full = torch.repeat_interleave(background.to(torch.float32), num_tiles, dim=0)

        saved, tiles = [], {}
        for k, lo, hi, dev in shards:
            scr = ScreenGaussians(*(f.to(dev) for f in screen))
            featP, ids_sorted, starts, _, _, _ = pair_sort_compacted(
                scr, image_shape, config, tile_lo=lo, n_tiles_out=hi - lo,
                budget_override=budget_s)
            base, off, counts = segment_rows(starts, budget_s, config)
            tile_ids = tile_ids_full[lo:hi].to(dev)
            bg_rows = bg_rows_full[lo:hi].to(dev).contiguous()
            with span("pf3.decoder.composite"):
                img_tiles, tfin, tchk = composite_fwd(featP, base, off, counts, tile_ids,
                                                      bg_rows, tiles_x, channels, config)
            saved += [featP, ids_sorted, base, off, counts, tile_ids, bg_rows, tfin, tchk]
            tiles[k] = [img_tiles]
        ctx.save_for_backward(*saved)
        ctx.meta = (b, n, tiles_x, tiles_y, channels, config, shards, mesh)
        img_tiles = torch.cat([t for t, in gather_in_shard_order(tiles, mesh)])
        out = tiles_to_image(img_tiles, b, tiles_x, tiles_y, channels, ts)
        return out[:, :h, :w]

    @staticmethod
    def backward(ctx, g_img):
        b, n, tiles_x, tiles_y, channels, config, shards, mesh = ctx.meta
        g_tiles = image_to_tiles(g_img.to(torch.float32), tiles_x, tiles_y, config.tile_size)
        parts = {}
        for i, (k, lo, hi, dev) in enumerate(shards):
            featP, ids_sorted, base, off, counts, tile_ids, bg_rows, tfin, tchk = \
                ctx.saved_tensors[i * N_SAVED:(i + 1) * N_SAVED]
            dP, dbg = composite_bwd(featP, base, off, counts, tile_ids, n_processed(tchk),
                                    bg_rows, tfin, tchk, g_tiles[lo:hi].to(dev), tiles_x,
                                    channels, config)
            # Partial per-gaussian sums: a gaussian's <= max_dup pairs may
            # lie in several shards.
            parts[k] = [unsort_reduce(dP, ids_sorted, b, n, True, config), dbg]
        gathered = gather_in_shard_order(parts, mesh)
        d = gathered[0][0]
        for part, _ in gathered[1:]:  # summed in shard order
            d = d + part
        d = d.T.reshape(b, n, N_FEAT)
        d_bg = torch.cat([dbg for _, dbg in gathered]).reshape(
            b, tiles_x * tiles_y, channels).sum(dim=1)
        return (d[..., 0:2], d[..., 2:5], d[..., 5], d[..., 6 : 6 + channels], d_bg,
                None, None, None, None, None, None)


def composite_shard_local(
    screen: ScreenGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (b, c)
    config: RasterizeConfig,
    mesh,
) -> torch.Tensor:
    """Shard-local streamed rendering -> (b, h, w, c). Requires compaction
    on (`streamed.use_compaction`); `composite_streamed_batched` dispatches
    here for meshes of more than one shard."""
    return ShardLocalRasterize.apply(
        screen.xy, screen.conic, screen.opacity, screen.color, background,
        screen.depth, screen.radius, screen.valid, tuple(image_shape), config, mesh,
    )
