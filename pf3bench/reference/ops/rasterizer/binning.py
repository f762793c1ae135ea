"""Tile binning (plain PyTorch): tile AABB, opacity-aware tight cull, depth
sort keys, the (tile, depth, id) sort, and the dense per-tile index tables.

Port of `pf3plat_tpu/ops/rasterizer/binning.py`. The streamed pipeline uses
the bounds, the cull, the keys and the sort; the binned backends (`tiled`,
`pallas`) use `bin_gaussians_batched` on top of them: every gaussian expands
into `max_dup` candidate pairs (no compaction), the batch is folded into the
tile key, one sort orders the pairs by (tile, depth, gaussian id), and each
tile's first `tile_capacity` gaussians go into a dense (b, tiles, cap) index
table padded with -1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .types import RasterizeConfig, ScreenGaussians

INT32_MAX = 2**31 - 1


class TileBounds(NamedTuple):
    tx0: torch.Tensor
    ty0: torch.Tensor
    tw: torch.Tensor  # tiles covered horizontally (possibly clamped)
    th: torch.Tensor


def tile_bounds(
    screen: ScreenGaussians, image_shape: tuple[int, int], config: RasterizeConfig
) -> TileBounds:
    """Clamped tile AABB of each gaussian's radius footprint."""
    h, w = image_shape
    ts = config.tile_size
    tiles_x = -(-w // ts)
    tiles_y = -(-h // ts)
    side = config.max_tiles_per_gaussian_side

    x, y = screen.xy[..., 0], screen.xy[..., 1]
    r = screen.radius

    def tile_of(v, hi):
        return torch.clamp(torch.floor(v / ts), 0, hi - 1).to(torch.int32)

    tx0 = tile_of(x - r, tiles_x)
    ty0 = tile_of(y - r, tiles_y)
    tx1 = tile_of(x + r, tiles_x)
    ty1 = tile_of(y + r, tiles_y)
    tw = torch.clamp(tx1 - tx0 + 1, max=side)
    th = torch.clamp(ty1 - ty0 + 1, max=side)
    visible = screen.valid & (screen.radius > 0)
    tw = torch.where(visible, tw, torch.zeros_like(tw))
    th = torch.where(visible, th, torch.zeros_like(th))
    return TileBounds(tx0, ty0, tw, th)


def tile_alpha_cull(mu_x, mu_y, ca, cb, cc, opacity, tx, ty, config: RasterizeConfig):
    """Keep mask for candidate (gaussian, tile) pairs: drop pairs whose
    conservative best-case alpha over the tile's pixel centers misses
    `alpha_min` (exact minimum of the PD quadratic over the rectangle,
    relaxed so the cull stays strictly conservative). Arguments broadcast
    over the candidate layout; `tx`/`ty` are integer tile coords."""
    ts = config.tile_size
    f = torch.float32
    rx0 = tx.to(f) * ts + 0.5
    ry0 = ty.to(f) * ts + 0.5
    dxl = rx0 - mu_x
    dxh = rx0 + (ts - 1.0) - mu_x
    dyl = ry0 - mu_y
    dyh = ry0 + (ts - 1.0) - mu_y
    inside = (dxl <= 0) & (dxh >= 0) & (dyl <= 0) & (dyh >= 0)

    ca_s = torch.clamp(ca, min=1e-12)
    cc_s = torch.clamp(cc, min=1e-12)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def edge_x(a):
        d = torch.minimum(torch.maximum(-cb * a / cc_s, dyl), dyh)
        return q(a, d)

    def edge_y(b_):
        d = torch.minimum(torch.maximum(-cb * b_ / ca_s, dxl), dxh)
        return q(d, b_)

    q_edge = torch.minimum(
        torch.minimum(edge_x(dxl), edge_x(dxh)),
        torch.minimum(edge_y(dyl), edge_y(dyh)),
    )
    q_min = torch.where(inside, torch.zeros_like(q_edge), q_edge)
    q_relaxed = torch.clamp(q_min * (1.0 - 1e-4) - 1e-5, min=0.0)
    return opacity * torch.exp(-q_relaxed) >= config.alpha_min


def depth_sort_key(depth: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Monotone int32 sort key from positive float32 depths."""
    bits = depth.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(
        valid & (depth > 0), bits, torch.full_like(bits, INT32_MAX)
    )


def fused_bits(total_tiles: int) -> int:
    """Depth bits left in the int32 fused key beside the tile bits."""
    return 31 - max(1, total_tiles - 1).bit_length() - 1


def depth_levels(depth, visible, bits_d: int) -> torch.Tensor:
    """Range-normalized quantized depth in [0, 2^bits_d), in float32
    exactly as the JAX fused key computes it. The clamp after the integer
    cast matters once bits_d > 24: the level count rounds up in float32, so
    the product can reach 2^bits_d at the largest depth."""
    dvalid = visible & (depth > 0)
    inf = torch.tensor(float("inf"), dtype=depth.dtype, device=depth.device)
    dmin = torch.amin(torch.where(dvalid, depth, inf))
    dmax = torch.amax(torch.where(dvalid, depth, -inf))
    levels = torch.tensor(float((1 << bits_d) - 1), dtype=torch.float32)
    span = torch.clamp(dmax - dmin, min=1e-12)
    dq = torch.clamp((depth - dmin) / span, 0.0, 1.0) * levels.to(depth.device)
    return torch.clamp(dq.to(torch.int32), max=(1 << bits_d) - 1)


def sort_by_tile_depth(tile, dkey, ids, bits_d):
    """Order rows by (tile, depth key, id) -> (tile_sorted, perm).

    `bits_d` given: one int64 sort on `(tile << bits_d | dkey) << 32 | id`
    (the JAX fused int32 key with the ids as second key; rows of tile
    INT32_MAX keep that key and sort last). `bits_d` None: the exact 3-key
    order by stable sorts, least key first. Ties in (tile, depth) keep id
    order either way."""
    if bits_d is not None:
        max_t = torch.full_like(tile, INT32_MAX)
        fused = torch.where(tile == INT32_MAX, max_t, (tile << bits_d) | dkey)
        key = (fused.to(torch.int64) << 32) | ids.to(torch.int64)
        key_sorted, perm = torch.sort(key)
        fused_sorted = (key_sorted >> 32).to(torch.int32)
        tile_sorted = torch.where(
            fused_sorted == INT32_MAX, torch.full_like(fused_sorted, INT32_MAX),
            fused_sorted >> bits_d,
        )
        return tile_sorted, perm
    perm = torch.argsort(ids, stable=True)
    perm = perm[torch.argsort(dkey[perm], stable=True)]
    perm = perm[torch.argsort(tile[perm], stable=True)]
    return tile[perm], perm


class BinnedTiles(NamedTuple):
    indices: torch.Tensor  # (..., num_tiles, capacity) int32 gaussian ids, -1 padded
    counts: torch.Tensor   # (..., num_tiles) int32
    num_tiles_x: int
    num_tiles_y: int


def bin_gaussians(
    screen: ScreenGaussians, image_shape: tuple[int, int], config: RasterizeConfig
) -> BinnedTiles:
    """Bin one camera's gaussians ((n,)-shaped screen fields)."""
    out = bin_gaussians_batched(
        ScreenGaussians(*(f[None] for f in screen)), image_shape, config
    )
    return BinnedTiles(out.indices[0], out.counts[0], out.num_tiles_x, out.num_tiles_y)


def bin_gaussians_batched(
    screen: ScreenGaussians, image_shape: tuple[int, int], config: RasterizeConfig
) -> BinnedTiles:
    """Bin a batch of cameras' gaussians ((b, n, ...) screen fields) ->
    (b, tiles, cap) indices and (b, tiles) counts = min(segment, cap)."""
    h, w = image_shape
    ts = config.tile_size
    tiles_x = -(-w // ts)
    tiles_y = -(-h // ts)
    num_tiles = tiles_x * tiles_y
    b, n = screen.depth.shape
    side = config.max_tiles_per_gaussian_side
    max_dup = config.max_dup
    cap = config.tile_capacity
    total_pairs = b * n * max_dup
    total_tiles = b * num_tiles
    if total_tiles * 2 >= 2**31:
        raise ValueError("too many tiles for the int32 tile key")
    dev = screen.xy.device

    bounds = tile_bounds(screen, image_shape, config)
    visible = (bounds.tw > 0) & (bounds.th > 0)

    # gaussian-major (b, n, max_dup) candidate layout, flattened
    slot = torch.arange(max_dup, dtype=torch.int32, device=dev)
    dy = slot // side
    dx = slot % side
    in_box = (dy < bounds.th[..., None]) & (dx < bounds.tw[..., None])
    if config.tight_cull:
        in_box &= tile_alpha_cull(
            screen.xy[..., 0:1], screen.xy[..., 1:2],
            screen.conic[..., 0:1], screen.conic[..., 1:2],
            screen.conic[..., 2:3], screen.opacity[..., None],
            bounds.tx0[..., None] + dx, bounds.ty0[..., None] + dy,
            config,
        )
    tile = (bounds.ty0[..., None] + dy) * tiles_x + (bounds.tx0[..., None] + dx)
    b_off = (torch.arange(b, dtype=torch.int32, device=dev) * num_tiles)[:, None, None]
    tile_key = torch.where(
        in_box, (tile + b_off).to(torch.int32), torch.full_like(tile, INT32_MAX)
    ).reshape(total_pairs)

    def pairify(x):
        return x[..., None].expand(b, n, max_dup).reshape(total_pairs)

    ids = pairify(torch.arange(n, dtype=torch.int32, device=dev)[None, :])
    if config.fused_sort_key:
        bits_d = fused_bits(total_tiles)
        dkey = pairify(depth_levels(screen.depth, visible, bits_d))
    else:
        bits_d = None
        dkey = pairify(depth_sort_key(screen.depth, visible))
    tile_sorted, perm = sort_by_tile_depth(tile_key, dkey, ids, bits_d)
    ids_sorted = ids[perm]

    # First row of each tile's segment; a target past every key lands on
    # total_pairs, so the last tile's segment ends with the array.
    starts = torch.searchsorted(
        tile_sorted, torch.arange(total_tiles + 1, dtype=torch.int32, device=dev)
    )
    counts = torch.clamp(starts[1:] - starts[:-1], max=cap)
    k = torch.arange(cap, device=dev)
    pair_pos = torch.clamp(starts[:-1, None] + k[None, :], max=total_pairs - 1)
    in_seg = k[None, :] < counts[:, None]
    gathered = ids_sorted[pair_pos]
    indices = torch.where(in_seg, gathered, torch.full_like(gathered, -1))
    return BinnedTiles(
        indices=indices.reshape(b, num_tiles, cap),
        counts=counts.reshape(b, num_tiles).to(torch.int32),
        num_tiles_x=tiles_x,
        num_tiles_y=tiles_y,
    )
