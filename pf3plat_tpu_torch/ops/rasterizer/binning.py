"""Tile AABB, opacity-aware tight cull and depth sort key (plain PyTorch).

Port of the parts of `pf3plat_tpu/ops/rasterizer/binning.py` that the
streamed pipeline uses.
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
