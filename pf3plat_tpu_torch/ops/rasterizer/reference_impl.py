"""Brute-force O(pixels x gaussians) rasterizer: the correctness oracle.

Port of `pf3plat_tpu/ops/rasterizer/{compositing,reference_impl}.py`.
Composites every gaussian into every pixel after one global depth sort
and STOPS for good at the first gaussian that would push a pixel's
transmittance below `transmittance_min` (the CUDA 3DGS rule). The streamed
pipeline instead resets at each 128-row chunk boundary (see streamed.py),
so the two differ on saturated tiles; tests and tiny scenes only.
"""

from __future__ import annotations

import torch

from .binning import tile_bounds
from .types import RasterizeConfig, ScreenGaussians


def gaussian_alpha(px, py, xy, conic, opacity, valid, config: RasterizeConfig):
    """Per (pixel, gaussian) alpha (..., p, g) with the 0.99 clamp and
    1/255 cutoff."""
    dx = px[..., :, None] - xy[..., None, :, 0]
    dy = py[..., :, None] - xy[..., None, :, 1]
    ca = conic[..., None, :, 0]
    cb = conic[..., None, :, 1]
    cc = conic[..., None, :, 2]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = opacity[..., None, :] * torch.exp(torch.clamp(power, max=0.0))
    alpha = torch.clamp(alpha, max=config.alpha_clamp)
    keep = valid[..., None, :] & (power <= 0.0) & (alpha >= config.alpha_min)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def composite_chunk(alpha, color, t_carry, accum, config: RasterizeConfig):
    """Composite one depth-ordered block of gaussians into all pixels."""
    s = torch.log1p(-alpha)
    incl = torch.cumsum(s, dim=-1)
    t_after = t_carry[..., None] * torch.exp(incl)
    alive = t_after >= config.transmittance_min
    t_before = t_carry[..., None] * torch.exp(incl - s)
    weight = torch.where(alive, t_before * alpha, torch.zeros_like(alpha))
    accum = accum + torch.einsum("...pg,...gc->...pc", weight, color)
    t_carry = t_carry * torch.exp(
        torch.sum(torch.where(alive, s, torch.zeros_like(s)), dim=-1)
    )
    return t_carry, accum


def composite_bruteforce(
    screen: ScreenGaussians,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (c,)
    config: RasterizeConfig,
) -> torch.Tensor:
    """Single-camera compositing of (n,)-shaped ScreenGaussians -> (h, w, c)."""
    h, w = image_shape
    dev = screen.xy.device
    channels = screen.color.shape[-1]
    inf = torch.full_like(screen.depth, float("inf"))
    order = torch.argsort(torch.where(screen.valid, screen.depth, inf), stable=True)
    xy = screen.xy[order]
    conic = screen.conic[order]
    color = screen.color[order]
    opacity = screen.opacity[order]
    valid = screen.valid[order] & (screen.radius[order] > 0)

    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    px = (xs.reshape(-1) + 0.5).to(screen.xy.dtype)
    py = (ys.reshape(-1) + 0.5).to(screen.xy.dtype)
    alpha = gaussian_alpha(px, py, xy, conic, opacity, valid, config)

    bounds = tile_bounds(screen, image_shape, config)
    tx0, ty0 = bounds.tx0[order], bounds.ty0[order]
    tw, th = bounds.tw[order], bounds.th[order]
    ptx = (xs.reshape(-1) // config.tile_size).to(torch.int32)
    pty = (ys.reshape(-1) // config.tile_size).to(torch.int32)
    in_tile = (
        (ptx[:, None] >= tx0[None, :])
        & (ptx[:, None] < tx0[None, :] + tw[None, :])
        & (pty[:, None] >= ty0[None, :])
        & (pty[:, None] < ty0[None, :] + th[None, :])
    )
    alpha = torch.where(in_tile, alpha, torch.zeros_like(alpha))

    t0 = torch.ones((h * w,), dtype=screen.xy.dtype, device=dev)
    accum0 = torch.zeros((h * w, channels), dtype=screen.xy.dtype, device=dev)
    t, accum = composite_chunk(alpha, color, t0, accum0, config)
    out = accum + t[:, None] * background[None, :]
    return out.reshape(h, w, channels)
