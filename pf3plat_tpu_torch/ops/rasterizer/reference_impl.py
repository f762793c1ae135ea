"""Brute-force O(pixels x gaussians) rasterizer: the correctness oracle.

Port of `pf3plat_tpu/ops/rasterizer/reference_impl.py`.
Composites every gaussian into every pixel after one global depth sort
and STOPS for good at the first gaussian that would push a pixel's
transmittance below `transmittance_min` (the CUDA 3DGS rule). The streamed
pipeline instead resets at each 128-row chunk boundary (see streamed.py),
so the two differ on saturated tiles; tests and tiny scenes only.
"""

from __future__ import annotations

import torch

from .binning import tile_bounds
from .compositing import composite_chunk, gaussian_alpha
from .types import RasterizeConfig, ScreenGaussians


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
