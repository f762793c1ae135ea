"""Alpha-compositing math shared by the brute-force oracle and the `tiled`
backend (plain PyTorch).

Port of `pf3plat_tpu/ops/rasterizer/compositing.py`. Front-to-back
compositing without a per-gaussian loop: with s_i = log(1 - alpha_i) the
transmittance before gaussian i is T_in * exp(sum_{j<i} s_j), so one
cumulative sum along the depth-sorted axis gives every weight at once. A
gaussian that would push T below `transmittance_min` is skipped together
with everything behind it (the CUDA 3DGS early exit), as a mask on the
inclusive cumulative transmittance.
"""

from __future__ import annotations

import torch

from .types import RasterizeConfig


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
