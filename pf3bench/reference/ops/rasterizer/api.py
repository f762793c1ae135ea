"""The reference's render: the port's `ops/rasterizer/api.py:render` with
its `streamed` backend in plain PyTorch (a frozen copy)."""

from __future__ import annotations

import math

import torch

from .project import make_camera, project_gaussians
from .streamed import composite_streamed_batched
from .types import RasterizeConfig


def render(
    extrinsics: torch.Tensor,   # (b, 4, 4) c2w
    intrinsics: torch.Tensor,   # (b, 3, 3) normalized
    near: torch.Tensor,         # (b,)
    far: torch.Tensor,          # (b,)
    image_shape: tuple[int, int],
    background: torch.Tensor,   # (b, c)
    means: torch.Tensor,        # (b, n, 3)
    covariances: torch.Tensor,  # (b, n, 3, 3)
    sh: torch.Tensor,           # (b, n, c, d_sh)
    opacities: torch.Tensor,    # (b, n)
    config: RasterizeConfig,
) -> torch.Tensor:
    """Render each batch element's gaussians into its camera -> (b, h, w, c),
    scale-invariant (the world scaled so that near == 1)."""
    scale = 1.0 / near
    extrinsics = extrinsics.clone()
    extrinsics[..., :3, 3] = extrinsics[..., :3, 3] * scale[:, None]
    covariances = covariances * (scale[:, None, None, None] ** 2)
    means = means * scale[:, None, None]
    sh_degree = int(math.isqrt(sh.shape[-1])) - 1
    camera = make_camera(extrinsics, intrinsics, image_shape)
    screen = project_gaussians(camera, means, covariances, opacities, sh, sh_degree, config)
    return composite_streamed_batched(screen, image_shape, background, config)
