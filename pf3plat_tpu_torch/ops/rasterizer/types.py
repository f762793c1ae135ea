"""Shared types of the Gaussian-splatting rasterizer.

Port of `pf3plat_tpu/ops/rasterizer/types.py`: `RasterizeConfig` keeps every
field of the JAX config with the same defaults, so one configuration means
the same thing in both packages. Several fields steer TPU mechanisms only
(`table_layout`, `tiles_per_step`, `prefetch_depth`, `chunks_per_iter`,
`shard_budget_slack`); the port accepts and ignores them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_size: int = 16
    max_tiles_per_gaussian_side: int = 2
    tile_capacity: int = 1024
    chunk: int = 128
    fused_sort_key: bool = True
    tight_cull: bool = True
    table_layout: str = "f_major"
    pairs_budget_factor: float = 0.0
    compact_window: int = 4096
    shard_budget_slack: float = 1.35
    tiles_per_step: int = 4
    prefetch_depth: int = 4
    chunks_per_iter: int = 1
    compact_min_pairs: int = 131072
    near_cull: float = 0.2
    dilation: float = 0.3
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4
    sigma_radius: float = 3.0

    @property
    def max_dup(self) -> int:
        return self.max_tiles_per_gaussian_side**2


class Camera(NamedTuple):
    """Per-view camera data, pixel units; fields share leading dims."""

    w2c: torch.Tensor        # (..., 4, 4) world-to-camera
    campos: torch.Tensor     # (..., 3)
    fx: torch.Tensor         # (...,) pixels
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    tan_fov_x: torch.Tensor
    tan_fov_y: torch.Tensor


class ScreenGaussians(NamedTuple):
    """Per-gaussian screen-space quantities after projection."""

    xy: torch.Tensor       # (..., n, 2) pixel coords
    depth: torch.Tensor    # (..., n) camera-space z
    conic: torch.Tensor    # (..., n, 3) upper-tri inverse 2D covariance
    radius: torch.Tensor   # (..., n) pixel radius (0 => culled)
    color: torch.Tensor    # (..., n, channels)
    opacity: torch.Tensor  # (..., n)
    valid: torch.Tensor    # (..., n) bool
