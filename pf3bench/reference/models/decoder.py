"""Splatting decoder of the reference: Gaussians + target cameras ->
rendered colors (a frozen copy of the port's `models/decoder.py`, color
only, through the plain streamed render)."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.rasterizer import RasterizeConfig, render
from .types import DecoderOutput, Gaussians

# The production rasterizer config: streamed pipeline with pair compaction
# at a 0.48 budget factor (tight cull on).
PRODUCTION_CONFIG = RasterizeConfig(pairs_budget_factor=0.48)


@dataclasses.dataclass(frozen=True)
class DecoderCfg:
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    impl: str = "streamed"
    raster: RasterizeConfig = PRODUCTION_CONFIG


def decode(
    cfg: DecoderCfg,
    gaussians: Gaussians,
    extrinsics: torch.Tensor,  # (b, v, 4, 4) c2w
    intrinsics: torch.Tensor,  # (b, v, 3, 3) normalized
    near: torch.Tensor,        # (b, v)
    far: torch.Tensor,         # (b, v)
    image_shape: tuple[int, int],
) -> DecoderOutput:
    b, v = extrinsics.shape[:2]

    def flat(x):
        return x.reshape(b * v, *x.shape[2:])

    def rep(x):
        return torch.repeat_interleave(x, v, dim=0)

    bg = torch.tensor(cfg.background_color, dtype=extrinsics.dtype, device=extrinsics.device)
    color = render(
        flat(extrinsics), flat(intrinsics), flat(near), flat(far), image_shape,
        bg.expand(b * v, 3), rep(gaussians.means), rep(gaussians.covariances),
        rep(gaussians.harmonics), rep(gaussians.opacities), cfg.raster,
    )
    h, w = image_shape
    return DecoderOutput(color=color.reshape(b, v, h, w, 3), depth=None)
