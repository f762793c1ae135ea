"""Splatting decoder: Gaussians + target cameras -> rendered views.

Port of `pf3plat_tpu/models/decoder.py` (color only; depth rendering is not
ported in this slice).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.rasterizer import RasterizeConfig, render
from .types import DecoderOutput, Gaussians

# The JAX package's production rasterizer config: streamed pipeline with
# pair compaction at a 0.48 budget factor (tight cull on).
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
    depth_mode=None,
) -> DecoderOutput:
    if depth_mode is not None:
        raise NotImplementedError("depth rendering is not ported yet")
    b, v = extrinsics.shape[:2]
    dev = extrinsics.device

    def flat(x):
        return x.reshape(b * v, *x.shape[2:])

    def rep(x):
        return torch.repeat_interleave(x, v, dim=0)

    bg = torch.tensor(cfg.background_color, dtype=extrinsics.dtype, device=dev)
    bg = bg.expand(b * v, 3)
    color = render(
        flat(extrinsics), flat(intrinsics), flat(near), flat(far), image_shape,
        bg, rep(gaussians.means), rep(gaussians.covariances),
        rep(gaussians.harmonics), rep(gaussians.opacities),
        impl=cfg.impl, config=cfg.raster, device=dev,
    )
    h, w = image_shape
    return DecoderOutput(color=color.reshape(b, v, h, w, 3), depth=None)
