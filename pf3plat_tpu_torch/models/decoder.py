"""Splatting decoder: Gaussians + target cameras -> rendered views.

Port of `pf3plat_tpu/models/decoder.py`: flattens (batch, view) into the
render batch, repeats each scene's gaussians per view, and renders color
plus, when `depth_mode` is given, depth in that mode. `DecoderCfg.impl`
selects the rasterizer backend ("streamed", "pallas", "tiled",
"bruteforce").
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.rasterizer import DepthRenderingMode, RasterizeConfig, render, render_depth
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
    depth_mode: DepthRenderingMode | None = None,
    mesh=None,
) -> DecoderOutput:
    """`mesh`: optional `parallel.Mesh`; the kernel backends split the
    (batch * view * tile) rows over its shards."""
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
        impl=cfg.impl, config=cfg.raster, device=dev, mesh=mesh,
    )
    h, w = image_shape
    depth = None
    if depth_mode is not None:
        depth = render_depth(
            flat(extrinsics), flat(intrinsics), flat(near), flat(far), image_shape,
            rep(gaussians.means), rep(gaussians.covariances), rep(gaussians.opacities),
            mode=depth_mode, impl=cfg.impl, config=cfg.raster, device=dev, mesh=mesh,
        ).reshape(b, v, h, w)
    return DecoderOutput(color=color.reshape(b, v, h, w, 3), depth=depth)
