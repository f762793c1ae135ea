"""Public rasterizer API: batched rendering (forward).

Port of `pf3plat_tpu/ops/rasterizer/api.py:render` with the `streamed`
(production) and `bruteforce` (oracle) backends. The JAX package's `tiled`
and `pallas` backends, `render_depth` and `render_orthographic` are not
ported in this slice.
"""

from __future__ import annotations

import math

import torch

from ...device import resolve_device
from .project import make_camera, project_gaussians
from .reference_impl import composite_bruteforce
from .streamed import composite_streamed_batched
from .types import RasterizeConfig

DEFAULT_CONFIG = RasterizeConfig()


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
    scale_invariant: bool = True,
    use_sh: bool = True,
    impl: str = "streamed",
    config: RasterizeConfig = DEFAULT_CONFIG,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Render each batch element's gaussians into its camera -> (b, h, w, c).

    Runs on `device` (default `cuda`; the inputs are moved there)."""
    dev = resolve_device(device)
    extrinsics, intrinsics, near, far, background, means, covariances, sh, \
        opacities = (
            t.to(dev) for t in (extrinsics, intrinsics, near, far, background,
                                means, covariances, sh, opacities)
        )
    if scale_invariant:
        # Put the world in a numerically friendly range: scale so near == 1.
        scale = 1.0 / near
        extrinsics = extrinsics.clone()
        extrinsics[..., :3, 3] = extrinsics[..., :3, 3] * scale[:, None]
        covariances = covariances * (scale[:, None, None, None] ** 2)
        means = means * scale[:, None, None]

    sh_degree = int(math.isqrt(sh.shape[-1])) - 1
    camera = make_camera(extrinsics, intrinsics, image_shape)
    screen = project_gaussians(
        camera, means, covariances, opacities, sh, sh_degree, config, use_sh=use_sh
    )
    if impl == "streamed":
        return composite_streamed_batched(screen, image_shape, background, config)
    if impl == "bruteforce":
        return torch.stack([
            composite_bruteforce(
                type(screen)(*(f[i] for f in screen)), image_shape,
                background[i], config,
            )
            for i in range(means.shape[0])
        ])
    raise ValueError(f"rasterizer impl {impl!r} is not ported (streamed, bruteforce)")
