"""Epipolar ray projection + view overlap estimation on torch tensors.

Port of `pf3plat_tpu/geometry/epipolar.py` (the roles of the reference's
`src/geometry/epipolar_lines.py`, `project_rays:157`, used by the
evaluation index generator): one camera's rays are sampled at
logarithmically spaced depths and projected into another camera, and the
pairwise view overlap is the share of rays that enter the other frustum.
"""

from __future__ import annotations

import numpy as np
import torch

from .projection import get_world_rays, project, sample_image_grid


def depth_samples(near: float, far: float, num_samples: int) -> np.ndarray:
    """`jnp.geomspace(near, far, num_samples, dtype=float32)` as XLA
    computes it: log10 of both ends by ln(x) * f32(1/ln 10), the linspace
    as `start * (1 - i * f32(1/(n-1))) + i * (stop * f32(1/(ln 10 (n-1))))`
    in float32, then 10**x rounded once to float32. Bit-equal to JAX's at
    the overlap's defaults (1, 100, 32); elsewhere within a few float32
    ulps (XLA's own log and pow round differently)."""
    f32, f64 = np.float32, np.float64
    c = f32(1 / np.log(10))
    r = f32(1) / f32(num_samples - 1)
    lo, hi = (f32(np.log(f64(f32(x)))) for x in (near, far))
    i = np.arange(num_samples - 1, dtype=f32)
    lin = f32(lo * c) * (f32(1) - i * r) + i * f32(hi * f32(c * r))
    lin = np.concatenate([lin, [f32(hi * c)]]).astype(f32)
    return (10.0 ** lin.astype(f64)).astype(f32)


def project_ray_samples(
    origins: torch.Tensor,       # (..., 3) world
    directions: torch.Tensor,    # (..., 3) world unit
    extrinsics: torch.Tensor,    # (..., 4, 4) target c2w
    intrinsics: torch.Tensor,    # (..., 3, 3) target normalized
    near: float = 1.0,
    far: float = 100.0,
    num_samples: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project points along each ray into the target view.

    Returns (xy (..., s, 2), valid (..., s)): normalized target coords and
    in-image/in-front validity per depth sample.
    """
    t = torch.as_tensor(depth_samples(near, far, num_samples), dtype=origins.dtype,
                        device=origins.device)
    pts = origins[..., None, :] + directions[..., None, :] * t[:, None]
    xy, in_front = project(
        pts, extrinsics[..., None, :, :], intrinsics[..., None, :, :]
    )
    in_image = (
        (xy[..., 0] >= 0.0) & (xy[..., 0] <= 1.0)
        & (xy[..., 1] >= 0.0) & (xy[..., 1] <= 1.0)
    )
    return xy, in_front & in_image


def view_overlap(
    extrinsics_a: torch.Tensor,  # (4, 4) c2w
    intrinsics_a: torch.Tensor,  # (3, 3)
    extrinsics_b: torch.Tensor,
    intrinsics_b: torch.Tensor,
    grid: tuple[int, int] = (16, 16),
    near: float = 1.0,
    far: float = 100.0,
) -> torch.Tensor:
    """Fraction of view A's rays that enter view B's frustum: the overlap
    behind the evaluation index and the small/medium/large buckets."""
    xy, _ = sample_image_grid(grid, dtype=extrinsics_a.dtype, device=extrinsics_a.device)
    origins, directions = get_world_rays(
        xy.reshape(-1, 2), extrinsics_a, intrinsics_a
    )
    _, valid = project_ray_samples(
        origins, directions, extrinsics_b, intrinsics_b, near, far
    )
    return valid.any(dim=-1).float().mean()
