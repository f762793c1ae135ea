"""EWA projection of 3D Gaussians to screen space (plain PyTorch).

Port of `pf3plat_tpu/ops/rasterizer/project.py`, batched over leading dims
instead of `vmap`.
"""

from __future__ import annotations

import torch

from ...geometry import sh as sh_lib
from ...geometry.projection import get_fov, se3_inverse
from .types import Camera, RasterizeConfig, ScreenGaussians


def make_camera(
    extrinsics: torch.Tensor, intrinsics: torch.Tensor, image_shape: tuple[int, int]
) -> Camera:
    """Pixel-unit camera data from c2w extrinsics + normalized intrinsics."""
    h, w = image_shape
    fov = get_fov(intrinsics)
    return Camera(
        w2c=se3_inverse(extrinsics),
        campos=extrinsics[..., :3, 3],
        fx=intrinsics[..., 0, 0] * w,
        fy=intrinsics[..., 1, 1] * h,
        cx=intrinsics[..., 0, 2] * w,
        cy=intrinsics[..., 1, 2] * h,
        tan_fov_x=torch.tan(0.5 * fov[..., 0]),
        tan_fov_y=torch.tan(0.5 * fov[..., 1]),
    )


def project_gaussians(
    camera: Camera,
    means: torch.Tensor,        # (..., n, 3) world
    covariances: torch.Tensor,  # (..., n, 3, 3)
    opacities: torch.Tensor,    # (..., n)
    sh: torch.Tensor,           # (..., n, c, d_sh)
    sh_degree: int,
    config: RasterizeConfig,
    use_sh: bool = True,
) -> ScreenGaussians:
    rot = camera.w2c[..., :3, :3]
    t = camera.w2c[..., None, :3, 3]
    cam = torch.einsum("...ij,...nj->...ni", rot, means) + t
    tz = cam[..., 2]
    in_front = tz > config.near_cull
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    fx = camera.fx[..., None]
    fy = camera.fy[..., None]
    x_pix = fx * cam[..., 0] / tz_safe + camera.cx[..., None]
    y_pix = fy * cam[..., 1] / tz_safe + camera.cy[..., None]
    xy = torch.stack([x_pix, y_pix], dim=-1)

    lim_x = 1.3 * camera.tan_fov_x[..., None]
    lim_y = 1.3 * camera.tan_fov_y[..., None]
    txz = torch.clamp(cam[..., 0] / tz_safe, -lim_x, lim_x)
    tyz = torch.clamp(cam[..., 1] / tz_safe, -lim_y, lim_y)

    cov_cam = torch.einsum("...ij,...njk,...lk->...nil", rot, covariances, rot)
    inv_z = 1.0 / tz_safe
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z
    c00, c01, c02 = cov_cam[..., 0, 0], cov_cam[..., 0, 1], cov_cam[..., 0, 2]
    c11, c12, c22 = cov_cam[..., 1, 1], cov_cam[..., 1, 2], cov_cam[..., 2, 2]
    a = j00 * j00 * c00 + 2 * j00 * j02 * c02 + j02 * j02 * c22
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * j11 * c11 + 2 * j11 * j12 * c12 + j12 * j12 * c22
    a = a + config.dilation
    c = c + config.dilation

    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(config.sigma_radius * torch.sqrt(lam1))

    valid = in_front & (det > 0) & (opacities > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    if use_sh:
        directions = means - camera.campos[..., None, :]
        directions = directions / torch.clamp(
            torch.linalg.norm(directions, dim=-1, keepdim=True), min=1e-12
        )
        color = sh_lib.eval_sh(sh, directions, sh_degree)
        color = torch.clamp(color + 0.5, min=0.0)
    else:
        color = sh[..., 0]

    return ScreenGaussians(
        xy=xy, depth=tz, conic=conic, radius=radius, color=color,
        opacity=opacities, valid=valid,
    )
