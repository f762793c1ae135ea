"""Gaussian adapter: raw per-pixel features -> world-space Gaussians.

Port of `pf3plat_tpu/models/gaussian_adapter.py`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.projection import get_world_rays, intrinsics_inverse
from ..geometry.sh import rotate_sh
from ..geometry.transforms import quaternion_to_matrix


@dataclasses.dataclass(frozen=True)
class GaussianAdapterCfg:
    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4

    @property
    def d_sh(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        """3 scale + 4 quaternion + 3*d_sh SH."""
        return 7 + 3 * self.d_sh


def quaternion_xyzw_to_matrix(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    wxyz = torch.cat([q[..., 3:4], q[..., :3]], dim=-1)
    return quaternion_to_matrix(wxyz, eps=eps)


def build_covariance(scale: torch.Tensor, rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T."""
    rs = quaternion_xyzw_to_matrix(rotation_xyzw) * scale[..., None, :]
    return torch.einsum("...ij,...kj->...ik", rs, rs)


def sh_mask(cfg: GaussianAdapterCfg, dtype=torch.float32, device=None) -> torch.Tensor:
    mask = torch.ones((cfg.d_sh,), dtype=dtype, device=device)
    for degree in range(1, cfg.sh_degree + 1):
        mask[degree**2 : (degree + 1) ** 2] = 0.1 * 0.25**degree
    return mask


def get_scale_multiplier(intrinsics, pixel_size, multiplier: float = 0.1):
    k_inv = intrinsics_inverse(intrinsics)[..., :2, :2]
    xy = multiplier * torch.einsum("...ij,...j->...i", k_inv, pixel_size)
    return xy.sum(dim=-1)


def adapt_gaussians(cfg: GaussianAdapterCfg, extrinsics, intrinsics, coordinates,
                    depths, opacities, raw_gaussians, image_shape, eps: float = 1e-8):
    """Raw features -> (means, covariances, harmonics, opacities, scales,
    rotations); extrinsics are c2w, leading dims broadcast."""
    h, w = image_shape
    dev, dt = raw_gaussians.device, raw_gaussians.dtype
    scales = raw_gaussians[..., 0:3]
    rotations = raw_gaussians[..., 3:7]
    sh = raw_gaussians[..., 7:]

    s_min, s_max = cfg.gaussian_scale_min, cfg.gaussian_scale_max
    scales = s_min + (s_max - s_min) * torch.sigmoid(scales)
    pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=dt, device=dev)
    mult = get_scale_multiplier(intrinsics, pixel_size)
    scales = scales * depths[..., None] * mult[..., None]

    rotations = rotations / (torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps)
    sh = sh.unflatten(-1, (3, cfg.d_sh)) * sh_mask(cfg, dt, dev)

    covariances = build_covariance(scales, rotations)
    c2w_rot = extrinsics[..., :3, :3]
    covariances = torch.einsum("...ij,...jk,...lk->...il", c2w_rot, covariances, c2w_rot)

    origins, directions = get_world_rays(coordinates, extrinsics, intrinsics)
    means = origins + directions * depths[..., None]
    harmonics = rotate_sh(sh, c2w_rot[..., None, :, :], cfg.sh_degree)
    return means, covariances, harmonics, opacities, scales, rotations
