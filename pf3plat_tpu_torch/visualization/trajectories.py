"""Camera trajectory generators for novel-view videos (torch).

Port of `pf3plat_tpu/visualization/trajectories.py`. Mirrors
`src/visualization/camera_trajectory/`:
  * `interpolate_extrinsics` / `interpolate_intrinsics` — slerp-style pose
    interpolation (`interpolation.py:208`, `:8`)
  * `generate_wobble` — circular image-plane wobble (`wobble.py:8-32`)
  * `generate_spin` — azimuth orbit at fixed elevation (`spin.py:9-45`)
"""

from __future__ import annotations

import math

import torch

from ..geometry.transforms import matrix_to_quaternion, quaternion_to_matrix


def slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of wxyz quaternions; t broadcasts."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)


def interpolate_extrinsics(initial: torch.Tensor, final: torch.Tensor, t: torch.Tensor
                           ) -> torch.Tensor:
    """(4,4) x (4,4) x (s,) -> (s, 4, 4): slerp rotation + lerp translation."""
    q0 = matrix_to_quaternion(initial[:3, :3])
    q1 = matrix_to_quaternion(final[:3, :3])
    q = slerp(q0[None], q1[None], t[:, None])
    r = quaternion_to_matrix(q)
    trans = initial[:3, 3][None] * (1 - t[:, None]) + final[:3, 3][None] * t[:, None]
    out = torch.eye(4, dtype=initial.dtype, device=initial.device).repeat(t.shape[0], 1, 1)
    out[:, :3, :3] = r
    out[:, :3, 3] = trans
    return out


def interpolate_intrinsics(initial: torch.Tensor, final: torch.Tensor, t: torch.Tensor
                           ) -> torch.Tensor:
    return initial[None] * (1 - t[:, None, None]) + final[None] * t[:, None, None]


def generate_wobble_transformation(
    radius: torch.Tensor, t: torch.Tensor, num_rotations: int = 1,
    scale_radius_with_t: bool = True,
) -> torch.Tensor:
    """(...,) radius x (s,) t -> (..., s, 4, 4) image-plane wobble."""
    shape = (*radius.shape, t.shape[0])
    tf = torch.eye(4, dtype=t.dtype, device=t.device).expand(*shape, 4, 4).clone()
    r = radius[..., None]
    if scale_radius_with_t:
        r = r * t
    tf[..., 0, 3] = torch.sin(2 * math.pi * num_rotations * t) * r
    tf[..., 1, 3] = -torch.cos(2 * math.pi * num_rotations * t) * r
    return tf


def generate_wobble(extrinsics: torch.Tensor, radius: torch.Tensor, t: torch.Tensor
                    ) -> torch.Tensor:
    tf = generate_wobble_transformation(radius, t)
    return torch.einsum("...ij,...sjk->...sik", extrinsics, tf)


def generate_spin(num_frames: int, elevation: float, radius: float,
                  dtype=torch.float32) -> torch.Tensor:
    tf_translation = torch.eye(4, dtype=dtype)
    tf_translation[0, 0] = -1.0
    tf_translation[1, 1] = -1.0
    tf_translation[2, 3] = -radius

    phi = 2 * math.pi * (torch.arange(num_frames, dtype=dtype) / num_frames)
    c, s = torch.cos(phi), torch.sin(phi)
    zeros = torch.zeros_like(phi)
    ones = torch.ones_like(phi)
    azimuth = torch.stack(
        [c, zeros, s, zeros, ones, zeros, -s, zeros, c], dim=-1
    ).reshape(num_frames, 3, 3)
    tf_azimuth = torch.eye(4, dtype=dtype).repeat(num_frames, 1, 1)
    tf_azimuth[:, :3, :3] = azimuth

    el = torch.deg2rad(torch.tensor(elevation, dtype=dtype))
    ce, se = torch.cos(el), torch.sin(el)
    tf_elevation = torch.eye(4, dtype=dtype)
    tf_elevation[1, 1], tf_elevation[1, 2] = ce, -se
    tf_elevation[2, 1], tf_elevation[2, 2] = se, ce

    return torch.einsum("sij,jk,kl->sil", tf_azimuth, tf_elevation, tf_translation)
