"""Rotation / rigid-transform utilities on torch tensors.

Port of `pf3plat_tpu/geometry/transforms.py`.
"""

from __future__ import annotations

import torch


def geodesic_distance(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Per-element geodesic angle (radians) between rotation matrices."""
    m = torch.matmul(r1, r2.transpose(-1, -2))
    trace = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))


def translation_angle(t1: torch.Tensor, t2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Angle (radians) between translation directions (pose metrics)."""
    cos = torch.sum(_normalize(t1, eps) * _normalize(t2, eps), dim=-1)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def plucker_embedding(origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Pluecker ray coordinates (moment, direction) -> (..., 6):
    cross(origin, direction) concatenated with direction."""
    moment = torch.cross(origins, directions, dim=-1)
    return torch.cat([moment, directions], dim=-1)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D rotation -> 3x3 matrix (rows b1, b2, b3)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _normalize(a1, 1e-12)
    proj = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2 = _normalize(a2 - proj * b1, 1e-12)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    return torch.cat([m[..., 0, :], m[..., 1, :]], dim=-1)


def quaternion_to_matrix(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """wxyz quaternion (normalized internally) -> rotation matrix."""
    q = _normalize(q, eps)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (wxyz), branch-free (Shepperd /
    max-trace): all four candidate solutions, the best by its magnitude,
    sign canonical (w >= 0)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = torch.clamp(1 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1 - m00 - m11 + m22, min=0.0)

    # candidate quaternions, each scaled by 4 * its largest component
    cands = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
    ], dim=-2)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = _normalize(torch.gather(cands, -2, idx)[..., 0, :], 1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def make_rt(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Encode X -> X @ R + t (row-vector convention) as a column-vector 4x4."""
    rt = torch.cat([r.transpose(-1, -2), t[..., None]], dim=-1)
    bottom = torch.zeros_like(rt[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([rt, bottom], dim=-2)


def so3_project(m: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto SO(3) via SVD with determinant correction."""
    u, _, vt = torch.linalg.svd(m)
    det = torch.linalg.det(torch.matmul(u, vt))
    ones = torch.ones_like(det)
    s = torch.stack([ones, ones, det], dim=-1)
    return torch.matmul(u * s[..., None, :], vt)
