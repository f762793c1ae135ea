"""Rotation / rigid-transform utilities on torch tensors.

Port of `pf3plat_tpu/geometry/transforms.py` (the serving path's part).
"""

from __future__ import annotations

import torch


def geodesic_distance(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Per-element geodesic angle (radians) between rotation matrices."""
    m = torch.matmul(r1, r2.transpose(-1, -2))
    trace = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


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
