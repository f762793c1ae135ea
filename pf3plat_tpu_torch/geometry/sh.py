"""Real spherical harmonics (degree <= 4): evaluation and rotation.

Port of `pf3plat_tpu/geometry/sh.py`. Rotation recovers each degree-l
Wigner-D block from basis_l(R d) = D_l basis_l(d) at fixed sample
directions through a precomputed (float64, host-side) pseudoinverse, so it
is exactly consistent with `sh_basis` / `eval_sh`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

MAX_DEGREE = 4

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
       1.0925484305920792, 0.5462742152960396)
_C3 = (0.5900435899266435, 2.890611442640554, 0.4570457994644658,
       0.3731763325901154, 0.4570457994644658, 1.445305721320277,
       0.5900435899266435)
_C4 = (2.5033429417967046, 1.7701307697799304, 0.9461746957575601,
       0.6690465435572892, 0.10578554691520431, 0.6690465435572892,
       0.47308734787878004, 1.7701307697799304, 0.6258357354491761)


def _basis_components(x, y, z, degree: int, stack, full_like):
    out = [full_like(x, _C0)]
    if degree >= 1:
        out += [_C1 * y, _C1 * z, _C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [
            _C2[0] * x * y,
            _C2[1] * y * z,
            _C2[2] * (3 * zz - 1),
            _C2[3] * x * z,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * x * y * z,
            _C3[2] * y * (5 * zz - 1),
            _C3[3] * z * (5 * zz - 3),
            _C3[4] * x * (5 * zz - 1),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        out += [
            _C4[0] * x * y * (xx - yy),
            _C4[1] * y * z * (3 * xx - yy),
            _C4[2] * x * y * (7 * zz - 1),
            _C4[3] * y * z * (7 * zz - 3),
            _C4[4] * (35 * zz * zz - 30 * zz + 3),
            _C4[5] * x * z * (7 * zz - 3),
            _C4[6] * (xx - yy) * (7 * zz - 1),
            _C4[7] * x * z * (xx - 3 * yy),
            _C4[8] * (xx * xx - 6 * xx * yy + yy * yy),
        ]
    return stack(out)


def sh_basis(directions: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis at unit directions: (..., 3) -> (..., (degree+1)**2)."""
    return _basis_components(
        directions[..., 0], directions[..., 1], directions[..., 2], degree,
        lambda xs: torch.stack(xs, dim=-1), torch.full_like,
    )


def eval_sh(sh: torch.Tensor, directions: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., c, n) coefficients at (..., 3) unit directions -> (..., c)."""
    basis = sh_basis(directions, degree)
    return torch.einsum("...cn,...n->...c", sh, basis)


@lru_cache(maxsize=8)
def _sample_dirs_and_pinv(degree: int) -> tuple[np.ndarray, tuple[np.ndarray, ...]]:
    """Fibonacci-sphere sample directions + per-degree basis pseudoinverses."""
    n = 64
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    dirs = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    )
    basis = _basis_components(
        dirs[:, 0], dirs[:, 1], dirs[:, 2], degree,
        lambda xs: np.stack(xs, axis=-1), np.full_like,
    ).astype(np.float64)
    pinvs = []
    for l in range(degree + 1):
        bt = basis[:, l * l : (l + 1) * (l + 1)]
        pinvs.append(np.linalg.pinv(bt).T)
    return dirs, tuple(pinvs)


def sh_rotation_matrices(rotations: torch.Tensor, degree: int) -> list[torch.Tensor]:
    """Per-degree real-SH rotation matrices (..., 2l+1, 2l+1), l = 0..degree."""
    dirs_np, pinvs_np = _sample_dirs_and_pinv(degree)
    dirs = torch.as_tensor(dirs_np, dtype=rotations.dtype, device=rotations.device)
    rotated = torch.einsum("...ij,nj->...ni", rotations, dirs)
    basis_rot = sh_basis(rotated, degree)
    mats = []
    for l in range(degree + 1):
        pinv = torch.as_tensor(
            pinvs_np[l], dtype=rotations.dtype, device=rotations.device
        )
        block = basis_rot[..., l * l : (l + 1) * (l + 1)]
        mats.append(torch.einsum("...ni,nk->...ik", block, pinv))
    return mats


def rotate_sh(sh: torch.Tensor, rotations: torch.Tensor, degree: int) -> torch.Tensor:
    """Rotate SH coefficient vectors (..., n) by (..., 3, 3) rotations."""
    mats = sh_rotation_matrices(rotations, degree)
    out = []
    for l in range(degree + 1):
        block = sh[..., l * l : (l + 1) * (l + 1)]
        out.append(torch.einsum("...ij,...j->...i", mats[l], block))
    return torch.cat(out, dim=-1)
