"""Export Gaussians to the standard 3DGS .ply format (Polycam-compatible).

Port of `pf3plat_tpu/utils/ply_export.py` (the reference's
`src/model/ply_export.py:26-117`): median-centering, 95th-percentile
rescale, axis swizzle so +Z is up with a -45 degree viewer adjustment,
camera-relative orientation, DC-band-only SH. Written with a
self-contained binary PLY writer (no plyfile dependency). Host-side: numpy
in, the two rotation conversions on CPU tensors.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..geometry.transforms import matrix_to_quaternion
from ..models.gaussian_adapter import quaternion_xyzw_to_matrix


def _write_binary_ply(path: Path, fields: list[str], data: np.ndarray) -> None:
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {data.shape[0]}",
        *[f"property float {f}" for f in fields],
        "end_header",
    ]
    with Path(path).open("wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


def export_ply(
    extrinsics: np.ndarray,   # (4, 4) c2w of the reference camera
    means: np.ndarray,        # (g, 3)
    scales: np.ndarray,       # (g, 3)
    rotations: np.ndarray,    # (g, 4) xyzw
    harmonics: np.ndarray,    # (g, 3, d_sh)
    opacities: np.ndarray,    # (g,)
    path: Path,
) -> None:
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    rotations = np.asarray(rotations, np.float32)
    harmonics = np.asarray(harmonics, np.float32)
    opacities = np.asarray(opacities, np.float32)
    extrinsics = np.asarray(extrinsics, np.float32)

    means = means - np.median(means, axis=0)
    scale_factor = np.quantile(np.abs(means), 0.95, axis=0).max()
    scale_factor = max(scale_factor, 1e-12)
    means = means / scale_factor
    scales = scales / scale_factor

    rotation = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    a = np.deg2rad(-45.0)
    adjustment = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        np.float32,
    )
    rotation = adjustment @ rotation
    rotation = rotation @ np.linalg.inv(extrinsics[:3, :3])

    means = means @ rotation.T

    rot_mats = quaternion_xyzw_to_matrix(torch.from_numpy(rotations)).numpy()
    rot_mats = rotation @ rot_mats
    quats_wxyz = matrix_to_quaternion(torch.from_numpy(np.ascontiguousarray(rot_mats))).numpy()

    harmonics_dc = harmonics[..., 0]

    fields = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    data = np.concatenate(
        [
            means,
            np.zeros_like(means),
            harmonics_dc,
            opacities[:, None],
            np.log(np.maximum(scales, 1e-12)),
            quats_wxyz,
        ],
        axis=1,
    )
    Path(path).parent.mkdir(exist_ok=True, parents=True)
    _write_binary_ply(Path(path), fields, data)
