"""Multi-view camera synchronization (chaining + spectral sync), torch port
of `pf3plat_tpu/geometry/camera_sync.py`."""

from __future__ import annotations

from typing import Sequence

import torch

from .projection import se3_inverse
from .transforms import so3_project


def camera_chaining(rel_poses: torch.Tensor) -> torch.Tensor:
    """(b, N-1, 4, 4) poses k -> k+1 to (b, N, 4, 4) poses 0 -> k."""
    b = rel_poses.shape[0]
    eye = torch.eye(4, dtype=rel_poses.dtype, device=rel_poses.device)
    out = [eye.expand(b, 4, 4)]
    for k in range(rel_poses.shape[1]):
        out.append(torch.matmul(rel_poses[:, k], out[-1]))
    return torch.stack(out, dim=1)


def camera_synchronization(
    rel_poses: torch.Tensor,
    confidence: torch.Tensor,
    pair_i: Sequence[int],
    pair_j: Sequence[int],
    num_views: int,
    squares: int = 10,
    so3_projection: bool = True,
    center_first_camera: bool = True,
    fallback: torch.Tensor | None = None,
) -> torch.Tensor:
    """Confidence-weighted spectral synchronization of pairwise poses.

    rel_poses (b, P, 4, 4) maps view pair_i[p] -> pair_j[p]; confidence
    (b, P). Returns (b, N, 4, 4) transforms view 0 -> view k.
    """
    n = num_views
    b = confidence.shape[0]
    dtype, dev = rel_poses.dtype, rel_poses.device
    i_idx = torch.as_tensor(pair_i, device=dev)
    j_idx = torch.as_tensor(pair_j, device=dev)

    conf = torch.zeros((b, n, n), dtype=dtype, device=dev)
    for p in range(len(pair_i)):
        i, j = pair_i[p], pair_j[p]
        conf[:, i, j] += confidence[:, p]
        conf[:, j, i] += confidence[:, p]
    diag = torch.zeros((b, n), dtype=dtype, device=dev)
    for p in range(len(pair_i)):
        diag[:, pair_i[p]] += confidence[:, p] / 2
        diag[:, pair_j[p]] += confidence[:, p] / 2
    conf = conf + torch.diag_embed(diag)
    conf = conf / torch.clamp(conf.sum(dim=1, keepdim=True), min=1e-9)

    blocks = torch.zeros((b, n, n, 4, 4), dtype=dtype, device=dev)
    eye = torch.eye(4, dtype=dtype, device=dev)
    ar = torch.arange(n, device=dev)
    blocks[:, ar, ar] = conf[:, ar, ar][..., None, None] * eye
    blocks[:, i_idx, j_idx] = (
        conf[:, i_idx, j_idx][..., None, None] * se3_inverse(rel_poses)
    )
    blocks[:, j_idx, i_idx] = conf[:, j_idx, i_idx][..., None, None] * rel_poses
    l_mat = blocks.permute(0, 1, 3, 2, 4).reshape(b, 4 * n, 4 * n)

    for _ in range(squares):
        l_mat = torch.matmul(l_mat, l_mat)
        scale = torch.amax(torch.abs(l_mat), dim=(1, 2), keepdim=True)
        l_mat = l_mat / torch.clamp(scale, min=1e-30)

    l_blocks = l_mat.reshape(b, n, 4, n, 4)
    anchor = 0 if center_first_camera else n // 2
    col = l_blocks[:, :, :, anchor, :]  # (b, n, 4, 4)

    mass = col[:, :, 3:, 3:]
    degenerate = torch.amin(mass, dim=(1, 2, 3)) <= 1e-20
    col = col / torch.clamp(mass, min=1e-9)

    if so3_projection:
        col = col.clone()
        col[:, :, :3, :3] = so3_project(col[:, :, :3, :3])

    if fallback is not None:
        col = torch.where(degenerate[:, None, None, None], fallback, col)
    return col
