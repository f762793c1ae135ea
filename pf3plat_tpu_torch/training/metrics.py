"""Evaluation metrics: PSNR / SSIM + pose errors and pose AUC.

Port of `pf3plat_tpu/training/metrics.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.transforms import geodesic_distance, translation_angle
from ..ops.ssim import ssim as _ssim
from ..precision import exact


def compute_psnr(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1], any matching shape; per-image PSNR over last 3 dims."""
    gt = torch.clamp(ground_truth, 0.0, 1.0)
    pr = torch.clamp(predicted, 0.0, 1.0)
    mse = torch.mean((gt - pr) ** 2, dim=(-3, -2, -1))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def compute_ssim(ground_truth: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) images -> per-image SSIM."""
    return _ssim(ground_truth, predicted, size_average=False)


def pose_errors(pred_c2w: torch.Tensor, gt_c2w: torch.Tensor) -> dict:
    """Rotation geodesic (deg), translation norm, translation angle (deg)
    of the first->last context pair ((..., v, 4, 4) camera-to-world), in
    exact float32 whatever the policy says (`precision.exact`): under TF32
    the relative rotation leaves SO(3), and the arccos of a trace near 3
    turns that into a tenth of a degree of rotation error."""
    def rel(m):
        return torch.matmul(torch.linalg.inv(m[..., -1, :, :]), m[..., 0, :, :])

    with exact():
        rp = rel(pred_c2w)
        rg = rel(gt_c2w)
        rot_deg = torch.rad2deg(geodesic_distance(rp[..., :3, :3], rg[..., :3, :3]))
        t_norm = torch.linalg.norm(rp[..., :3, 3] - rg[..., :3, 3], dim=-1)
        t_angle = torch.rad2deg(translation_angle(rp[..., :3, 3], rg[..., :3, 3]))
    return {"rot_deg": rot_deg, "trans_norm": t_norm, "trans_angle_deg": t_angle}


def pose_auc(errors, thresholds=(5.0, 10.0, 20.0)) -> dict:
    """Pose AUC at degree thresholds (host-side, over the whole eval set):
    the exact integral of the recall curve over the sorted errors, divided
    by the threshold."""
    if isinstance(errors, torch.Tensor):
        errors = errors.detach().cpu().numpy()
    errors = np.sort(np.asarray(errors, dtype=np.float64))
    n = len(errors)
    out = {}
    for t in thresholds:
        if n == 0:
            out[f"auc_{t:g}"] = 0.0
            continue
        recall = (np.arange(n) + 1) / n
        e = np.concatenate(([0.0], errors))
        r = np.concatenate(([0.0], recall))
        last = int(np.searchsorted(e, t))  # >= 1 since e[0] = 0 < t
        e_c = np.concatenate((e[:last], [t]))
        r_c = np.concatenate((r[:last], [r[last - 1]]))
        out[f"auc_{t:g}"] = float(np.trapezoid(r_c, x=e_c) / t)
    return out
