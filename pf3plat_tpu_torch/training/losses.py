"""Training losses; port of `pf3plat_tpu/training/losses.py`.

MSE and SSIM on the middle (novel) target views, LPIPS after a warm-up
step, and the pose/correspondence loss (confidence-weighted 3D point
alignment + 2D reprojection Huber on matched keypoints) under the refined
poses. "Middle views": the context views sit at both ends of the target
stack, so indices [1:-1] are the novel views.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.projection import intrinsics_inverse
from ..models.encoder import EncoderOutput, view_pairs
from ..ops.ssim import ssim
from ..precision import exact_call


@dataclasses.dataclass(frozen=True)
class LossCfg:
    """The JAX package's `LossCfg` (the reference config of record:
    2d 0.005 / 3d 0.025, LPIPS 0.1 from step 0; the coarse-pose branch
    `pose_weight_rel` defaults to 0, as the reference's return drops it)."""

    mse_weight: float = 1.0
    ssim_weight: float = 0.1
    lpips_weight: float = 0.1
    lpips_apply_after_step: int = 0
    pose_weight_2d: float = 0.005
    pose_weight_3d: float = 0.025
    pose_weight_rel: float = 0.0


def _middle(x: torch.Tensor) -> torch.Tensor:
    """Middle (novel) views [1:-1]; all views when the stack has no middle."""
    return x[:, 1:-1] if x.shape[1] > 2 else x


def mse_loss(pred_color: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred/target: (b, v, h, w, 3); middle views only."""
    return torch.mean((_middle(pred_color) - _middle(target)) ** 2)


def ssim_loss(pred_color: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    h, w, c = pred_color.shape[2:]
    p = _middle(pred_color).reshape(-1, h, w, c)
    t = _middle(target).reshape(-1, h, w, c)
    return 1.0 - ssim(p, t)


def lpips_loss(lpips_fn, pred_color: torch.Tensor, target: torch.Tensor, step: int,
               apply_after_step: int) -> torch.Tensor:
    h, w, c = pred_color.shape[2:]
    p = _middle(pred_color).reshape(-1, h, w, c)
    t = _middle(target).reshape(-1, h, w, c)
    if step < apply_after_step:
        return torch.zeros((), dtype=pred_color.dtype, device=pred_color.device)
    return lpips_fn(p, t).mean()


def render_loss(cfg: LossCfg, pred_color, target, step: int, lpips_fn=None
                ) -> tuple[torch.Tensor, dict]:
    """NoPoSplat's loss over every rendered view (no context view is
    rendered): MSE and, from `lpips_apply_after_step` on, LPIPS, each at its
    weight -> (sum, parts)."""
    losses = {"mse": cfg.mse_weight * torch.mean((pred_color - target) ** 2)}
    if lpips_fn is not None:
        h, w, c = pred_color.shape[2:]
        lpips = lpips_fn(pred_color.reshape(-1, h, w, c), target.reshape(-1, h, w, c)).mean() \
            if step >= cfg.lpips_apply_after_step else pred_color.new_zeros(())
        losses["lpips"] = cfg.lpips_weight * lpips
    return sum(losses.values()), losses


def project_to_other_image(xy, depth, k_i, k_j, rel, eps: float = 1e-8):
    """Reproject view-i normalized pixel coords (..., n, 2) at depth (..., n)
    into view j's normalized coords through the cam_i -> cam_j transform."""
    homo = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    pts_i = torch.einsum("...ij,...nj->...ni", intrinsics_inverse(k_i), homo)
    pts_i = pts_i * depth[..., None]
    pts_j = torch.einsum("...ij,...nj->...ni", rel[..., :3, :3], pts_i) + rel[..., None, :3, 3]
    proj = torch.einsum("...ij,...nj->...ni", k_j, pts_j)
    return proj[..., :2] / torch.clamp(proj[..., 2:], min=eps)


def pose_loss(enc: EncoderOutput, intrinsics: torch.Tensor, cfg: LossCfg) -> torch.Tensor:
    """Confidence-weighted 3D + 2D correspondence residuals under the
    refined absolute poses (and, when `pose_weight_rel` > 0, under the
    coarse pairwise poses too). Exact float32 products, forward and
    backward, whatever the policy says (`precision.exact`): the residuals are
    differences of points at depth ~4, which TF32 moves by ~1e-3 (README,
    documented deviation 5). Gradients reach the refined poses, the points
    and the depths."""
    def loss(refined, xyz, depths):
        return _pose_loss(enc._replace(refined_poses=refined, xyz=xyz, depths=depths),
                          intrinsics, cfg)

    return exact_call(loss, enc.refined_poses, enc.xyz, enc.depths)


def _pose_loss(enc: EncoderOutput, intrinsics: torch.Tensor, cfg: LossCfg) -> torch.Tensor:
    b, v = enc.depths.shape[:2]
    h, w = enc.depths.shape[2:]
    pair_i, pair_j = view_pairs(v)
    corr = enc.correspondences
    refined = enc.refined_poses  # (b, v, 4, 4) w2c in the view-0 frame
    dt, dev = enc.depths.dtype, enc.depths.device
    wh = torch.tensor([w, h], dtype=dt, device=dev)

    def lookup(view, kpts, arr):
        xi = torch.clamp(kpts[..., 0].to(torch.int32), 0, w - 1)
        yi = torch.clamp(kpts[..., 1].to(torch.int32), 0, h - 1)
        flat = arr[:, view].reshape(b, h * w, -1)
        index = (yi * w + xi).to(torch.int64)[..., None].expand(-1, -1, flat.shape[-1])
        return torch.gather(flat, 1, index)

    total_3d = total_2d = total_rel = 0.0
    for p, (i, j) in enumerate(zip(pair_i, pair_j)):
        rel_abs = torch.einsum("bij,bjk->bik", refined[:, j], torch.linalg.inv(refined[:, i]))
        conf_ij = enc.pair_confidences[:, p]
        xyz_i = lookup(i, corr.kpts0[:, p], enc.xyz)
        xyz_j = lookup(j, corr.kpts1[:, p], enc.xyz)
        wgt = torch.where(corr.valid[:, p], corr.scores[:, p], torch.zeros_like(corr.scores[:, p]))
        wgt = wgt / torch.clamp(wgt.sum(-1, keepdim=True), min=1e-8)
        xy_i = corr.kpts0[:, p] / wh
        xy_j = corr.kpts1[:, p] / wh
        depth_i = lookup(i, corr.kpts0[:, p], enc.depths[..., None])[..., 0]

        def residuals(rel):
            pred = torch.einsum("bij,bmj->bmi", rel[:, :3, :3], xyz_i) + rel[:, None, :3, 3]
            diff3d = torch.linalg.norm(pred - xyz_j + 1e-12, dim=-1)
            loss3d = (conf_ij * (wgt * diff3d).sum(-1)).mean()
            reproj = project_to_other_image(xy_i, depth_i, intrinsics[:, i], intrinsics[:, j], rel)
            err = torch.linalg.norm(reproj - xy_j + 1e-12, dim=-1)
            delta = 0.01
            huber = torch.where(err <= delta, 0.5 * err**2, delta * (err - 0.5 * delta)) / delta
            masked = torch.where(corr.valid[:, p], huber, torch.zeros_like(huber))
            return loss3d, masked.sum(-1).mean()

        abs3d, abs2d = residuals(rel_abs)
        total_3d = total_3d + abs3d
        total_2d = total_2d + abs2d
        if cfg.pose_weight_rel > 0.0:
            rel3d, rel2d = residuals(enc.pairwise_poses[:, p])
            total_rel = total_rel + cfg.pose_weight_3d * rel3d + cfg.pose_weight_2d * rel2d

    n_pairs = len(pair_i)
    total = cfg.pose_weight_3d * total_3d / n_pairs + cfg.pose_weight_2d * total_2d / n_pairs
    if cfg.pose_weight_rel > 0.0:
        total = total + cfg.pose_weight_rel * total_rel / n_pairs
    return total


def total_loss(cfg: LossCfg, pred_color, target, enc: EncoderOutput, context_intrinsics,
               step: int, lpips_fn=None) -> tuple[torch.Tensor, dict]:
    """Weighted loss parts and their sum."""
    losses = {
        "mse": cfg.mse_weight * mse_loss(pred_color, target),
        "ssim": cfg.ssim_weight * ssim_loss(pred_color, target),
        "pose": pose_loss(enc, context_intrinsics, cfg),
    }
    if lpips_fn is not None:
        losses["lpips"] = cfg.lpips_weight * lpips_loss(
            lpips_fn, pred_color, target, step, cfg.lpips_apply_after_step)
    return sum(losses.values()), losses
