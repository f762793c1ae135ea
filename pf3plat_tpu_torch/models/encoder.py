"""Pose-free encoder (port of `pf3plat_tpu/models/encoder.py`).

Stages: feature aggregation (LoFTR linear attention + swin windows) ->
per-view scale/shift depth refinement -> batched Procrustes RANSAC coarse
poses -> camera chaining / spectral synchronization -> transformer pose
refinement -> plane-sweep cost-volume Gaussian prediction -> adapter.

RANSAC noise: `forward` takes an optional precomputed Gumbel tensor
(b, n_pairs, ransac_samples, m); without it the noise is drawn from the
caller's `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..geometry import camera_sync, procrustes
from ..geometry.projection import get_world_rays, sample_image_grid, se3_inverse, unproject
from ..geometry.transforms import make_rt, matrix_to_rotation_6d, rotation_6d_to_matrix
from ..precision import exact
from ..utils.profiling import span
from .costvolume import DepthPredictorCfg, DepthPredictorMultiView
from .gaussian_adapter import GaussianAdapterCfg, adapt_gaussians
from .layers import (
    CrossBlock,
    LearnableFourierPositionalEncoding,
    LocalFeatureTransformer,
    Mlp,
    SelfBlock,
    get_2d_sincos_pos_embed,
    position_embedding_sine,
)
from .multiview_transformer import MultiViewFeatureTransformer
from .nhwc import Conv, resize_bilinear
from .remat import remat
from .types import Gaussians


class FrozenInputs(NamedTuple):
    depth: torch.Tensor     # (b, v, h, w) metric monocular depth
    features: torch.Tensor  # (b, v, hd, wd, cd) backbone features


class Correspondences(NamedTuple):
    kpts0: torch.Tensor   # (b, n_pairs, m, 2) pixel (x, y)
    kpts1: torch.Tensor
    scores: torch.Tensor  # (b, n_pairs, m)
    valid: torch.Tensor   # (b, n_pairs, m) bool


@dataclasses.dataclass(frozen=True)
class EncoderCfg:
    d_feature: int = 256
    d_backbone: int = 2048
    num_depth_candidates: int = 128
    num_surfaces: int = 1
    gaussians_per_pixel: int = 1
    downscale_factor: int = 4
    multiview_trans_attn_split: int = 4
    n_attn_layers: int = 6
    d_pose: int = 128
    pose_heads: int = 4
    confidence_min: float = 0.5
    ransac_samples: int = 128
    ransac_threshold: float = 0.02
    opacity_initial: float = 0.0
    opacity_final: float = 0.0
    opacity_warm_up: int = 1
    # Recompute the trainable stacks in the backward instead of keeping
    # their activations: every pose/depth attention block and the
    # cross-view aggregator, then under "selective" the depth predictor's
    # two U-Nets, under any other mode the whole depth predictor.
    remat: bool = True
    remat_mode: str = "selective"
    # Compute dtypes ("float32", "bfloat16", ...) of the two U-Nets'
    # convolutions and of the plane sweep's features (`costvolume.py`).
    unet_dtype: str = "float32"
    costvolume_dtype: str = "float32"
    # Depth candidates warped per plane-sweep step (bounds the warped
    # feature buffer).
    costvolume_scan_chunk: int = 16
    gaussian_adapter: GaussianAdapterCfg = GaussianAdapterCfg()
    costvolume_unet_feat_dim: int = 128
    costvolume_unet_channel_mult: Sequence[int] = (1, 1, 1)
    costvolume_unet_attn_res: Sequence[int] = (4,)
    depth_unet_feat_dim: int = 32
    depth_unet_attn_res: Sequence[int] = (16,)
    depth_unet_channel_mult: Sequence[int] = (1, 1, 1, 1, 1)

    @property
    def remat_policy(self) -> str:
        """"off", "selective" or "coarse": any `remat_mode` but "selective"
        is coarse, as the JAX encoder reads it."""
        if not self.remat:
            return "off"
        return "selective" if self.remat_mode == "selective" else "coarse"


def view_pairs(v: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """All ordered pairs (i, j), i < j."""
    pi, pj = [], []
    for i in range(v):
        for j in range(i + 1, v):
            pi.append(i)
            pj.append(j)
    return tuple(pi), tuple(pj)


def map_pdf_to_opacity(pdf: torch.Tensor, step: float, cfg: EncoderCfg) -> torch.Tensor:
    frac = min(float(step) / cfg.opacity_warm_up, 1.0)
    x = cfg.opacity_initial + frac * (cfg.opacity_final - cfg.opacity_initial)
    exponent = 2.0**x
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))


class EncoderOutput(NamedTuple):
    gaussians: Gaussians
    pairwise_poses: torch.Tensor   # (b, n_pairs, 4, 4) coarse i -> j
    sync_poses: torch.Tensor       # (b, v, 4, 4) w2c in the view-0 frame
    refined_poses: torch.Tensor    # (b, v, 4, 4)
    depths: torch.Tensor           # (b, v, h, w)
    xyz: torch.Tensor              # (b, v, h, w, 3)
    correspondences: Correspondences
    pair_confidences: torch.Tensor  # (b, n_pairs)


def lookup_xyz(xyz: torch.Tensor, view: int, kpts: torch.Tensor) -> torch.Tensor:
    """The camera-space points (b, m, 3) of view `view` of `xyz` (b, v, h,
    w, 3) at the pixels the keypoints `kpts` (b, m, 2) fall in."""
    b, _, h, w, _ = xyz.shape
    xi = torch.clamp(kpts[..., 0].to(torch.int32), 0, w - 1)
    yi = torch.clamp(kpts[..., 1].to(torch.int32), 0, h - 1)
    flat = xyz[:, view].reshape(b, h * w, 3)
    index = (yi * w + xi).to(torch.int64)[..., None].expand(b, kpts.shape[1], 3)
    return torch.gather(flat, 1, index)


def ransac_inputs(cfg: EncoderCfg, xyz: torch.Tensor, corr: Correspondences, p: int, i: int,
                  j: int):
    """Pair `p` = (i, j)'s RANSAC inputs: the matched points of both views
    (b, m, 3), their weights (b, m) and the inlier threshold (b,), relative
    to the median depth of view j's points."""
    x_i = lookup_xyz(xyz, i, corr.kpts0[:, p]).detach()
    x_j = lookup_xyz(xyz, j, corr.kpts1[:, p]).detach()
    weights = torch.where(corr.valid[:, p], torch.clamp(corr.scores[:, p], min=1e-4),
                          torch.full_like(corr.scores[:, p], 1e-6))
    thr = cfg.ransac_threshold * torch.clamp(
        torch.quantile(x_j[..., 2], 0.5, dim=-1), min=1e-3)
    return x_i, x_j, weights, thr


def coarse_poses(cfg: EncoderCfg, xyz: torch.Tensor, corr: Correspondences,
                 ransac_noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The coarse pairwise poses (b, n_pairs, 4, 4), cam_i -> cam_j by
    Procrustes RANSAC on the matched points (the identity where a pair has
    fewer than 8 valid matches), and the pairs' confidences (b, n_pairs):
    the mean score of the valid matches, shifted by `confidence_min` and
    rescaled for pairs of views that are not neighbours. Exact float32
    products whatever the policy says (`precision.exact`): under TF32 the
    fits of points at depth ~4 move by ~2e-3 and leave SO(3) (README,
    documented deviation 5)."""
    v = xyz.shape[1]
    eye4 = torch.eye(4, dtype=xyz.dtype, device=xyz.device)
    rel_list, conf_list = [], []
    with exact():
        for p, (i, j) in enumerate(zip(*view_pairs(v))):
            x_i, x_j, weights, thr = ransac_inputs(cfg, xyz, corr, p, i, j)
            with span("pf3.encoder.ransac"):
                fit = procrustes.align_ransac(x_i, x_j, weights, ransac_noise[:, p],
                                              threshold=thr)
            rel = make_rt(fit.r, fit.t)
            valid = corr.valid[:, p]
            msum = valid.sum(-1)
            rel_list.append(torch.where((msum >= 8)[:, None, None], rel, eye4))
            conf = torch.where(
                msum > 0,
                (corr.scores[:, p] * valid).sum(-1) / torch.clamp(msum, min=1),
                torch.zeros_like(corr.scores[:, p, 0]),
            )
            if abs(i - j) > 1:
                conf = torch.clamp(conf - cfg.confidence_min, min=0.0) / (1.0 - cfg.confidence_min)
            conf_list.append(conf)
    return torch.stack(rel_list, dim=1), torch.stack(conf_list, dim=1)


def synchronize_poses(rel_poses: torch.Tensor, confs: torch.Tensor, v: int) -> torch.Tensor:
    """The views' poses (b, v, 4, 4), view 0 -> view k: the chain of the
    neighbouring pairs for two views, else the spectral synchronisation of
    every pair with that chain where its mass degenerates. Exact float32
    products (`precision.exact`): under TF32 the ten squarings of the 4v x
    4v matrix move five views' poses by ~0.1."""
    pair_i, pair_j = view_pairs(v)
    with span("pf3.encoder.sync"), exact():
        if v == 2:
            return camera_sync.camera_chaining(rel_poses)
        pairs = list(zip(pair_i, pair_j))
        seq = [pairs.index((k, k + 1)) for k in range(v - 1)]
        chain = camera_sync.camera_chaining(rel_poses[:, seq])
        return camera_sync.camera_synchronization(rel_poses, confs, pair_i, pair_j, v,
                                                  fallback=chain)


def _zero_(linear: nn.Linear) -> None:
    nn.init.zeros_(linear.weight)
    nn.init.zeros_(linear.bias)


class PoseFreeEncoder(nn.Module):
    def __init__(self, cfg: EncoderCfg):
        super().__init__()
        self.cfg = cfg
        d, dp, L = cfg.d_feature, cfg.d_pose, cfg.n_attn_layers
        self.dino_projector = nn.Linear(cfg.d_backbone, d)
        self.dino_aggregator = LocalFeatureTransformer(d, 4)
        self.cross_view_aggregator = MultiViewFeatureTransformer(1, d)
        self.in_features = nn.Linear(d, dp)
        for i in range(L):
            self.add_module(f"depth_self_attn_{i}", SelfBlock(dp, cfg.pose_heads))
        self.scale_shift_predictor = Mlp(dp, dp * 2, 2)
        _zero_(self.scale_shift_predictor.Dense_1)
        self.posenc = LearnableFourierPositionalEncoding(2, dp // cfg.pose_heads)
        self.conv_proj = Conv(d + 6, dp, 3)
        self.pose_cls_token = nn.Parameter(torch.zeros(1, 1, dp))
        for i in range(L):
            self.add_module(f"pose_transformers_{i}", SelfBlock(dp, cfg.pose_heads))
        self.pose_token = nn.Parameter(torch.randn(1, 1, 1, dp) * 1e-6)
        for i in range(L):
            self.add_module(f"pose_self_attn_{i}", SelfBlock(dp, cfg.pose_heads))
            self.add_module(f"pose_cross_attn_{i}", CrossBlock(dp, cfg.pose_heads))
        self.embed_pose = Mlp(9, 64, dp)
        for i in range(L):
            self.add_module(f"pose_trunk_{i}", SelfBlock(dp, cfg.pose_heads))
        self.pose_branch = Mlp(dp, dp * 2, dp + 9 + 2)
        _zero_(self.pose_branch.Dense_1)
        self.pose_gamma = nn.Parameter(torch.ones(()))
        adapter = cfg.gaussian_adapter
        self.depth_predictor = DepthPredictorMultiView(DepthPredictorCfg(
            feature_channels=d,
            num_depth_candidates=cfg.num_depth_candidates,
            costvolume_unet_feat_dim=cfg.costvolume_unet_feat_dim,
            costvolume_unet_channel_mult=tuple(cfg.costvolume_unet_channel_mult),
            costvolume_unet_attn_res=tuple(cfg.costvolume_unet_attn_res),
            gaussian_raw_channels=cfg.num_surfaces * (adapter.d_in + 2),
            gaussians_per_pixel=cfg.gaussians_per_pixel,
            num_views=2,
            depth_unet_feat_dim=cfg.depth_unet_feat_dim,
            depth_unet_attn_res=tuple(cfg.depth_unet_attn_res),
            depth_unet_channel_mult=tuple(cfg.depth_unet_channel_mult),
            unet_dtype=cfg.unet_dtype,
            costvolume_dtype=cfg.costvolume_dtype,
            costvolume_scan_chunk=cfg.costvolume_scan_chunk,
            remat_unets=cfg.remat_policy == "selective",
        ))

    def _blocks(self, prefix: str):
        return [getattr(self, f"{prefix}_{i}") for i in range(self.cfg.n_attn_layers)]

    def forward(self, images, intrinsics, near, far, frozen: FrozenInputs,
                corr: Correspondences, global_step=0,
                ransac_noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> EncoderOutput:
        cfg = self.cfg
        b, v, h, w, _ = images.shape
        hd, wd = frozen.features.shape[2:4]
        h4, w4 = h // cfg.downscale_factor, w // cfg.downscale_factor
        d = cfg.d_feature
        dev, dt = images.device, images.dtype
        n_pairs = v * (v - 1) // 2
        nf = near[..., None, None]
        ff = far[..., None, None]

        depth = torch.minimum(torch.maximum(frozen.depth, nf), ff)

        # ---- cross-view feature extraction ----
        feat = self.dino_projector(frozen.features)
        tokens = self.dino_aggregator(feat.reshape(b * v, hd * wd, d))
        pre_cross = tokens.reshape(b, v, hd * wd, d)
        maps = tokens.reshape(b * v, hd, wd, d)
        splits = cfg.multiview_trans_attn_split
        if hd % splits or wd % splits:
            splits = 1
        if splits > 1:
            pos = position_embedding_sine(hd // splits, wd // splits, d // 2)
            pos = pos.repeat(splits, splits, 1)
        else:
            pos = position_embedding_sine(hd, wd, d // 2)
        maps = maps + pos.to(dev)[None]
        maps = remat(self.cross_view_aggregator, maps, splits, enabled=cfg.remat)
        per_view_depth_features = resize_bilinear(maps, (h4, w4)).reshape(b, v, h4, w4, d)

        # ---- scale/shift depth refinement ----
        ss = self.in_features(pre_cross).reshape(b * v, hd * wd, cfg.d_pose)
        for blk in self._blocks("depth_self_attn"):
            ss = remat(blk, ss, enabled=cfg.remat)
        ss = self.scale_shift_predictor(ss).reshape(b * v, hd, wd, 2)
        ss = resize_bilinear(ss, (h, w))
        shift = torch.clamp(ss[..., 1], -5.0, 5.0).reshape(b, v, h, w)
        depth = torch.minimum(torch.maximum(depth + shift, nf), ff)

        # ---- monocular one-hot cue ----
        dc = cfg.num_depth_candidates
        disp4 = resize_bilinear((1.0 / depth).reshape(b * v, h, w, 1), (h4, w4))
        inv_near = (1.0 / near).reshape(b * v)[:, None, None, None]
        inv_far = (1.0 / far).reshape(b * v)[:, None, None, None]
        hyp = inv_far + torch.linspace(0.0, 1.0, dc, device=dev, dtype=dt) * (inv_near - inv_far)
        idx = torch.argmin(torch.abs(disp4 - hyp), dim=-1)
        mono_cue_bv = torch.nn.functional.one_hot(idx, dc).to(dt).detach()

        # ---- unproject refined depth ----
        xy_grid, _ = sample_image_grid((h, w), dt, dev)
        xyz = unproject(xy_grid[None, None], depth, intrinsics[:, :, None, None])

        # ---- coarse pairwise poses: batched Procrustes RANSAC ----
        m = corr.kpts0.shape[2]
        with span("pf3.encoder.pose"):
            if ransac_noise is None:
                ransac_noise = procrustes.gumbel_noise(
                    (b, n_pairs, cfg.ransac_samples, m), generator, dev, dt)
            rel_poses, confs = coarse_poses(cfg, xyz, corr, ransac_noise)
            sync_abspose = synchronize_poses(rel_poses, confs, v)
            sync_abspose = sync_abspose.detach()  # (b, v, 4, 4) w2c

        # ---- pose refinement transformer ----
        with span("pf3.encoder.refine"):
            dp = cfg.d_pose
            xy4, _ = sample_image_grid((h4, w4), dt, dev)
            xy4 = xy4.reshape(h4 * w4, 2)
            enc_pts = torch.cat([torch.zeros((1, 2), dtype=dt, device=dev), xy4], dim=0)
            encoding0 = self.posenc(enc_pts[None])
            c2w_sync = se3_inverse(sync_abspose)
            origins, directions = get_world_rays(
                xy4[None, None], c2w_sync[:, :, None], intrinsics[:, :, None])
            plucker = torch.cat([directions, torch.cross(origins, directions, dim=-1)], dim=-1)
            feat4 = resize_bilinear(feat.reshape(b * v, hd, wd, d), (h4, w4))
            desc0 = torch.cat([feat4.reshape(b, v, h4 * w4, d), plucker], dim=-1)
            desc0 = self.conv_proj(desc0.reshape(b * v, h4, w4, d + 6)).reshape(b * v, h4 * w4, dp)
            desc0 = torch.cat([self.pose_cls_token.expand(b * v, 1, dp), desc0], dim=1)
            for blk in self._blocks("pose_transformers"):
                desc0 = remat(blk, desc0, encoding0, enabled=cfg.remat)
            desc0 = desc0[:, 1:].reshape(b, v, h4 * w4, dp)

            rgb_feat = desc0 + get_2d_sincos_pos_embed(dp, h4, w4).to(dev)[None, None]
            rgb_feat = torch.cat([self.pose_token.expand(b, v, 1, dp), rgb_feat], dim=-2)
            n_tok = rgb_feat.shape[-2]
            for i in range(cfg.n_attn_layers):
                rf = remat(getattr(self, f"pose_self_attn_{i}"),
                           rgb_feat.reshape(b * v, n_tok, dp), enabled=cfg.remat)
                rgb_feat = rf.reshape(b, v, n_tok, dp)
                if v > 1:
                    cross_ctx = torch.stack([
                        torch.cat([rgb_feat[:, k + 1:], rgb_feat[:, :k]], dim=1).reshape(b, -1, dp)
                        for k in range(1, v)
                    ], dim=1)
                    o = rgb_feat[:, 1:].reshape(b * (v - 1), n_tok, dp)
                    c = cross_ctx.reshape(b * (v - 1), (v - 1) * n_tok, dp)
                    o, _ = remat(getattr(self, f"pose_cross_attn_{i}"), o, c, update_x1=False,
                                 enabled=cfg.remat)
                    rgb_feat = torch.cat([rgb_feat[:, :1], o.reshape(b, v - 1, n_tok, dp)], dim=1)
            rgb_feat = rgb_feat[:, :, 0]

            raw_rot = matrix_to_rotation_6d(sync_abspose[:, :, :3, :3])
            raw_trans = sync_abspose[:, :, :3, 3]
            pred_pose_enc = torch.cat([raw_rot, raw_trans], dim=-1)
            trunk = rgb_feat + self.embed_pose(pred_pose_enc)
            for blk in self._blocks("pose_trunk"):
                trunk = remat(blk, trunk, enabled=cfg.remat)
            delta_pose = self.pose_branch(trunk)[..., :9]
            pred_pose = pred_pose_enc[:, 1:] + delta_pose[:, 1:] * self.pose_gamma
            pred_concat = torch.cat([pred_pose_enc[:, :1], pred_pose], dim=1)
            refined = torch.zeros((b, v, 4, 4), dtype=dt, device=dev)
            refined[:, :, :3, :3] = rotation_6d_to_matrix(pred_concat[..., :6])
            refined[:, :, :3, 3] = pred_concat[..., 6:9]
            refined[:, :, 3, 3] = 1.0

        # ---- gaussians on the first and last context view ----
        sel = [0, v - 1]
        vs = len(sel)
        adapter = cfg.gaussian_adapter

        def to_vb(x):
            return x.transpose(0, 1).reshape(vs * b, *x.shape[2:])

        with span("pf3.encoder.costvolume"):
            densities, raw_gaussians = remat(
                self.depth_predictor,
                per_view_depth_features[:, sel], intrinsics[:, sel], refined[:, sel],
                near[:, sel], far[:, sel], to_vb(images[:, sel]),
                to_vb((1.0 / depth)[:, sel][..., None]),
                to_vb(mono_cue_bv.reshape(b, v, h4, w4, dc)[:, sel]),
                enabled=cfg.remat_policy == "coarse",
            )
        with span("pf3.encoder.adapter"):
            raw_gaussians = raw_gaussians.reshape(b, vs, h * w, cfg.num_surfaces,
                                                  adapter.d_in + 2)
            offset_xy = torch.sigmoid(raw_gaussians[..., :2])
            pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=dt, device=dev)
            xy_ray = (xy_grid.reshape(h * w, 2)[None, None, :, None, :]
                      + (offset_xy - 0.5) * pixel_size)
            c2w_refined = se3_inverse(refined)
            depths_sel = depth[:, sel].reshape(b, vs, h * w)
            opacities = (map_pdf_to_opacity(densities[..., 0], global_step, cfg)
                         / cfg.gaussians_per_pixel)
            means, covs, harmonics, opac, _, _ = adapt_gaussians(
                adapter, c2w_refined[:, sel][:, :, None], intrinsics[:, sel][:, :, None],
                xy_ray[..., 0, :], depths_sel, opacities, raw_gaussians[..., 0, 2:], (h, w))
            gaussians = Gaussians(
                means=means.reshape(b, vs * h * w, 3),
                covariances=covs.reshape(b, vs * h * w, 3, 3),
                harmonics=harmonics.reshape(b, vs * h * w, 3, adapter.d_sh),
                opacities=opac.reshape(b, vs * h * w),
            )
        return EncoderOutput(
            gaussians=gaussians, pairwise_poses=rel_poses, sync_poses=sync_abspose,
            refined_poses=refined, depths=depth, xyz=xyz, correspondences=corr,
            pair_confidences=confs,
        )
