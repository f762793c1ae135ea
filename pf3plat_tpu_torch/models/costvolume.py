"""Plane-sweep cost-volume depth predictor (NHWC), port of
`pf3plat_tpu/models/costvolume.py`."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..geometry.projection import se3_inverse
from .layers import gelu
from .nhwc import Conv, GroupNorm, resize_bilinear, resize_nearest
from .unet import Named, UNetModel


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample NHWC `img` at fractional pixel coords (align-corners grid,
    zero padding per tap). img (b, h, w, c); x, y (b, n) -> (b, n, c)."""
    b, h, w, c = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = img.reshape(b * h * w, c)
    off = (torch.arange(b, device=img.device) * (h * w))[:, None]

    def tap(yy, xx):
        inb = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
        yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
        vals = flat[(yi * w + xi + off).reshape(-1)].reshape(*xx.shape, c)
        return torch.where(inb[..., None], vals, torch.zeros_like(vals))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def warp_with_pose_depth_candidates(feature, intrinsics, pose, depth, clamp_min_depth=1e-3):
    """Plane-sweep warp: (b, h, w, c) source features sampled at the
    reprojection of each target pixel under each depth candidate
    -> (b, d, h, w, c). `intrinsics` in pixels, `pose` target->source."""
    b, h, w, c = feature.shape
    d = depth.shape[1]
    dev, dt = feature.device, feature.dtype
    gy, gx = torch.meshgrid(torch.arange(h, device=dev, dtype=dt),
                            torch.arange(w, device=dev, dtype=dt), indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    k_inv = torch.linalg.inv(intrinsics)
    rays = torch.einsum("bij,nj->bni", k_inv, grid)
    rot = torch.einsum("bij,bnj->bni", pose[:, :3, :3], rays)
    pts = rot[:, None] * depth[:, :, None, None] + pose[:, None, None, :3, 3]
    proj = torch.einsum("bij,bdnj->bdni", intrinsics, pts)
    z = torch.clamp(proj[..., 2], min=clamp_min_depth)
    px = (proj[..., 0] / z).reshape(b, d * h * w)
    py = (proj[..., 1] / z).reshape(b, d * h * w)
    return bilinear_sample(feature, px, py).reshape(b, d, h, w, c)


@dataclasses.dataclass(frozen=True)
class DepthPredictorCfg:
    feature_channels: int = 256
    num_depth_candidates: int = 128
    costvolume_unet_feat_dim: int = 128
    costvolume_unet_channel_mult: Sequence[int] = (1, 1, 1)
    costvolume_unet_attn_res: Sequence[int] = (4,)
    gaussian_raw_channels: int = 84
    gaussians_per_pixel: int = 1
    num_views: int = 2
    depth_unet_feat_dim: int = 32
    depth_unet_attn_res: Sequence[int] = (16,)
    depth_unet_channel_mult: Sequence[int] = (1, 1, 1, 1, 1)
    # Depth candidates warped per step (bounds the warped-feature buffer).
    costvolume_scan_chunk: int = 16


class DepthPredictorMultiView(Named):
    """(v b) layout throughout, like the JAX module."""

    def __init__(self, cfg: DepthPredictorCfg):
        super().__init__()
        self.cfg = cfg
        c = cfg.feature_channels
        d = cfg.num_depth_candidates
        cv = cfg.costvolume_unet_feat_dim
        du = cfg.depth_unet_feat_dim
        gpp = cfg.gaussians_per_pixel
        k = self.keep
        k("cv_in", "Conv", Conv(d + c, cv, 3))
        k("cv_gn", "GroupNorm", GroupNorm(8, cv))
        k("cv_unet", "UNetModel", UNetModel(
            cv, cv, cv, attention_resolutions=cfg.costvolume_unet_attn_res,
            channel_mult=cfg.costvolume_unet_channel_mult, num_views=cfg.num_views))
        k("cv_out", "Conv", Conv(cv, d, 3))
        k("cv_skip", "Conv", Conv(d + c, d, 1))
        k("mono0", "Conv", Conv(d, d, 3, stride=2))
        k("mono1", "Conv", Conv(d, d, 3, stride=2))
        k("multi0", "Conv", Conv(d, d, 3))
        k("multi1", "Conv", Conv(d, d, 3))
        k("att_q", "Conv", Conv(d, d, 1))
        k("att_k", "Conv", Conv(d, d, 1))
        k("att_v", "Conv", Conv(d, d, 1))
        k("multi_res", "Conv", Conv(d, d, 1))
        self.gamma = nn.Parameter(torch.zeros(1))
        k("pdf0", "Conv", Conv(d, 2 * d, 3))
        k("pdf1", "Conv", Conv(2 * d, d, 3))
        k("up", "Conv", Conv(c, c, 3))
        k("proj", "Conv", Conv(c, du, 3))
        k("refine_in", "Conv", Conv(3 + du + 1 + 1, du, 3))
        k("refine_gn", "GroupNorm", GroupNorm(4, du))
        k("refine_unet", "UNetModel", UNetModel(
            du, du, du, attention_resolutions=cfg.depth_unet_attn_res,
            channel_mult=cfg.depth_unet_channel_mult, num_views=cfg.num_views))
        raw = cfg.gaussian_raw_channels
        k("g0", "Conv", Conv(du + 3 + c, raw * 2, 3))
        k("g1", "Conv", Conv(raw * 2, raw, 3))
        k("d0", "Conv", Conv(du + 1 + c, du * 2, 3))
        k("d1", "Conv", Conv(du * 2, gpp * 2, 3))

    def forward(self, features, intrinsics, extrinsics, near, far, images,
                disparity, monocular_cue):
        """features (b, v, h4, w4, c); intrinsics normalized (b, v, 3, 3);
        extrinsics w2c (b, v, 4, 4); near/far (b, v); images (vb, h, w, 3);
        disparity (vb, h, w, 1); monocular_cue (vb, h4, w4, d)."""
        cfg = self.cfg
        b, v, h4, w4, c = features.shape
        d = cfg.num_depth_candidates
        h, w = images.shape[1], images.shape[2]
        dev, dt = features.device, features.dtype

        feat_vb = features.transpose(0, 1).reshape(v * b, h4, w4, c)
        intr_pix = intrinsics.clone()
        intr_pix[..., 0, :] = intr_pix[..., 0, :] * w4
        intr_pix[..., 1, :] = intr_pix[..., 1, :] * h4
        intr_vb = intr_pix.transpose(0, 1).reshape(v * b, 3, 3)

        inv_near = 1.0 / near
        inv_far = 1.0 / far
        lin = torch.linspace(0.0, 1.0, d, device=dev, dtype=dt)
        disp_candi = (
            inv_far.transpose(0, 1).reshape(v * b, 1)
            + lin[None, :] * (inv_near - inv_far).transpose(0, 1).reshape(v * b, 1)
        )
        depth_candi = 1.0 / disp_candi

        corr_sum = torch.zeros((v * b, d, h4, w4), device=dev, dtype=dt)
        c2w = se3_inverse(extrinsics)
        dc = cfg.costvolume_scan_chunk if d % cfg.costvolume_scan_chunk == 0 else d
        for shift in range(1, v):
            order = [(i + shift) % v for i in range(v)]
            feat_other = features[:, order].transpose(0, 1).reshape(v * b, h4, w4, c)
            rel = torch.matmul(extrinsics[:, order], c2w)
            rel_vb = rel.transpose(0, 1).reshape(v * b, 4, 4)
            parts = []
            for s in range(0, d, dc):
                warped = warp_with_pose_depth_candidates(
                    feat_other, intr_vb, rel_vb, depth_candi[:, s : s + dc])
                parts.append((feat_vb[:, None] * warped).sum(-1) / (c**0.5))
            corr_sum = corr_sum + torch.cat(parts, dim=1)
        raw_in = torch.cat([(corr_sum / (v - 1)).permute(0, 2, 3, 1), feat_vb], dim=-1)

        x = gelu(self.cv_gn(self.cv_in(raw_in)))
        x = self.cv_unet(x)
        raw_corr = self.cv_out(x) + self.cv_skip(raw_in)

        mono = gelu(self.mono1(gelu(self.mono0(monocular_cue))))
        multi = gelu(self.multi1(gelu(self.multi0(raw_corr))))
        hd, wd = mono.shape[1], mono.shape[2]
        multi_ds = resize_bilinear(multi, (hd, wd))
        q = self.att_q(mono).reshape(v * b, hd * wd, d)
        kk = self.att_k(mono).reshape(v * b, hd * wd, d)
        val = self.att_v(multi_ds).reshape(v * b, hd * wd, d)
        attn = torch.softmax(torch.matmul(q, kk.transpose(1, 2)), dim=-1)
        fused = torch.matmul(attn, val).reshape(v * b, hd, wd, d)
        fused = resize_nearest(fused, (h4, w4))
        fused_cv = gelu(self.multi_res(raw_corr)) + self.gamma * fused

        pdf = torch.softmax(self.pdf1(gelu(self.pdf0(fused_cv))), dim=-1)
        pdf_max = resize_nearest(pdf.amax(dim=-1, keepdim=True), (h, w))

        up = resize_bilinear(self.up(feat_vb), (h, w))
        proj_full = gelu(up)
        proj_feature = self.proj(proj_full)
        r = torch.cat([images, proj_feature, disparity, pdf_max], dim=-1)
        r = gelu(self.refine_gn(self.refine_in(r)))
        refine_out = self.refine_unet(r)

        g = gelu(self.g0(torch.cat([refine_out, images, proj_full], dim=-1)))
        raw_gaussians = self.g1(g).reshape(v, b, h * w, cfg.gaussian_raw_channels)
        raw_gaussians = raw_gaussians.transpose(0, 1)
        dd = gelu(self.d0(torch.cat([refine_out, disparity, proj_full], dim=-1)))
        delta = self.d1(dd)
        densities = torch.sigmoid(delta[..., cfg.gaussians_per_pixel:])
        densities = densities.reshape(v, b, h * w, cfg.gaussians_per_pixel).transpose(0, 1)
        return densities, raw_gaussians
