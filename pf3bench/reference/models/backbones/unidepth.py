"""UniDepth-V2 metric monocular depth (port of
`pf3plat_tpu/models/backbones/unidepth.py`).

Module tree = the released checkpoint's (`pixel_encoder.*` is the DINOv2
backbone, `pixel_decoder.*` the decoder with `camera_layer`,
`global_layer`, `depth_layer`, adapters and level embeddings), so released
weights load by name. Behaviour follows the JAX module: inference
resolution from `pixels_bounds` (a 256x256 input runs the ViT at 686x686),
the x255 intrinsics un-normalization, taps at `output_idx`, NystromBlock
attention over the heads axis, log-space normalization + softplus.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dinov2 import DINOv2, ViTCfg
from .unidepth_layers import (
    MLP,
    AttentionBlock,
    ConvUpsampleShuffleResidual,
    ListAdapter,
    flat_interpolate,
    generate_fourier_features,
    generate_rays,
    position_embedding_sine,
    resize_nhwc,
)


class DepthOutput(NamedTuple):
    depth: torch.Tensor       # (b, h, w) metric depth
    confidence: torch.Tensor  # (b, h, w)
    intrinsics: torch.Tensor  # (b, 3, 3) normalized
    features: torch.Tensor    # (b, hp, wp, 2 * embed_dim)


@dataclasses.dataclass(frozen=True)
class UniDepthCfg:
    vit: ViTCfg = ViTCfg.vit_large()
    hidden_dim: int = 512
    num_heads: int = 8
    expansion: int = 4
    camera_dim: int = 96
    depths: tuple[int, ...] = (6, 0, 0)
    output_idx: tuple[int, ...] = (5, 12, 18, 24)
    pixels_bounds: tuple[int, int] = (2400, 2400)
    intrinsics_unnorm_scale: float = 255.0

    @staticmethod
    def tiny_test() -> "UniDepthCfg":
        return UniDepthCfg(
            vit=ViTCfg.tiny_test(), hidden_dim=64, num_heads=8, expansion=2,
            camera_dim=24, depths=(1, 1), output_idx=(1, 2), pixels_bounds=(9, 9),
        )

    @property
    def num_resolutions(self) -> int:
        return len(self.output_idx)


def infer_shapes(image_shape, pixels_bounds, patch: int):
    """Internal inference resolution (multiple of the patch) + focal ratio."""
    h, w = image_shape
    ratio = w / h
    num_pixels = (h / patch) * (w / patch)
    num_pixels = max(min(num_pixels, pixels_bounds[1]), pixels_bounds[0])
    hp = math.ceil((num_pixels / ratio) ** 0.5 - 0.5)
    wp = math.ceil(hp * ratio - 0.5)
    return (hp * patch, wp * patch), hp / h * patch


def _embed_rays(rays, original_shapes, shapes, camera_dim):
    r = flat_interpolate(rays, original_shapes, shapes, antialias=True)
    r = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)
    return generate_fourier_features(r, camera_dim, max(shapes) // 2)


class CameraHead(nn.Module):
    def __init__(self, d: int, expansion: int):
        super().__init__()
        self.aggregate1 = AttentionBlock(d, 1, expansion)
        self.aggregate2 = AttentionBlock(d, 1, expansion)
        self.latents_pos = nn.Parameter(torch.randn(1, 4, d))
        self.in_features = MLP(d, 2)
        self.project_cls = MLP(d, 4)
        self.out = MLP(d, 2, output_dim=1)

    def forward(self, feats, cls_tokens, pos_embed):
        cls_tokens = self.project_cls(cls_tokens)
        lp = self.latents_pos.expand(cls_tokens.shape[0], -1, -1)
        f = self.in_features(torch.cat(feats, 1) + pos_embed)
        ctx = torch.cat([f, cls_tokens], 1)
        x = self.aggregate1(cls_tokens, context=ctx, pos_embed=lp)
        x = self.aggregate2(x, context=ctx, pos_embed=lp)
        x = self.out(x)[..., 0]
        k = torch.zeros(x.shape[0], 3, 3, dtype=x.dtype, device=x.device)
        k[:, 0, 0] = x[:, 0].exp()
        k[:, 1, 1] = x[:, 1].exp()
        k[:, 0, 2] = x[:, 2].sigmoid()
        k[:, 1, 2] = x[:, 3].sigmoid()
        k[:, 2, 2] = 1.0
        return k


class GlobalHead(nn.Module):
    def __init__(self, d: int, camera_dim: int, expansion: int):
        super().__init__()
        self.camera_dim = camera_dim
        self.in_features = nn.Linear(d, d)
        self.project_rays = nn.Linear(camera_dim + 3, d)
        self.aggregate1 = AttentionBlock(d, 1, expansion)
        self.aggregate2 = AttentionBlock(d, 1, expansion)
        self.project_cls = MLP(d, 4)
        self.out = MLP(d, 2, output_dim=1)

    def forward(self, feats, cls_tokens, rays, original_shapes, shapes):
        cls_tokens = self.project_cls(cls_tokens)
        emb = self.project_rays(_embed_rays(rays, original_shapes, shapes, self.camera_dim))
        emb = emb.repeat(1, len(feats), 1)
        f = self.in_features(torch.cat(feats, 1) + emb)
        ctx = torch.cat([f, cls_tokens], 1)
        x = self.aggregate1(cls_tokens, context=ctx)
        x = self.aggregate2(x, context=ctx)
        x = self.out(x)[..., 0]
        return x[:, 0].exp()[:, None, None], x[:, 1][:, None, None]


class DepthHead(nn.Module):
    def __init__(self, d, heads, expansion, depths, camera_dim, num_res):
        super().__init__()
        self.camera_dim = camera_dim
        self.to_latents = MLP(d, 2)
        self.features_channel_cat = nn.Linear(d * num_res, d)
        self.aggregate_16 = AttentionBlock(d, 1, expansion, context_dim=d)
        self.prompt_camera = AttentionBlock(d, 1, expansion, context_dim=d)
        self.process_layers = nn.ModuleList()
        self.rays_layers = nn.ModuleList()
        self.ups = nn.ModuleList()
        self.depth_mlp = nn.ModuleList()
        self.confidence_mlp = nn.ModuleList()
        for i, nb in enumerate(depths):
            di = d // 2**i
            self.process_layers.append(nn.ModuleList([
                AttentionBlock(di, max(heads // 2**i, 1), expansion, nystrom=True)
                for _ in range(nb)
            ]))
            self.rays_layers.append(nn.Linear(camera_dim + 3, di))
            self.ups.append(ConvUpsampleShuffleResidual(di, expansion))
            self.depth_mlp.append(MLP(di // 2, 1, output_dim=16))
            self.confidence_mlp.append(MLP(di // 2, 1, output_dim=16))
        self.to_depth = nn.Conv2d(16 * len(depths), 1, 7, padding=3, padding_mode="reflect")
        self.to_confidence = nn.Conv2d(16 * len(depths), 1, 7, padding=3, padding_mode="reflect")

    def forward(self, feats, rays_hr, pos_embed, level_embed, original_shapes, shapes):
        b = feats[0].shape[0]
        embs = [
            layer(_embed_rays(rays_hr, original_shapes,
                              (shapes[0] * 2**i, shapes[1] * 2**i), self.camera_dim))
            for i, layer in enumerate(self.rays_layers)
        ]
        f16 = self.features_channel_cat(torch.cat(feats, dim=-1))
        latents = f16 + self.to_latents(f16)
        latents = self.aggregate_16(latents, context=torch.cat(feats, 1),
                                    pos_embed_context=pos_embed + level_embed)
        latents = self.prompt_camera(latents, context=embs[0])
        outs = []
        for i, (up, layers, emb) in enumerate(zip(self.ups, self.process_layers, embs)):
            for layer in layers:
                latents = layer(latents, pos_embed=emb)
            sh = (shapes[0] * 2**i, shapes[1] * 2**i)
            img = (latents + emb).transpose(1, 2).reshape(b, -1, *sh)
            latents = up(img)
            outs.append(latents.reshape(b, sh[0] * 2, sh[1] * 2, -1))

        def fuse(mlps, conv):
            taps = [
                resize_nhwc(mlp(o), original_shapes).permute(0, 3, 1, 2)
                for mlp, o in zip(list(mlps)[::-1], outs[::-1])
            ]
            return conv(torch.cat(taps, 1))[:, 0]

        logdepth = fuse(self.depth_mlp, self.to_depth)
        conf = torch.sigmoid(fuse(self.confidence_mlp, self.to_confidence))
        return logdepth, conf


class Decoder(nn.Module):
    """UniDepth-V2 decoder (ViT encoder path: all level shapes equal)."""

    def __init__(self, cfg: UniDepthCfg):
        super().__init__()
        e, d, r = cfg.vit.embed_dim, cfg.hidden_dim, cfg.num_resolutions
        self.cfg = cfg
        self.camera_layer = CameraHead(d, cfg.expansion)
        self.global_layer = GlobalHead(d, cfg.camera_dim, cfg.expansion)
        self.input_adapter = ListAdapter((e,) * r, d)
        self.camera_token_adapter = ListAdapter((e,) * 4, d)
        self.global_token_adapter = ListAdapter((e,) * 2, d)
        self.depth_layer = DepthHead(d, cfg.num_heads, cfg.expansion, cfg.depths,
                                     cfg.camera_dim, r)
        self.level_embeds = nn.Parameter(torch.randn(r, d))
        self.level_embed_layer = nn.Sequential(
            nn.Linear(d, d), nn.GELU(), nn.Linear(d, d), nn.LayerNorm(d, eps=1e-6))

    def forward(self, feats, camera_tokens, global_tokens, image_shape, shapes, rays_gt):
        d, r = self.cfg.hidden_dim, self.cfg.num_resolutions
        hh, ww = image_shape
        feats = self.input_adapter(feats)
        b, n = feats[0].shape[0], shapes[0] * shapes[1]
        le = self.level_embed_layer(self.level_embeds)
        level_embed = torch.cat([le[i : i + 1][None].expand(b, n, d) for i in range(r)], 1)
        pos = position_embedding_sine(b, shapes[0], shapes[1], d // 2, feats[0].device)
        pos = pos.to(feats[0].dtype).repeat(1, r, 1)
        k_px = None
        if rays_gt is None:
            cam_tok = torch.cat(self.camera_token_adapter(camera_tokens), 1)
            k = self.camera_layer(feats, cam_tok, pos + level_embed)
            k_px = torch.zeros_like(k)
            k_px[:, 0, 0] = k[:, 0, 0] * (max(hh, ww) / 2)
            k_px[:, 1, 1] = k[:, 1, 1] * (max(hh, ww) / 2)
            k_px[:, 0, 2] = k[:, 0, 2] * ww
            k_px[:, 1, 2] = k[:, 1, 2] * hh
            k_px[:, 2, 2] = 1.0
            rays = generate_rays(k_px, image_shape)
        else:
            # The predicted camera is unused when rays are given (the JAX
            # graph computes and discards it); skip it.
            rays = rays_gt
        glob_tok = torch.cat(self.global_token_adapter(global_tokens), 1)
        scale, shift = self.global_layer(feats, glob_tok, rays, image_shape, shapes)
        logdepth, conf = self.depth_layer(feats, rays, pos, level_embed, image_shape, shapes)
        logdepth, conf = logdepth.float(), conf.float()  # reductions in float32
        mean = logdepth.mean(dim=(1, 2), keepdim=True)
        var = logdepth.var(dim=(1, 2), unbiased=False, keepdim=True)
        dn = torch.exp((logdepth - mean) / torch.sqrt(var + 1e-5))
        depth = F.softplus((dn + shift) * scale * 10.0) / 10.0
        return depth, conf, k_px


class UniDepth(nn.Module):
    """`UniDepthV2.infer`: images (b, h, w, 3) in [0, 1], normalized
    intrinsics or None."""

    def __init__(self, cfg: UniDepthCfg = UniDepthCfg()):
        super().__init__()
        self.cfg = cfg
        c = cfg
        feat_layers = [oi - 1 for oi in c.output_idx]
        d = c.vit.depth
        cam_layers = [d - 3, d - 2, d - 1, c.output_idx[-2] - 1]
        glob_layers = [d - 2, d - 1]
        self.feat_layers, self.cam_layers, self.glob_layers = feat_layers, cam_layers, glob_layers
        self.need = sorted(set(feat_layers + cam_layers + glob_layers))
        self.pixel_encoder = DINOv2(c.vit, out_layers=tuple(self.need))
        self.pixel_decoder = Decoder(c)

    def forward(self, image: torch.Tensor, intrinsics: Optional[torch.Tensor] = None) -> DepthOutput:
        c = self.cfg
        b, h, w, _ = image.shape
        p = c.vit.patch_size
        (hi, wi), ratio = infer_shapes((h, w), c.pixels_bounds, p)
        shapes = (hi // p, wi // p)
        mean = torch.tensor([0.485, 0.456, 0.406], dtype=image.dtype, device=image.device)
        std = torch.tensor([0.229, 0.224, 0.225], dtype=image.dtype, device=image.device)
        x = resize_nhwc((image - mean) / std, (hi, wi), antialias=True)
        patch_taps, cls_taps = self.pixel_encoder(x)
        by_p = dict(zip(self.need, patch_taps))
        by_c = dict(zip(self.need, cls_taps))
        feats = [by_p[l].reshape(b, shapes[0] * shapes[1], -1) for l in self.feat_layers]
        rays_gt = None
        if intrinsics is not None:
            k_px = intrinsics.clone()
            k_px[:, :2, :] = k_px[:, :2, :] * (c.intrinsics_unnorm_scale * ratio)
            rays_gt = generate_rays(k_px, (hi, wi))
        depth, conf, k_pred = self.pixel_decoder(
            feats, [by_c[l] for l in self.cam_layers], [by_c[l] for l in self.glob_layers],
            (hi, wi), shapes, rays_gt)
        depth = resize_nhwc(depth[..., None], (h, w))[..., 0]
        conf = resize_nhwc(conf[..., None], (h, w), antialias=True)[..., 0]
        if intrinsics is not None:
            k_out = intrinsics
        else:
            k_out = k_pred.clone()
            k_out[:, :2, :] = k_out[:, :2, :] / (c.intrinsics_unnorm_scale * ratio)
        f0 = by_p[self.feat_layers[0]]
        f1 = by_p[self.feat_layers[1]]
        return DepthOutput(depth=depth, confidence=conf, intrinsics=k_out,
                           features=torch.cat([f0, f1], dim=-1))
