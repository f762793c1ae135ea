"""DINOv2 ViT, the frozen backbone inside UniDepth-V2 (port of
`pf3plat_tpu/models/backbones/dinov2.py`), with the released state-dict
names (`patch_embed.proj`, `blocks.i.{norm1,attn.qkv,attn.proj,ls1.gamma,
norm2,mlp.fc1,mlp.fc2,ls2.gamma}`, `norm`, `cls_token`, `pos_embed`,
`register_tokens`).

VGGT's patch embedding is the same network with registers
(`dinov2_vitl14_reg`): `num_register_tokens` tokens placed after the cls
token once the position table is added, and the table resized with
antialiasing (`interpolate_antialias`). The defaults (no registers, no
antialiasing) are UniDepth's."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import attention
from .unidepth_layers import LayerScale


@dataclasses.dataclass(frozen=True)
class ViTCfg:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: float = 1.0
    pos_embed_size: int = 37
    use_norm: bool = True
    num_register_tokens: int = 0
    interpolate_antialias: bool = False

    @staticmethod
    def vit_large() -> "ViTCfg":
        return ViTCfg()

    @staticmethod
    def tiny_test() -> "ViTCfg":
        return ViTCfg(patch_size=14, embed_dim=64, depth=4, num_heads=4, pos_embed_size=8)


class _Attn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, cfg: ViTCfg):
        super().__init__()
        d = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.attn = _Attn(d)
        self.ls1 = LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio))
        self.ls2 = LayerScale(d)
        for ls in (self.ls1, self.ls2):
            nn.init.constant_(ls.gamma, cfg.layerscale_init)

    def forward(self, x):
        b, n, d = x.shape
        h = self.num_heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(b, n, 3, h, d // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        x = x + self.ls1(self.attn.proj(out))
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + self.ls2(y)


class _PatchEmbed(nn.Module):
    def __init__(self, p: int, d: int):
        super().__init__()
        self.proj = nn.Conv2d(3, d, p, stride=p)


class DINOv2(nn.Module):
    """For each layer index in `out_layers`: patch tokens (b, hp, wp, dim)
    and cls token (b, 1, dim), after the final LayerNorm when `use_norm`;
    the register tokens, between the two, are in neither."""

    def __init__(self, cfg: ViTCfg, out_layers: Sequence[int] = (11, 23)):
        super().__init__()
        self.cfg = cfg
        self.out_layers = tuple(out_layers)
        d = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.randn(1, cfg.pos_embed_size**2 + 1, d) * 0.02)
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, d)) if cfg.num_register_tokens else None
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(d, eps=1e-6) if cfg.use_norm else None

    def forward(self, image: torch.Tensor):
        """image (b, h, w, 3), h and w divisible by the patch size."""
        c = self.cfg
        b, h, w, _ = image.shape
        hp, wp = h // c.patch_size, w // c.patch_size
        x = self.patch_embed.proj(image.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        pos = self.pos_embed
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        if (hp, wp) != (c.pos_embed_size, c.pos_embed_size):
            grid = patch_pos.reshape(1, c.pos_embed_size, c.pos_embed_size, -1)
            grid = F.interpolate(grid.permute(0, 3, 1, 2).float(), size=(hp, wp),
                                 mode="bicubic", align_corners=False,
                                 antialias=c.interpolate_antialias)
            patch_pos = grid.permute(0, 2, 3, 1).reshape(1, hp * wp, -1).to(x.dtype)
        x = x + patch_pos
        cls_tok = (self.cls_token + cls_pos).expand(b, 1, -1).to(x.dtype)
        special = [cls_tok]
        if self.register_tokens is not None:
            special.append(self.register_tokens.expand(b, -1, -1).to(x.dtype))
        x = torch.cat([*special, x], dim=1)
        first = x.shape[1] - hp * wp  # the first patch token
        patch_taps, cls_taps = [], []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.out_layers:
                out = self.norm(x) if self.norm is not None else x
                cls_taps.append(out[:, :1])
                patch_taps.append(out[:, first:].reshape(b, hp, wp, -1))
        return patch_taps, cls_taps
