"""UniDepth-V2 decoder layer primitives (port of
`pf3plat_tpu/models/backbones/unidepth_layers.py`).

Modules carry the released UniDepth state-dict names (`norm`, `proj1`,
`kv`, `q`, `ls1.gamma`, `dwconv`, `up.1`, `residual.0`, `input_adapters.i`)
so a released checkpoint loads directly; `weights.py` maps the JAX tree
onto them. Numerics follow the JAX modules: LayerNorm epsilon 1e-6, exact
(erf) GELU, plain float32 attention, torch-exact resampling.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import plain_attention

LN_EPS = 1e-6


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over the -2 axis (float32 on the CPU).
    The JAX package's `_sdpa` (`unidepth_layers.py:263`) is a plain einsum
    that never reaches its TPU flash kernel, so on the card this stays the
    library's attention (one head of dim 512 in the depth head)."""
    return plain_attention(q, k, v)


def resize_nhwc(x: torch.Tensor, hw, mode="bilinear", align_corners=False,
                antialias=False) -> torch.Tensor:
    """torch `F.interpolate` on NHWC input (the resampling the JAX package
    reproduces with `interp_matrix`)."""
    if tuple(x.shape[1:3]) == tuple(hw) and not align_corners:
        return x
    kw = dict(align_corners=align_corners) if mode in ("bilinear", "bicubic") else {}
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode=mode,
                      antialias=antialias, **kw)
    return y.permute(0, 2, 3, 1)


def flat_interpolate(x, old, new, antialias: bool = True):
    """(b, old_h*old_w, c) -> (b, new_h*new_w, c) bilinear token resample."""
    if tuple(old) == tuple(new):
        return x
    b, _, c = x.shape
    img = resize_nhwc(x.reshape(b, old[0], old[1], c), new, antialias=antialias)
    return img.reshape(b, new[0] * new[1], c)


def generate_rays(intrinsics: torch.Tensor, image_shape) -> torch.Tensor:
    """Pixel-center unit rays for pixel-unit K -> (b, h*w, 3)."""
    h, w = image_shape
    dev, dt = intrinsics.device, intrinsics.dtype
    ys = torch.arange(h, dtype=dt, device=dev) + 0.5
    xs = torch.arange(w, dtype=dt, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px = gx.reshape(-1)[None]
    py = gy.reshape(-1)[None]
    dx = (px - intrinsics[:, 0, 2:3]) / intrinsics[:, 0, 0:1]
    dy = (py - intrinsics[:, 1, 2:3]) / intrinsics[:, 1, 1:2]
    d = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


def generate_fourier_features(x, dim: int, max_freq: int) -> torch.Tensor:
    """use_log=True, cat_orig=True variant."""
    nb = dim // x.shape[-1]
    scales = 2.0 ** torch.linspace(0.0, math.log2(max_freq), nb, device=x.device, dtype=x.dtype)
    ang = x[..., None] * scales * math.pi
    return torch.cat([torch.sin(ang).flatten(-2), x], dim=-1)


def position_embedding_sine(b: int, h: int, w: int, num_pos_feats: int, device=None):
    """Normalized sine embedding, token-flat (b, h*w, 2*num_pos_feats)."""
    scale = 2 * math.pi
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], dim=3).reshape(h, w, -1)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], dim=3).reshape(h, w, -1)
    pos = torch.cat([py, px], dim=-1).reshape(1, h * w, -1)
    return pos.expand(b, h * w, pos.shape[-1])


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class MLP(nn.Module):
    """LayerNorm -> Linear -> GELU -> Linear."""

    def __init__(self, dim: int, expansion: int = 4, output_dim: int | None = None):
        super().__init__()
        hidden = int(dim * expansion)
        self.norm = _ln(dim)
        self.proj1 = nn.Linear(dim, hidden)
        self.proj2 = nn.Linear(hidden, output_dim or dim)

    def forward(self, x):
        return self.proj2(F.gelu(self.proj1(self.norm(x))))


class AttentionBlock(nn.Module):
    """Token attention (heads on -3); `nystrom=True` reproduces the released
    NystromBlock, whose attention runs across each token's heads."""

    def __init__(self, dim: int, num_heads: int = 4, expansion: int = 4,
                 context_dim: int | None = None, nystrom: bool = False):
        super().__init__()
        cd = context_dim or dim
        self.num_heads, self.dim, self.nystrom = num_heads, dim, nystrom
        self.norm_attnx = _ln(dim)
        self.norm_attnctx = _ln(cd)
        self.kv = nn.Linear(cd, 2 * dim)
        self.q = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.ls1 = LayerScale(dim)
        self.ls2 = LayerScale(dim)
        self.mlp = MLP(dim, expansion)

    def forward(self, x, context=None, pos_embed=None, pos_embed_context=None):
        h, d = self.num_heads, self.dim
        ctx = x if context is None else context
        y = self.norm_attnx(x)
        c = self.norm_attnctx(ctx)
        b, n, _ = c.shape
        kv = self.kv(c).reshape(b, n, 2, h, d // h)
        k, v = kv[:, :, 0], kv[:, :, 1]
        q = self.q(y).reshape(b, y.shape[1], h, d // h)
        if pos_embed is not None:
            q = q + pos_embed.reshape(b, y.shape[1], h, d // h)
        if pos_embed_context is not None:
            k = k + pos_embed_context.reshape(b, n, h, d // h)
        if self.nystrom:
            o = sdpa(q, k, v)
        else:
            o = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
        x = x + self.ls1(self.out(o.reshape(b, y.shape[1], d)))
        return x + self.ls2(self.mlp(x))


class CvnxtBlock(nn.Module):
    """ConvNeXt block on NCHW input."""

    def __init__(self, dim: int, kernel_size: int = 7, expansion: int = 4):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim)
        self.norm = _ln(dim)
        self.pwconv1 = nn.Linear(dim, expansion * dim)
        self.pwconv2 = nn.Linear(expansion * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y)))) * self.gamma
        return x + y.permute(0, 3, 1, 2)


class ConvUpsampleShuffleResidual(nn.Module):
    """2x CvnxtBlock -> [PixelShuffle, dw 7x7, ReLU, 3x3 c/4 -> c/2] +
    residual [1x1 c -> c/2, bilinear 2x align-corners]. NCHW in, token-flat
    (b, 4hw, c/2) out."""

    def __init__(self, dim: int, expansion: int = 4, kernel_size: int = 7, num_layers: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            [CvnxtBlock(dim, kernel_size, expansion) for _ in range(num_layers)])
        self.up = nn.Sequential(
            nn.PixelShuffle(2),
            nn.Conv2d(dim // 4, dim // 4, 7, padding=3, groups=dim // 4),
            nn.ReLU(),
            nn.Conv2d(dim // 4, dim // 2, 3, padding=1),
        )
        self.residual = nn.Sequential(
            nn.Conv2d(dim, dim // 2, 1), nn.UpsamplingBilinear2d(scale_factor=2))

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return (self.up(x) + self.residual(x)).flatten(2).transpose(1, 2)


class ListAdapter(nn.Module):
    """Per-input LayerNorm -> Linear -> GELU."""

    def __init__(self, input_dims, hidden_dim: int):
        super().__init__()
        self.input_adapters = nn.ModuleList([
            nn.Sequential(_ln(d), nn.Linear(d, hidden_dim), nn.GELU()) for d in input_dims
        ])

    def forward(self, xs):
        return [a(x) for a, x in zip(self.input_adapters, xs)]
