"""Shared transformer building blocks (port of `pf3plat_tpu/models/layers.py`).

Parameter names follow the Flax modules (`Dense_0`, `LayerNorm_0`, ...) so
`weights.py` maps a JAX parameter tree onto these modules by name, except
`SelfBlock` / `CrossBlock` / `LearnableFourierPositionalEncoding`, which
carry the released LightGlue state-dict names (`Wqkv`, `out_proj`, `ffn.*`,
`to_qk`, `to_v`, `to_out`, `Wr`) because LightGlue reuses them.

Flax defaults kept on purpose: LayerNorm/GroupNorm epsilon 1e-6 and the
tanh-approximate `nn.gelu`.

Attention: on a CUDA tensor every attention goes to
`F.scaled_dot_product_attention`. On the CPU it runs a twin of the JAX
package's `mxu_einsum` (`layers.py:60-66,148-153`): inputs rounded to
bf16, products accumulated in f32, softmax in f32, weights rounded to bf16
before the second product, exactly as the JAX reference computes on every
backend.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu` (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def mxu_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-rounded inputs, f32 accumulation (the JAX `mxu_einsum`)."""
    return torch.matmul(_bf16(a), _bf16(b))


def common_dtype(*xs: torch.Tensor) -> list[torch.Tensor]:
    """Cast attention operands to one dtype: the autocast dtype inside
    autocast, else float32 (SDPA rejects mixed operands)."""
    dev = xs[0].device.type
    dt = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else torch.float32
    return [x.to(dt) for x in xs]


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    prescale: bool = True,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) [masked | + bias]) v over (..., n, d).

    `mask` (bool, True = keep) replaces masked logits by -1e30 like the JAX
    code; `bias` is added to the logits. `prescale` picks where the JAX call
    site applies 1/sqrt(d): to q before the bf16 product (True, as
    `scaled_dot_attention`) or to the product (False, as the swin windows).
    """
    d = q.shape[-1]
    scale = d**-0.5
    if q.device.type == "cuda":
        add = bias
        if mask is not None:
            neg = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
            neg.masked_fill_(~mask, -1e30)
            add = neg if add is None else add + neg
        q, k, v = common_dtype(q, k, v)
        if add is not None:
            add = add.to(q.dtype)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=add)
    if prescale:
        sim = mxu_matmul(q * scale, k.transpose(-1, -2))
    else:
        sim = mxu_matmul(q, k.transpose(-1, -2)) / d**0.5
    if mask is not None:
        sim = torch.where(mask, sim, torch.full_like(sim, -1e30))
    if bias is not None:
        sim = sim + bias
    attn = torch.softmax(sim.float(), dim=-1)
    return mxu_matmul(attn, v)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


def apply_rotary_emb(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """freqs: (2, ..., dim) stacked (cos, sin); t: (..., dim)."""
    return t * freqs[0] + rotate_half(t) * freqs[1]


class LearnableFourierPositionalEncoding(nn.Module):
    """Rotary-style learnable Fourier features (LightGlue `posenc`)."""

    def __init__(self, m: int, dim: int, f_dim: int | None = None):
        super().__init__()
        f_dim = f_dim or dim
        self.Wr = nn.Linear(m, f_dim // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected = self.Wr(x)
        emb = torch.stack([torch.cos(projected), torch.sin(projected)], dim=0)
        return emb.unsqueeze(-3).repeat_interleave(2, dim=-1)


class SelfBlock(nn.Module):
    """LightGlue self-attention block: qkv (+ rotary), gated FFN."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.Wqkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.ffn = nn.Sequential(
            nn.Linear(2 * embed_dim, 2 * embed_dim), layer_norm(2 * embed_dim),
            nn.GELU(approximate="tanh"), nn.Linear(2 * embed_dim, embed_dim),
        )

    def forward(self, x, encoding=None, mask=None):
        d = x.shape[-1]
        h = self.num_heads
        qkv = self.Wqkv(x).unflatten(-1, (h, d // h, 3)).transpose(-3, -4)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        if encoding is not None:
            q = apply_rotary_emb(encoding, q)
            k = apply_rotary_emb(encoding, k)
        context = attention(q, k, v, mask=mask)
        context = context.transpose(-3, -2).flatten(-2)
        message = self.out_proj(context)
        return x + self.ffn(torch.cat([x, message], dim=-1))


class CrossBlock(nn.Module):
    """LightGlue bidirectional cross-attention block (shared qk and ffn)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_qk = nn.Linear(embed_dim, embed_dim)
        self.to_v = nn.Linear(embed_dim, embed_dim)
        self.to_out = nn.Linear(embed_dim, embed_dim)
        self.ffn = nn.Sequential(
            nn.Linear(2 * embed_dim, 2 * embed_dim), layer_norm(2 * embed_dim),
            nn.GELU(approximate="tanh"), nn.Linear(2 * embed_dim, embed_dim),
        )

    def forward(self, x0, x1, mask=None, update_x1: bool = True):
        """`update_x1=False` skips the x1 <- x0 direction (callers that
        discard x1 get x0 unchanged); x1 is then returned as given."""
        h = self.num_heads
        d = x0.shape[-1]
        head = d // h

        def split(t):
            return t.unflatten(-1, (h, head)).transpose(-3, -2)

        qk0, qk1 = split(self.to_qk(x0)), split(self.to_qk(x1))
        v0, v1 = split(self.to_v(x0)), split(self.to_v(x1))
        if x0.device.type == "cuda":
            # SDPA's 1/sqrt(head) equals the JAX (qk0 s^.5)(qk1 s^.5) scaling.
            m0 = attention(qk0, qk1, v1, mask=mask)
            m1 = attention(qk1, qk0, v0, mask=None if mask is None
                           else mask.transpose(-1, -2)) if update_x1 else None
        else:
            s = head**-0.5
            sim = mxu_matmul(qk0 * s**0.5, (qk1 * s**0.5).transpose(-1, -2))
            if mask is not None:
                sim = torch.where(mask, sim, torch.full_like(sim, -1e30))
            m0 = mxu_matmul(torch.softmax(sim, dim=-1), v1)
            m1 = mxu_matmul(torch.softmax(sim.transpose(-1, -2), dim=-1), v0) \
                if update_x1 else None

        def merge(t):
            return t.transpose(-3, -2).flatten(-2)

        x0 = x0 + self.ffn(torch.cat([x0, self.to_out(merge(m0))], dim=-1))
        if update_x1:
            x1 = x1 + self.ffn(torch.cat([x1, self.to_out(merge(m1))], dim=-1))
        return x0, x1


class Mlp(nn.Module):
    """timm-style MLP (Dense_0 -> gelu -> Dense_1)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden_features)
        self.Dense_1 = nn.Linear(hidden_features, out_features)

    def forward(self, x):
        return self.Dense_1(gelu(self.Dense_0(x)))


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


class LoFTREncoderLayer(nn.Module):
    """LoFTR linear-attention layer (ELU kernel)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        d = d_model
        self.nhead = nhead
        self.Dense_0 = nn.Linear(d, d, bias=False)  # q
        self.Dense_1 = nn.Linear(d, d, bias=False)  # k
        self.Dense_2 = nn.Linear(d, d, bias=False)  # v
        self.Dense_3 = nn.Linear(d, d, bias=False)  # merge
        self.LayerNorm_0 = layer_norm(d)
        self.Dense_4 = nn.Linear(2 * d, 2 * d, bias=False)
        self.Dense_5 = nn.Linear(2 * d, d, bias=False)
        self.LayerNorm_1 = layer_norm(d)

    def forward(self, x, source):
        h = self.nhead
        q = self.Dense_0(x).unflatten(-1, (h, -1))
        k = self.Dense_1(source).unflatten(-1, (h, -1))
        v = self.Dense_2(source).unflatten(-1, (h, -1))
        q = elu_feature_map(q)
        k = elu_feature_map(k)
        v_len = v.shape[-3]
        kv = torch.einsum("...shd,...shv->...hdv", k, v / v_len)
        z = 1.0 / (torch.einsum("...lhd,...hd->...lh", q, k.sum(dim=-3)) + 1e-6)
        message = torch.einsum("...lhd,...hdv,...lh->...lhv", q, kv, z) * v_len
        message = self.LayerNorm_0(self.Dense_3(message.flatten(-2)))
        y = self.Dense_5(F.relu(self.Dense_4(torch.cat([x, message], dim=-1))))
        return x + self.LayerNorm_1(y)


class LocalFeatureTransformer(nn.Module):
    """LoFTR self-attention layers over per-view tokens."""

    def __init__(self, d_model: int = 256, nhead: int = 4, num_layers: int = 3):
        super().__init__()
        self.layers = []
        for i in range(num_layers):
            layer = LoFTREncoderLayer(d_model, nhead)
            self.add_module(f"LoFTREncoderLayer_{i}", layer)
            self.layers.append(layer)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x, x)
        return x


def position_embedding_sine(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0) -> torch.Tensor:
    """(h, w, 2*num_pos_feats) sine embedding normalized to 2*pi."""
    y = (np.arange(h, dtype=np.float64) + 1.0) / h * 2 * np.pi
    x = (np.arange(w, dtype=np.float64) + 1.0) / w * 2 * np.pi
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[None, :, None] / dim_t
    pos_y = y[:, None, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])],
                     axis=-1).reshape(1, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])],
                     axis=-1).reshape(h, 1, -1)
    pos = np.concatenate(
        [np.broadcast_to(pos_y, (h, w, num_pos_feats)),
         np.broadcast_to(pos_x, (h, w, num_pos_feats))], axis=-1)
    return torch.as_tensor(pos.astype(np.float32))


def get_2d_sincos_pos_embed(embed_dim: int, grid_h: int, grid_w: int) -> torch.Tensor:
    """(grid_h*grid_w, embed_dim) 2D sincos embedding."""

    def emb_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(grid_w, dtype=np.float64),
                       np.arange(grid_h, dtype=np.float64))
    emb = np.concatenate([emb_1d(embed_dim // 2, grid[0]),
                          emb_1d(embed_dim // 2, grid[1])], axis=1)
    return torch.as_tensor(emb.astype(np.float32))
