"""Shared transformer building blocks (port of `pf3plat_tpu/models/layers.py`).

Parameter names follow the Flax modules (`Dense_0`, `LayerNorm_0`, ...) so
`weights.py` maps a JAX parameter tree onto these modules by name, except
`SelfBlock` / `CrossBlock` / `LearnableFourierPositionalEncoding`, which
carry the released LightGlue state-dict names (`Wqkv`, `out_proj`, `ffn.*`,
`to_qk`, `to_v`, `to_out`, `Wr`) because LightGlue reuses them.

Flax defaults kept on purpose: LayerNorm/GroupNorm epsilon 1e-6 and the
tanh-approximate `nn.gelu`.

Attention: a large unmasked attention (4-D operands, no mask, no bias,
min(n, m) >= 2048: the JAX package's rule for its TPU flash kernel,
`layers.py:135-147`) on CUDA tensors runs the hand-written kernels
`csrc/attention_fwd.cu` / `csrc/attention_bwd.cu` through `FlashAttention`;
every other attention on the card goes to
`F.scaled_dot_product_attention` with bf16 operands (`library_attention`).
On the CPU `attention` runs `mxu_attention`, a twin of the JAX package's
`mxu_einsum` (`layers.py:60-66,148-153`): inputs rounded to bf16, products
accumulated in f32, softmax in f32, weights rounded to bf16 before the
second product, exactly as the JAX reference computes on every backend but
the TPU. `PF3PLAT_FLASH_ATTENTION=0` keeps every attention off the kernels,
as it does in the JAX package. `attention_fwd_plain` /
`attention_bwd_plain` are the kernels' plain versions (the CPU path of
`FlashAttention`, and what the kernels are held against on the card). The
linear attention's two pinned products run in exact float32
(`precision.exact_einsum`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import kernels
from ..precision import bf16_round as _bf16
from ..precision import exact_einsum

LN_EPS = 1e-6
# Attention goes to the hand-written kernels from this many tokens on the
# shorter side (the JAX package's `_FLASH_MIN_TOKENS`).
_FLASH_MIN_TOKENS = 2048
# Head dims the kernels are built for; smaller ones are zero-padded up.
_FLASH_HEAD_DIMS = (32, 64)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu` (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def mxu_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16-rounded inputs, f32 accumulation (the JAX `mxu_einsum`)."""
    return torch.matmul(_bf16(a), _bf16(b))


def common_dtype(*xs: torch.Tensor) -> list[torch.Tensor]:
    """Cast attention operands to one dtype: the autocast dtype inside
    autocast, else float32 (SDPA rejects mixed operands)."""
    dev = xs[0].device.type
    dt = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else torch.float32
    return [x.to(dt) for x in xs]


def _bf16_contiguous(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 in contiguous layout, in one pass over a strided or
    float32 input (the qkv views of a fused projection); x itself when it is
    that already."""
    if x.dtype == torch.bfloat16 and x.is_contiguous():
        return x
    return torch.empty(x.shape, dtype=torch.bfloat16, device=x.device).copy_(x)


def _check_attention_args(tensors, shapes):
    """Validate what the CUDA kernels take: contiguous, 16-byte aligned
    tensors of the given dtype and shape on one CUDA device."""
    dev = tensors[0][1].device
    if dev.type != "cuda":
        raise ValueError("the attention kernels need CUDA tensors")
    for (name, x, dtype), shape in zip(tensors, shapes):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
                or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: want a contiguous, 16-byte aligned {dtype} tensor of "
                             f"shape {tuple(shape)} on {dev}")


def _attention_dims(q, k):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("attention kernels: want (batch, heads, tokens, head_dim) operands")
    b, h, n, d = q.shape
    m = k.shape[2]
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"attention kernels: head dim {d} not in {_FLASH_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError("attention kernels: batch * heads must fit the grid's y dimension")
    return b, h, n, m, d


def attention_fwd_plain(q, k, v, scale: float):
    """Plain PyTorch version of the forward kernel: q, k, v bf16
    (b, h, n | m, d) -> (out f32 (b, h, n, d), lse f32 (b, h, n)), the
    log-sum-exp of the scaled logits per row."""
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(sim, dim=-1)
    p = torch.exp(sim - lse[..., None])
    return torch.matmul(_bf16(p), v.float()), lse


def attention_bwd_plain(q, k, v, out, lse, d_out, scale: float):
    """Plain PyTorch version of the backward kernel: q, k, v, d_out bf16,
    out and lse from the forward -> (dq, dk, dv) f32. The probabilities are
    recomputed from lse; P and dS are rounded to bf16 before their products."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), d_out.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse[..., None])
    delta = (gf * out).sum(dim=-1, keepdim=True)
    ds = _bf16(p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta))
    dv = torch.matmul(_bf16(p).transpose(-1, -2), gf)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = torch.matmul(ds, kf) * scale
    return dq, dk, dv


def attention_fwd_cuda(q, k, v, scale: float):
    """The forward kernel on the card (`csrc/attention_fwd.cu`)."""
    b, h, n, m, d = _attention_dims(q, k)
    _check_attention_args(
        (("q", q, torch.bfloat16), ("k", k, torch.bfloat16), ("v", v, torch.bfloat16)),
        ((b, h, n, d), (b, h, m, d), (b, h, m, d)))
    out = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    kernels.launch("pf3_attention_fwd", q, k, v, out, lse, b * h, n, m, d, scale)
    return out, lse


def attention_bwd_cuda(q, k, v, out, lse, d_out, scale: float):
    """The backward kernel on the card (`csrc/attention_bwd.cu`)."""
    b, h, n, m, d = _attention_dims(q, k)
    bf, f32 = torch.bfloat16, torch.float32
    _check_attention_args(
        (("q", q, bf), ("k", k, bf), ("v", v, bf), ("d_out", d_out, bf), ("out", out, f32),
         ("lse", lse, f32)),
        ((b, h, n, d), (b, h, m, d), (b, h, m, d), (b, h, n, d), (b, h, n, d), (b, h, n)))
    dev = q.device
    delta = torch.empty((b, h, n), dtype=f32, device=dev)
    dq = torch.empty((b, h, n, d), dtype=f32, device=dev)
    dk = torch.empty((b, h, m, d), dtype=f32, device=dev)
    dv = torch.empty((b, h, m, d), dtype=f32, device=dev)
    kernels.launch("pf3_attention_bwd", q, k, v, d_out, out, lse, delta, dq, dk, dv, b * h, n,
                   m, d, scale)
    return dq, dk, dv


def attention_occupancy(d: int) -> dict[str, int]:
    """CTAs per SM that the built attention kernels reach at head dim d
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`): the forward, the
    backward's dk/dv pass and its dq pass. Needs the card."""
    got = {"fwd": kernels.call("pf3_attention_fwd_occupancy", d),
           "bwd_dkdv": kernels.call("pf3_attention_bwd_occupancy", d, 0),
           "bwd_dq": kernels.call("pf3_attention_bwd_occupancy", d, 1)}
    if min(got.values()) < 0:
        raise RuntimeError(f"attention kernels: occupancy query failed at head dim {d}: {got}")
    return got


def attention_fwd(q, k, v, scale: float):
    """The forward kernel for CUDA tensors, its plain version for CPU tensors."""
    fn = attention_fwd_plain if q.device.type == "cpu" else attention_fwd_cuda
    return fn(q, k, v, scale)


def attention_bwd(q, k, v, out, lse, d_out, scale: float):
    """The backward kernel for CUDA tensors, its plain version for CPU tensors."""
    fn = attention_bwd_plain if q.device.type == "cpu" else attention_bwd_cuda
    return fn(q, k, v, out, lse, d_out, scale)


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(d)) v over (b, h, n | m, d) operands without the
    (n, m) logits in device memory, with a hand-written backward (the JAX
    package's `_flash_attention` and its VJP). q, k, v of any float dtype and
    stride are rounded once to contiguous bf16; head dims below a built size
    are zero-padded to it (zeros add nothing to the logits, the padded
    output channels are cut off) and the scale is the true head dim's. The
    output has q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v):
        d = q.shape[-1]
        padded = next((x for x in _FLASH_HEAD_DIMS if x >= d), None)
        if padded is None:
            raise ValueError(f"FlashAttention: head dim {d} above {_FLASH_HEAD_DIMS[-1]}")
        scale = d**-0.5

        def prep(x):
            x = _bf16_contiguous(x)
            return F.pad(x, (0, padded - d)) if padded != d else x

        qb, kb, vb = prep(q), prep(k), prep(v)
        out, lse = attention_fwd(qb, kb, vb, scale)
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.meta = (d, scale, q.dtype, k.dtype, v.dtype)
        return out[..., :d].to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        qb, kb, vb, out, lse = ctx.saved_tensors
        d, scale, *dtypes = ctx.meta
        gb = _bf16_contiguous(g)
        if qb.shape[-1] != d:
            gb = F.pad(gb, (0, qb.shape[-1] - d))
        grads = attention_bwd(qb, kb, vb, out, lse, gb, scale)
        return tuple(x[..., :d].to(dt) for x, dt in zip(grads, dtypes))


def use_flash_attention(q, k, mask=None, bias=None) -> bool:
    """The JAX package's dispatch rule with the card in the TPU's place:
    CUDA tensors, no mask, no bias, 4-D, at least 2048 tokens on the shorter
    side, and `PF3PLAT_FLASH_ATTENTION` not "0"."""
    return (os.environ.get("PF3PLAT_FLASH_ATTENTION", "1") != "0"
            and q.device.type == "cuda" and mask is None and bias is None and q.dim() == 4
            and min(q.shape[-2], k.shape[-2]) >= _FLASH_MIN_TOKENS)


def _additive_mask(mask, bias, like):
    """The JAX code's masking as one additive term: masked logits at -1e30,
    `bias` added; None without either."""
    add = bias
    if mask is not None:
        neg = torch.zeros(mask.shape, dtype=like.dtype, device=like.device)
        neg.masked_fill_(~mask, -1e30)
        add = neg if add is None else add + neg
    return add


def library_attention(q, k, v, mask=None, bias=None, q_scale=None) -> torch.Tensor:
    """`F.scaled_dot_product_attention` at the JAX call site's `mxu_einsum`
    arithmetic: every attention on the card that the JAX package computes
    outside its TPU flash kernel. q * `q_scale` (q itself when None), k and
    v go in as bf16; the logits are taken unscaled after a `q_scale` (the
    prescaled sites: `scaled_dot_attention`, the U-Net's cross-view
    attention, CrossBlock), else scaled by 1/sqrt(d) in the product (the
    swin windows). Masked logits at -1e30 and `bias` are added in bf16. The
    result is float32, or the autocast dtype inside autocast."""
    bf = torch.bfloat16
    if q_scale is not None:
        q = q * q_scale
    q, k, v = (x.to(bf) for x in (q, k, v))
    add = _additive_mask(mask, bias, q)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=None if add is None else add.to(bf),
                                         scale=None if q_scale is None else 1.0)
    dev = out.device.type
    return out if torch.is_autocast_enabled(dev) else out.float()


def mxu_attention(q, k, v, mask=None, bias=None, q_scale=None) -> torch.Tensor:
    """The JAX package's `mxu_einsum` attention, `library_attention`'s
    function written out: bf16(q * q_scale) bf16(k)^T in f32 (or
    bf16(q) bf16(k)^T / sqrt(d) when `q_scale` is None), masked at -1e30,
    `bias` added, softmax in f32, the weights rounded to bf16 for the
    product with bf16(v). The CPU path of `attention`."""
    if q_scale is not None:
        sim = mxu_matmul(q * q_scale, k.transpose(-1, -2))
    else:
        sim = mxu_matmul(q, k.transpose(-1, -2)) / q.shape[-1]**0.5
    if mask is not None:
        sim = torch.where(mask, sim, torch.full_like(sim, -1e30))
    if bias is not None:
        sim = sim + bias
    attn = torch.softmax(sim.float(), dim=-1)
    return mxu_matmul(attn, v)


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
    if use_flash_attention(q, k, mask, bias):
        q, k, v = common_dtype(q, k, v)
        return FlashAttention.apply(q, k, v)
    q_scale = q.shape[-1]**-0.5 if prescale else None
    fn = library_attention if q.device.type == "cuda" else mxu_attention
    return fn(q, k, v, mask=mask, bias=bias, q_scale=q_scale)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


def apply_rotary_emb(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """freqs: (2, ..., dim) stacked (cos, sin); t: (..., dim)."""
    return t * freqs[0] + rotate_half(t) * freqs[1]


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The erf GELU of timm's and CroCo's MLPs (not Flax's tanh `gelu`)."""
    return F.gelu(x)


def rope_2d_tables(positions: torch.Tensor, head_dim: int, base: float = 100.0
                   ) -> tuple[torch.Tensor, ...]:
    """CroCo's `RoPE2D` tables for integer token positions (..., n, 2) =
    (row y, column x): (cos y, sin y, cos x, sin x), each (..., 1, n, head_dim
    / 2) to broadcast over heads. Each half of a head rotates by one
    coordinate p at the angles p * base^(-2i / (head_dim / 2)), i < head_dim
    / 4, repeated over the half's two quarters."""
    d = head_dim // 2
    inv = 1.0 / base ** (torch.arange(0, d, 2, device=positions.device).float() / d)
    out = []
    for p in positions.unbind(-1):
        angles = p.float()[..., None] * inv
        angles = torch.cat([angles, angles], dim=-1).unsqueeze(-3)
        out += [angles.cos(), angles.sin()]
    return tuple(out)


def apply_rope_2d(t: torch.Tensor, tables: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """t (..., heads, n, head_dim) with its first half rotated by the rows'
    and its second by the columns' tables (`rope_2d_tables`):
    t cos + rotate(t) sin, rotate(a, b) = (-b, a) over each half's quarters."""
    cos_y, sin_y, cos_x, sin_x = tables
    out = []
    for half, cos, sin in zip(t.chunk(2, dim=-1), (cos_y, cos_x), (sin_y, sin_x)):
        a, b = half.chunk(2, dim=-1)
        out.append(half * cos + torch.cat([-b, a], dim=-1) * sin)
    return torch.cat(out, dim=-1)


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
        r = (head**-0.5)**0.5  # the JAX block's scale**0.5
        if x0.device.type == "cuda":
            # The JAX block rounds (qk0 s^.5) and (qk1 s^.5) to bf16 and forms
            # its logits outside any TPU kernel (they serve both directions),
            # so this stays the library's attention at every length.
            qk0, qk1 = qk0 * r, qk1 * r
            m0 = library_attention(qk0, qk1, v1, mask=mask, q_scale=1.0)
            m1 = library_attention(qk1, qk0, v0, mask=None if mask is None
                                   else mask.transpose(-1, -2), q_scale=1.0) \
                if update_x1 else None
        else:
            sim = mxu_matmul(qk0 * r, (qk1 * r).transpose(-1, -2))
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
        # exact float32, as the JAX layer pins them (precision="highest")
        kv = exact_einsum("...shd,...shv->...hdv", k, v / v_len)
        z = 1.0 / (exact_einsum("...lhd,...hd->...lh", q, k.sum(dim=-3)) + 1e-6)
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
