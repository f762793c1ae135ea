"""LightGlue matcher with static shapes and validity masks (port of
`pf3plat_tpu/models/backbones/lightglue.py`); module tree = the released
checkpoint's (`input_proj`, `posenc.Wr`, `transformers.i.{self,cross}_attn`,
`log_assignment.i.{final_proj,matchability}`; only the last assignment head
runs, early exit and pruning are off as in the JAX module). The similarity
matrix is exact float32 (the JAX module pins it to "highest"); inside bf16
autocast `final_proj` and `matchability` run at the JAX package's bfloat16
rule (`precision.decision_head`).

Both sides of a pair share every weight, so one call runs them as one
batch of 2b, the shorter side padded with invalid keypoints: the input
projection, the positional encoding, each layer's self block and cross
block (both directions in one attention call) and the assignment head
each run once, under attention biases built once a call. Each layer's
`cross_attn` still returns the two sides' descriptors, each at its own
length, and the head takes the two sides apart again."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ... import precision
from ...utils.profiling import count
from ..layers import (CrossBlock, LearnableFourierPositionalEncoding, SelfBlock, attention,
                      library_attention, mxu_matmul, rotate_half)
from .superpoint import Keypoints

# Additive attention logits (bf16): a masked pair, as the JAX module masks
# it, and a key that only pads the shorter side. The second lies far
# below the first, so that a query whose every pair is masked (an invalid
# keypoint) spreads its weight over its own side's keys alone, as without
# the padding.
MASKED = -1e30
PADDED = -1e31


class MatchResult(NamedTuple):
    m0: torch.Tensor       # (b, k) index into kpts1, -1 invalid
    scores0: torch.Tensor  # (b, k)
    valid: torch.Tensor    # (b, k) bool


def sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1):
    pair_mask = mask0[..., :, None] & mask1[..., None, :]
    sim = torch.where(pair_mask, sim, torch.full_like(sim, -1e30))
    certainties = F.logsigmoid(z0[..., :, 0:1]) + F.logsigmoid(z1[..., None, :, 0])
    return F.log_softmax(sim, dim=-1) + F.log_softmax(sim, dim=-2) + certainties


def attention_bias(q_valid: torch.Tensor, k_valid: torch.Tensor,
                   k_pad: torch.Tensor | None) -> torch.Tensor:
    """(n, 1, q, k) bf16 logit term from (n, q) and (n, k) keypoint
    validity: 0 where both are valid, `MASKED` elsewhere, `PADDED` at
    padding keys (`k_pad`, (n, k) bool, or None without padding)."""
    keep = q_valid[:, None, :, None] & k_valid[:, None, None, :]
    bias = torch.zeros(keep.shape, dtype=torch.bfloat16, device=keep.device)
    bias.masked_fill_(~keep, MASKED)
    if k_pad is not None:
        bias.masked_fill_(k_pad[:, None, None, :], PADDED)
    return bias


def stack_sides(x0: torch.Tensor, x1: torch.Tensor, fill=0) -> torch.Tensor:
    """[x0; x1] along the batch, (b, k0 | k1, ...) -> (2b, max(k0, k1), ...),
    the shorter side padded with `fill`."""
    k = max(x0.shape[1], x1.shape[1])

    def pad(x):
        if x.shape[1] == k:
            return x
        shape = (x.shape[0], k - x.shape[1], *x.shape[2:])
        return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=1)

    return torch.cat([pad(x0), pad(x1)])


def unstack_sides(x: torch.Tensor, k0: int, k1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`stack_sides` undone: views of the two sides, each at its own length."""
    x0, x1 = x.split(x.shape[0] // 2)
    return (x0 if k0 == x.shape[1] else x0[:, :k0]), (x1 if k1 == x.shape[1] else x1[:, :k1])


class Sides(tuple):
    """(x0, x1): the two sides' (b, k0 | k1, d) descriptors, views of
    `stack`, both sides as one (2b, max(k0, k1), d) batch."""

    def __new__(cls, stack: torch.Tensor, k0: int, k1: int):
        self = super().__new__(cls, unstack_sides(stack, k0, k1))
        self.stack = stack
        return self


def rotary_terms(encoding: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin') of the posenc's (cos, sin) encoding, once for every
    layer: `apply_rotary_emb(encoding, t)` is `t * cos + t' * sin'`, t'
    being t with each channel pair swapped and sin' sin negated on even
    channels. The encoding repeats each frequency over a channel pair, so
    sin' is `rotate_half(sin)`; negating a factor instead of the product
    changes no bit."""
    return encoding[0], rotate_half(encoding[1])


class StackedSelfBlock(SelfBlock):
    """LightGlue's self block on the stacked sides under a prebuilt
    attention bias: `SelfBlock`'s parameters and arithmetic, with the
    rotary encoding applied to q and k in one pass."""

    def forward(self, x, rotary, bias):
        """x: (n, k, d); `rotary`: `rotary_terms` of the encoding; `bias`:
        (n, 1, k, k) from `attention_bias`."""
        d = x.shape[-1]
        h = self.num_heads
        qkv = self.Wqkv(x).unflatten(-1, (h, d // h, 3)).transpose(-3, -4)
        qk = qkv[..., :2].movedim(-1, 0)
        cos, sin = rotary
        qk = qk * cos + qk.unflatten(-1, (-1, 2)).flip(-1).flatten(-2) * sin
        context = attention(qk[0], qk[1], qkv[..., 2], bias=bias)
        message = self.out_proj(context.transpose(-3, -2).flatten(-2))
        return x + self.ffn(torch.cat([x, message], dim=-1))


class StackedCrossBlock(CrossBlock):
    """LightGlue's cross block over both sides as one batch: the
    projections and the FFN run once on [x0; x1], and one attention takes
    queries [qk0; qk1], keys [qk1; qk0], values [v1; v0] under the stacked
    bias [cross; cross^T], the same products row by row as the two
    directions taken apart. The parameters are `CrossBlock`'s."""

    def forward(self, x0, x1, bias, stack) -> Sides:
        """x0, x1: the two sides' (b, k0 | k1, d) views of `stack`,
        `stack_sides(x0, x1)`; `bias`: (2b, 1, k, k), k = max(k0, k1), from
        `attention_bias` for the two directions."""
        b, k0, d = x0.shape
        h = self.num_heads
        head = d // h

        def split(t):
            return t.unflatten(-1, (h, head)).transpose(-3, -2)

        r = (head**-0.5)**0.5  # the JAX block's scale**0.5
        qk = split(self.to_qk(stack)) * r
        v = split(self.to_v(stack))
        keys, values = qk.roll(b, 0), v.roll(b, 0)
        if stack.device.type == "cuda":
            # The JAX block rounds (qk s^.5) to bf16 and forms its logits
            # outside any TPU kernel (they serve both directions), so this
            # stays the library's attention at every length.
            m = library_attention(qk, keys, values, bias=bias, q_scale=1.0)
        else:
            sim = mxu_matmul(qk, keys.transpose(-1, -2)) + bias
            m = mxu_matmul(torch.softmax(sim, dim=-1), values)
        m = m.transpose(-3, -2).flatten(-2)
        out = stack + self.ffn(torch.cat([stack, self.to_out(m)], dim=-1))
        return Sides(out, k0, x1.shape[1])


class TransformerLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.self_attn = StackedSelfBlock(d, heads)
        self.cross_attn = StackedCrossBlock(d, heads)


class MatchAssignment(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.matchability = nn.Linear(d, 1)
        self.final_proj = nn.Linear(d, d)


class LightGlue(nn.Module):
    def __init__(self, descriptor_dim: int = 256, n_layers: int = 9, num_heads: int = 4,
                 filter_threshold: float = 0.1):
        super().__init__()
        d = descriptor_dim
        self.filter_threshold = filter_threshold
        self.input_proj = nn.Linear(d, d)
        self.posenc = LearnableFourierPositionalEncoding(2, d // num_heads)
        self.transformers = nn.ModuleList([TransformerLayer(d, num_heads) for _ in range(n_layers)])
        self.log_assignment = nn.ModuleList([MatchAssignment(d) for _ in range(n_layers)])
        self._frames: dict = {}

    def normalize_keypoints(self, xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(xy - size / 2) / (max(size) / 2), size = (w, h), with the two
        constants made on xy's device once per image shape and dtype (a
        tensor made from a list is a blocking host-to-device copy)."""
        key = (h, w, xy.dtype, xy.device)
        if key not in self._frames:
            size = torch.tensor([w, h], dtype=xy.dtype, device=xy.device)
            self._frames[key] = (size / 2, size.max() / 2)
        shift, scale = self._frames[key]
        return (xy - shift) / scale

    def forward(self, kpts0: Keypoints, kpts1: Keypoints, image_shape) -> MatchResult:
        count("lightglue.calls", 1)
        count("lightglue.stacked_calls", 1)
        h, w = image_shape
        d = self.input_proj.out_features
        m0, m1 = kpts0.valid, kpts1.valid
        b, k0 = m0.shape
        k1 = m1.shape[1]
        x = self.input_proj(stack_sides(kpts0.descriptors, kpts1.descriptors))
        enc = self.posenc(self.normalize_keypoints(stack_sides(kpts0.xy, kpts1.xy), h, w))
        valid = stack_sides(m0, m1, fill=False)
        pad = None
        if k0 != k1:
            pad = stack_sides(torch.zeros_like(m0), torch.zeros_like(m1), fill=True)
        self_bias = attention_bias(valid, valid, pad)
        cross_bias = attention_bias(valid, valid.roll(b, 0), None if pad is None
                                    else pad.roll(b, 0))
        rotary = rotary_terms(enc)
        for layer in self.transformers:
            x = layer.self_attn(x, rotary, self_bias)
            x = layer.cross_attn(*unstack_sides(x, k0, k1), cross_bias, stack=x).stack
        head = self.log_assignment[-1]
        rule = precision.decision_head
        x = x.float()
        mdesc = rule(head.final_proj, x) / d**0.25
        z = rule(head.matchability, x)
        sim = precision.exact_einsum("bmd,bnd->bmn", *unstack_sides(mdesc, k0, k1))
        scores = sigmoid_log_double_softmax(sim, *unstack_sides(z, k0, k1), m0, m1)
        max0_idx = torch.argmax(scores, dim=-1)
        max1_idx = torch.argmax(scores, dim=-2)
        rows = torch.arange(scores.shape[-2], device=scores.device)
        mutual0 = rows[None] == torch.gather(max1_idx, 1, max0_idx)
        mscores0 = torch.where(mutual0, torch.exp(scores.amax(dim=-1)),
                               torch.zeros_like(scores[..., 0]))
        valid = mutual0 & (mscores0 > self.filter_threshold) & m0
        valid = valid & torch.gather(m1, 1, max0_idx)
        return MatchResult(
            m0=torch.where(valid, max0_idx, torch.full_like(max0_idx, -1)),
            scores0=mscores0, valid=valid,
        )
