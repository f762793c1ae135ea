"""LightGlue matcher with static shapes and validity masks (port of
`pf3plat_tpu/models/backbones/lightglue.py`); module tree = the released
checkpoint's (`input_proj`, `posenc.Wr`, `transformers.i.{self,cross}_attn`,
`log_assignment.i.{final_proj,matchability}`; only the last assignment head
runs, early exit and pruning are off as in the JAX module). The similarity
matrix is exact float32 (the JAX module pins it to "highest"); inside bf16
autocast `final_proj` and `matchability` run at the JAX package's bfloat16
rule (`precision.decision_head`)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ... import precision
from ..layers import CrossBlock, LearnableFourierPositionalEncoding, SelfBlock
from .superpoint import Keypoints


class MatchResult(NamedTuple):
    m0: torch.Tensor       # (b, k) index into kpts1, -1 invalid
    scores0: torch.Tensor  # (b, k)
    valid: torch.Tensor    # (b, k) bool


def normalize_keypoints(xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    size = torch.tensor([w, h], dtype=xy.dtype, device=xy.device)
    return (xy - size / 2) / (size.max() / 2)


def sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1):
    pair_mask = mask0[..., :, None] & mask1[..., None, :]
    sim = torch.where(pair_mask, sim, torch.full_like(sim, -1e30))
    certainties = F.logsigmoid(z0[..., :, 0:1]) + F.logsigmoid(z1[..., None, :, 0])
    return F.log_softmax(sim, dim=-1) + F.log_softmax(sim, dim=-2) + certainties


class TransformerLayer(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.self_attn = SelfBlock(d, heads)
        self.cross_attn = CrossBlock(d, heads)


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

    def forward(self, kpts0: Keypoints, kpts1: Keypoints, image_shape) -> MatchResult:
        h, w = image_shape
        d = self.input_proj.out_features
        desc0 = self.input_proj(kpts0.descriptors)
        desc1 = self.input_proj(kpts1.descriptors)
        enc0 = self.posenc(normalize_keypoints(kpts0.xy, h, w))
        enc1 = self.posenc(normalize_keypoints(kpts1.xy, h, w))
        m0, m1 = kpts0.valid, kpts1.valid
        mask0 = m0[:, None, :, None] & m0[:, None, None, :]
        mask1 = m1[:, None, :, None] & m1[:, None, None, :]
        cross = m0[:, None, :, None] & m1[:, None, None, :]
        for layer in self.transformers:
            desc0 = layer.self_attn(desc0, enc0, mask0)
            desc1 = layer.self_attn(desc1, enc1, mask1)
            desc0, desc1 = layer.cross_attn(desc0, desc1, cross)
        head = self.log_assignment[-1]
        rule = precision.decision_head
        desc0, desc1 = desc0.float(), desc1.float()
        mdesc0 = rule(head.final_proj, desc0) / d**0.25
        mdesc1 = rule(head.final_proj, desc1) / d**0.25
        sim = precision.exact_einsum("bmd,bnd->bmn", mdesc0, mdesc1)
        scores = sigmoid_log_double_softmax(
            sim, rule(head.matchability, desc0), rule(head.matchability, desc1), m0, m1)
        max0_idx = torch.argmax(scores, dim=-1)
        max1_idx = torch.argmax(scores, dim=-2)
        k0 = torch.arange(scores.shape[-2], device=scores.device)
        mutual0 = k0[None] == torch.gather(max1_idx, 1, max0_idx)
        mscores0 = torch.where(mutual0, torch.exp(scores.amax(dim=-1)),
                               torch.zeros_like(scores[..., 0]))
        valid = mutual0 & (mscores0 > self.filter_threshold) & m0
        valid = valid & torch.gather(m1, 1, max0_idx)
        return MatchResult(
            m0=torch.where(valid, max0_idx, torch.full_like(max0_idx, -1)),
            scores0=mscores0, valid=valid,
        )
