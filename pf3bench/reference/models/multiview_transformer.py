"""Swin-style windowed self-attention transformer (NHWC), port of
`pf3plat_tpu/models/multiview_transformer.py`."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .layers import attention, gelu, layer_norm


def split_windows(x: torch.Tensor, splits: int) -> torch.Tensor:
    """(b, h, w, c) -> (b*splits*splits, h/s, w/s, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, splits, h // splits, splits, w // splits, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b * splits * splits, h // splits, w // splits, c)


def merge_windows(x: torch.Tensor, splits: int) -> torch.Tensor:
    bs, hw, ww, c = x.shape
    b = bs // (splits * splits)
    x = x.reshape(b, splits, splits, hw, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, splits * hw, splits * ww, c)


def shifted_window_attn_mask(h: int, w: int, splits: int) -> np.ndarray:
    """Additive (-100/0) attention mask for shifted windows."""
    win_h, win_w = h // splits, w // splits
    shift_h, shift_w = win_h // 2, win_w // 2
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -win_h), slice(-win_h, -shift_h), slice(-shift_h, None)):
        for ws in (slice(0, -win_w), slice(-win_w, -shift_w), slice(-shift_w, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(splits, win_h, splits, win_w).transpose(0, 2, 1, 3)
    img = img.reshape(splits * splits, win_h * win_w)
    mask = img[:, None, :] - img[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_attention(q, k, v, splits: int, with_shift: bool) -> torch.Tensor:
    """Single-head windowed attention over NHWC maps -> NHWC."""
    b, h, w, c = q.shape
    if splits <= 1:
        out = attention(q.reshape(b, h * w, c), k.reshape(b, h * w, c),
                        v.reshape(b, h * w, c), prescale=False)
        return out.reshape(b, h, w, c)
    shift_h, shift_w = (h // splits) // 2, (w // splits) // 2
    if with_shift:
        q, k, v = (torch.roll(x, (-shift_h, -shift_w), dims=(1, 2)) for x in (q, k, v))
    qs, ks, vs = (split_windows(x, splits) for x in (q, k, v))
    bw, hw, ww, _ = qs.shape
    nt = hw * ww
    bias = None
    if with_shift:
        mask = torch.as_tensor(shifted_window_attn_mask(h, w, splits), device=q.device)
        bias = mask.repeat(b, 1, 1)
    out = attention(qs.reshape(bw, nt, c), ks.reshape(bw, nt, c),
                    vs.reshape(bw, nt, c), bias=bias, prescale=False)
    out = merge_windows(out.reshape(bw, hw, ww, c), splits)
    if with_shift:
        out = torch.roll(out, (shift_h, shift_w), dims=(1, 2))
    return out


class SwinSelfLayer(nn.Module):
    def __init__(self, d_model: int, ffn_expansion: int = 2, with_shift: bool = False):
        super().__init__()
        d = d_model
        self.with_shift = with_shift
        self.Dense_0 = nn.Linear(d, d, bias=False)
        self.Dense_1 = nn.Linear(d, d, bias=False)
        self.Dense_2 = nn.Linear(d, d, bias=False)
        self.Dense_3 = nn.Linear(d, d, bias=False)
        self.LayerNorm_0 = layer_norm(d)
        self.Dense_4 = nn.Linear(2 * d, 2 * d * ffn_expansion, bias=False)
        self.Dense_5 = nn.Linear(2 * d * ffn_expansion, d, bias=False)
        self.LayerNorm_1 = layer_norm(d)

    def forward(self, x, splits: int):
        message = window_attention(
            self.Dense_0(x), self.Dense_1(x), self.Dense_2(x), splits, self.with_shift)
        message = self.LayerNorm_0(self.Dense_3(message))
        y = gelu(self.Dense_4(torch.cat([x, message], dim=-1)))
        return x + self.LayerNorm_1(self.Dense_5(y))


class MultiViewFeatureTransformer(nn.Module):
    def __init__(self, num_layers: int = 1, d_model: int = 256, ffn_expansion: int = 2):
        super().__init__()
        self.layers = []
        for i in range(num_layers):
            layer = SwinSelfLayer(d_model, ffn_expansion, with_shift=(i % 2 == 1))
            self.add_module(f"SwinSelfLayer_{i}", layer)
            self.layers.append(layer)

    def forward(self, features, splits: int):
        x = features
        for layer in self.layers:
            x = layer(x, splits)
        return x
