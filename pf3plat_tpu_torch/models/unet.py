"""LDM-style 2D U-Net with cross-view self-attention (NHWC), port of
`pf3plat_tpu/models/unet.py`. Submodules are created in the Flax call order
so their names (`Conv_k`, `ResBlock_k`, ...) match the JAX parameter tree."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import attention
from .nhwc import Conv, GroupNorm, resize_nearest


class Named(nn.Module):
    """Registers submodules under Flax's auto-names (`Kind_<count>`)."""

    def __init__(self):
        super().__init__()
        self._counts: dict[str, int] = {}

    def named(self, kind: str, module: nn.Module) -> nn.Module:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return module

    def keep(self, attr: str, kind: str, module: nn.Module | None) -> None:
        """`named`, plus a plain (unregistered) attribute for forward."""
        if module is not None:
            self.named(kind, module)
        object.__setattr__(self, attr, module)


class ResBlock(Named):
    def __init__(self, c_in: int, out_channels: int, groups: int = 32):
        super().__init__()
        g = min(groups, c_in, out_channels)
        self.keep("gn0", "GroupNorm", GroupNorm(g, c_in))
        self.keep("conv0", "Conv", Conv(c_in, out_channels, 3))
        self.keep("gn1", "GroupNorm", GroupNorm(g, out_channels))
        self.keep("conv1", "Conv", Conv(out_channels, out_channels, 3))
        self.keep("skip", "Conv",
                  Conv(c_in, out_channels, 1) if c_in != out_channels else None)

    def forward(self, x):
        h = self.conv0(F.silu(self.gn0(x)))
        h = self.conv1(F.silu(self.gn1(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class CrossViewAttention(Named):
    """Self-attention over (v * h * w) tokens: every pixel attends across
    views."""

    def __init__(self, c: int, num_head_channels: int = 32, num_views: int = 2):
        super().__init__()
        self.num_views = num_views
        self.heads = max(1, c // num_head_channels)
        self.keep("gn", "GroupNorm", GroupNorm(min(32, c), c))
        self.keep("qkv", "Conv", Conv(c, 3 * c, 1))
        self.keep("proj", "Conv", Conv(c, c, 1))

    def forward(self, x):
        vb, h, w, c = x.shape
        v = self.num_views
        b = vb // v
        heads = self.heads
        head = c // heads
        qkv = self.qkv(self.gn(x))
        qkv = qkv.reshape(v, b, h * w, 3 * c).permute(1, 0, 2, 3)
        qkv = qkv.reshape(b, v * h * w, 3, heads, head)
        q, k, v_ = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, h, n, d)
        out = attention(q, k, v_).transpose(1, 2)  # (b, n, heads, d)
        out = out.reshape(b, v, h * w, c).permute(1, 0, 2, 3).reshape(vb, h, w, c)
        return x + self.proj(out)


class UNetModel(Named):
    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int = 1, attention_resolutions=(),
                 channel_mult=(1, 1, 1), num_head_channels: int = 32,
                 num_views: int = 2):
        super().__init__()
        attn_res = tuple(attention_resolutions)

        def attn(c):
            return self.named("CrossViewAttention",
                              CrossViewAttention(c, num_head_channels, num_views))

        ch = model_channels
        self.keep("conv_in", "Conv", Conv(in_channels, ch, 3))
        skip_ch = [ch]
        self.down = []  # ("res", block, attn|None) | ("down", conv)
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                blk = self.named("ResBlock", ResBlock(ch, mult * model_channels))
                ch = mult * model_channels
                self.down.append(("res", blk, attn(ch) if ds in attn_res else None))
                skip_ch.append(ch)
            if level != len(channel_mult) - 1:
                self.down.append(("down", self.named("Conv", Conv(ch, ch, 3, stride=2))))
                skip_ch.append(ch)
                ds *= 2
        self.keep("mid0", "ResBlock", ResBlock(ch, ch))
        object.__setattr__(self, "mid_attn", attn(ch) if ds in attn_res else None)
        self.keep("mid1", "ResBlock", ResBlock(ch, ch))
        self.up = []  # (block, attn|None, upsample conv|None)
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                cin = ch + skip_ch.pop()
                blk = self.named("ResBlock", ResBlock(cin, mult * model_channels))
                ch = mult * model_channels
                a = attn(ch) if ds in attn_res else None
                upconv = None
                if level and i == num_res_blocks:
                    upconv = self.named("Conv", Conv(ch, ch, 3))
                    ds //= 2
                self.up.append((blk, a, upconv))
        self.keep("gn_out", "GroupNorm", GroupNorm(min(32, ch), ch))
        self.keep("conv_out", "Conv", Conv(ch, out_channels, 3))

    def forward(self, x):
        h = self.conv_in(x)
        skips = [h]
        for item in self.down:
            if item[0] == "res":
                h = item[1](h)
                if item[2] is not None:
                    h = item[2](h)
            else:
                h = item[1](h)
            skips.append(h)
        h = self.mid0(h)
        if self.mid_attn is not None:
            h = self.mid_attn(h)
        h = self.mid1(h)
        for blk, a, upconv in self.up:
            h = blk(torch.cat([h, skips.pop()], dim=-1))
            if a is not None:
                h = a(h)
            if upconv is not None:
                h = upconv(resize_nearest(h, (h.shape[1] * 2, h.shape[2] * 2)))
        return self.conv_out(F.silu(self.gn_out(h)))
