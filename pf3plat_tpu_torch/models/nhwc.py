"""Channel-last (NHWC) conv / norm / resize helpers with Flax semantics.

The JAX models are written in NHWC with `nn.Conv` ("SAME" padding: for a
stride-2 3x3 conv on an even size that pads 0 before and 1 after, unlike
PyTorch's symmetric padding) and `nn.GroupNorm` (epsilon 1e-6). These
wrappers keep the JAX layouts at the module boundaries and the parameter
names `weight`/`bias` that `weights.py` maps from `kernel`/`scale`/`bias`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax `nn.Conv` on NHWC input (padding "SAME" or "VALID")."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, padding: str = "SAME"):
        super().__init__(in_ch, out_ch, kernel, stride=stride, groups=groups, bias=bias)
        self.flax_padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.flax_padding == "SAME":
            k, s = self.kernel_size[0], self.stride[0]
            top, bottom = _same_pad(x.shape[2], k, s)
            left, right = _same_pad(x.shape[3], k, s)
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
        return super().forward(x).permute(0, 2, 3, 1)


class GroupNorm(nn.GroupNorm):
    """flax `nn.GroupNorm` (epsilon 1e-6) on NHWC input."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__(num_groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear")` on NHWC: half-pixel centers and a
    triangle kernel widened by the scale when downsampling (antialias)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` on NHWC (half-pixel rule)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="nearest-exact")
    return y.permute(0, 2, 3, 1)
