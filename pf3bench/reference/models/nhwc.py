"""Channel-last (NHWC) conv / norm / resize helpers with Flax semantics.

The JAX models are written in NHWC with `nn.Conv` ("SAME" padding: for a
stride-2 3x3 conv on an even size that pads 0 before and 1 after, unlike
PyTorch's symmetric padding) and `nn.GroupNorm` (epsilon 1e-6). These
wrappers keep the JAX layouts at the module boundaries and the parameter
names `weight`/`bias` that `weights.py` maps from `kernel`/`scale`/`bias`.

Mixed precision follows flax's promotion rules, not an autocast region:
`Conv(..., dtype=d)` casts its input, kernel and bias to `d` and returns
`d` (the conv rounded to `d`, then the bias added in `d`, as flax adds
it); `GroupNorm` computes in the promotion of its input's and its
parameters' dtypes, so a bfloat16 input with float32 scale gives float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


# The names `jnp.dtype` reads for the JAX package's compute-dtype knobs.
_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def parse_dtype(name: str) -> torch.dtype:
    """A floating dtype by its name ("float32", "bfloat16", ...); an unknown
    name raises, as `jnp.dtype` does."""
    if name not in _DTYPES:
        raise TypeError(f"data type {name!r} not understood")
    return _DTYPES[name]


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax `nn.Conv` on NHWC input (padding "SAME" or "VALID"); `dtype`,
    if given, is the compute dtype (flax's `dtype`; parameters stay
    float32)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, padding: str = "SAME",
                 dtype: torch.dtype | None = None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, groups=groups, bias=bias)
        self.flax_padding = padding
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(dt)
        x = x.permute(0, 3, 1, 2)
        if self.flax_padding == "SAME":
            k, s = self.kernel_size[0], self.stride[0]
            top, bottom = _same_pad(x.shape[2], k, s)
            left, right = _same_pad(x.shape[3], k, s)
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
        if dt is None or dt == self.weight.dtype:
            return super().forward(x).permute(0, 2, 3, 1)
        y = self._conv_forward(x, self.weight.to(dt), None).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(dt)


class GroupNorm(nn.GroupNorm):
    """flax `nn.GroupNorm` (epsilon 1e-6) on NHWC input."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__(num_groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
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
