"""VGG16 feature extractor + LPIPS perceptual distance (NHWC).

Port of `pf3plat_tpu/models/backbones/vgg_lpips.py`: the VGG16 conv stack
up to conv5_3, activations after the last ReLU of each of the 5 stages,
unit-normalized per position, squared differences through learned 1x1
heads (`lin0`..`lin4`, no bias, initialized to 0.1), spatial mean, summed
over the taps. Module names follow the Flax tree (`vgg.conv{s}_{i}`,
`lin{i}`), so `weights.load_jax_params` carries the JAX parameters by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nhwc import Conv

# conv layers per VGG16 stage (channels, convs per stage)
_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

_IMAGENET_SHIFT = (-0.030, -0.088, -0.188)  # lpips normalization (on [-1, 1])
_IMAGENET_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """Returns the activations after the last ReLU of each of the 5 stages."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, (ch, n_convs) in enumerate(_STAGES):
            for i in range(n_convs):
                self.add_module(f"conv{stage + 1}_{i + 1}", Conv(cin, ch, 3))
                cin = ch

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for stage, (_, n_convs) in enumerate(_STAGES):
            for i in range(n_convs):
                x = F.relu(getattr(self, f"conv{stage + 1}_{i + 1}")(x))
            taps.append(x)
            if stage < len(_STAGES) - 1:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return taps


class LPIPS(nn.Module):
    """LPIPS(vgg): normalize inputs, diff unit-normalized features, 1x1 heads."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_STAGES):
            lin = Conv(ch, 1, 1, bias=False)
            nn.init.constant_(lin.weight, 0.1)
            self.add_module(f"lin{i}", lin)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        """img0, img1: (b, h, w, 3); normalize=True expects [0, 1] inputs.
        Returns (b,) distances."""
        if normalize:  # [0, 1] -> [-1, 1]
            img0 = 2 * img0 - 1
            img1 = 2 * img1 - 1
        shift = torch.tensor(_IMAGENET_SHIFT, dtype=img0.dtype, device=img0.device)
        scale = torch.tensor(_IMAGENET_SCALE, dtype=img0.dtype, device=img0.device)
        f0 = self.vgg((img0 - shift) / scale)
        f1 = self.vgg((img1 - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-10)
            w = getattr(self, f"lin{i}")((a - b) ** 2)
            total = total + w.mean(dim=(1, 2, 3))
        return total
