"""Core model data types (port of `pf3plat_tpu/models/types.py`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Gaussians(NamedTuple):
    """A batch of 3D Gaussians. Shapes: (batch, gaussian, ...)."""

    means: torch.Tensor        # (b, g, 3)
    covariances: torch.Tensor  # (b, g, 3, 3)
    harmonics: torch.Tensor    # (b, g, 3, d_sh)
    opacities: torch.Tensor    # (b, g)


class DecoderOutput(NamedTuple):
    color: torch.Tensor                   # (b, v, h, w, 3) channel-last
    depth: Optional[torch.Tensor] = None  # (b, v, h, w)
