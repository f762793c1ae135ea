"""Data-layer types (host-side numpy); port of `pf3plat_tpu/data/types.py`."""

from __future__ import annotations

from typing import Callable, Literal, TypedDict

import numpy as np

Stage = Literal["train", "val", "test"]


class Views(TypedDict):
    """One example's stack of views (numpy, channel-last images)."""

    extrinsics: np.ndarray  # (v, 4, 4) c2w
    intrinsics: np.ndarray  # (v, 3, 3) normalized
    image: np.ndarray       # (v, h, w, 3) float32 in [0, 1]
    near: np.ndarray        # (v,)
    far: np.ndarray         # (v,)
    index: np.ndarray       # (v,) frame indices


class Example(TypedDict):
    context: Views
    target: Views
    scene: str


DataShim = Callable[[Example], Example]
