"""View samplers: choose context/target frame indices per scene.

Port of `pf3plat_tpu/data/view_samplers.py` (numpy, kept as it is: the
port holds its own copy). Mirrors `src/dataset/view_sampler/`:
  * bounded    — random context gap with warmup schedule
    (`view_sampler_bounded.py:29-113`)
  * evaluation — fixed indices from a JSON evaluation index
    (`view_sampler_evaluation.py:24-59`)
  * arbitrary  — random subsets; all — every frame

Pure numpy + an explicit `global_step` argument (the reference smuggles the
step across dataloader processes with a shared-memory StepTracker,
`src/misc/step_tracker.py`; here the training loop passes it directly).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np


class SampleError(ValueError):
    """Example unusable (not enough frames, missing index entry)."""


@dataclasses.dataclass
class BoundedSamplerCfg:
    num_context_views: int = 2
    num_target_views: int = 4
    min_distance_between_context_views: int = 45
    max_distance_between_context_views: int = 45
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 25
    initial_max_distance_between_context_views: int = 25


class BoundedViewSampler:
    def __init__(self, cfg: BoundedSamplerCfg, stage: str = "train"):
        self.cfg = cfg
        self.stage = stage

    def _schedule(self, initial: int, final: int, step: int) -> int:
        frac = step / self.cfg.warm_up_steps
        return min(initial + int((final - initial) * frac), final)

    def sample(
        self, scene: str, num_views: int, rng: np.random.Generator,
        global_step: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        if self.stage == "test":
            max_gap = min_gap = cfg.max_distance_between_context_views
        elif cfg.warm_up_steps > 0:
            max_gap = self._schedule(
                cfg.initial_max_distance_between_context_views,
                cfg.max_distance_between_context_views, global_step,
            )
            min_gap = self._schedule(
                cfg.initial_min_distance_between_context_views,
                cfg.min_distance_between_context_views, global_step,
            )
        else:
            max_gap = cfg.max_distance_between_context_views
            min_gap = cfg.min_distance_between_context_views

        # Reference keeps this quirk "to follow initial pixelsplat cfgs".
        max_gap = min(num_views - 1, min_gap)
        min_gap = max(2 * cfg.min_distance_to_context_views, min_gap)
        if max_gap < min_gap:
            raise SampleError(f"{scene}: not enough frames ({num_views})")
        gap = int(rng.integers(min_gap, max_gap + 1))

        left = int(rng.integers(num_views - gap))
        if self.stage == "test":
            left = 0
        right = left + gap

        if self.stage == "test":
            target = np.arange(left, right + 1)
        else:
            lo = left + cfg.min_distance_to_context_views
            hi = right + 1 - cfg.min_distance_to_context_views
            target = rng.integers(lo, hi, size=(cfg.num_target_views,))
        return np.asarray([left, right], np.int64), np.asarray(target, np.int64)


class EvaluationViewSampler:
    """Fixed per-scene indices from `assets/evaluation_index_*.json`."""

    def __init__(self, index_path: Path):
        with Path(index_path).open() as f:
            raw = json.load(f)
        self.index = {
            k: None if v is None else (tuple(v["context"]), tuple(v["target"]))
            for k, v in raw.items()
        }

    def sample(self, scene: str, num_views: int,
               rng: Optional[np.random.Generator] = None,
               global_step: int = 0) -> tuple[np.ndarray, np.ndarray]:
        entry = self.index.get(scene)
        if entry is None:
            raise SampleError(f"no index entry for scene {scene}")
        ctx, tgt = entry
        return np.asarray(ctx, np.int64), np.asarray(tgt, np.int64)


class ArbitraryViewSampler:
    def __init__(self, num_context_views: int = 2, num_target_views: int = 4):
        self.num_context_views = num_context_views
        self.num_target_views = num_target_views

    def sample(self, scene, num_views, rng: np.random.Generator,
               global_step: int = 0):
        if num_views < self.num_context_views:
            raise SampleError(f"{scene}: not enough frames")
        ctx = np.sort(
            rng.choice(num_views, self.num_context_views, replace=False)
        )
        tgt = rng.integers(ctx.min(), ctx.max() + 1,
                           size=(self.num_target_views,))
        return ctx.astype(np.int64), tgt.astype(np.int64)


class AllViewSampler:
    """Every frame becomes both context and target (reference
    `view_sampler_all.py`) — used for trajectory-video evaluation.

    `max_views` (TPU deviation, documented in PARITY.md): optionally
    subsample to at most `max_views` evenly-spaced frames so the jitted
    forward keeps a bounded shape set instead of recompiling per scene
    length."""

    def __init__(self, max_views: "int | None" = None):
        self.max_views = max_views

    def sample(self, scene, num_views, rng=None, global_step: int = 0):
        if self.max_views is not None and num_views > self.max_views:
            idx = np.linspace(0, num_views - 1, self.max_views)
            idx = np.unique(np.round(idx).astype(np.int64))
        else:
            idx = np.arange(num_views, dtype=np.int64)
        return idx, idx
