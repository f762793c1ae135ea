"""The optimizer of the reference: a frozen copy of the port's
`training/train.py` optimizer (optax's onecycle schedule, clip by global
norm, Adam, apply-if-finite), as plain functions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch


MAX_CONSECUTIVE_ERRORS = 100
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


@dataclasses.dataclass(frozen=True)
class OptimizerCfg:
    lr: float = 2e-4
    max_steps: int = 300_001
    cosine_lr: bool = True
    warm_up_steps: int = 2000
    grad_clip: float = 0.5


def make_schedule(cfg: OptimizerCfg) -> Callable[[int], float]:
    """The learning rate at optimizer count `count`: optax's schedules,
    evaluated in float32 in optax's order of operations."""
    f32 = np.float32
    if not cfg.cosine_lr:
        init, end, steps = cfg.lr / cfg.warm_up_steps, cfg.lr, cfg.warm_up_steps

        def linear(count: int) -> float:
            frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
            return float(f32(init - end) * frac + f32(end))

        return linear

    total = cfg.max_steps + 10
    # pct_start * total must cover >= 1 step (the JAX package's guard).
    pct_start = max(0.01, 1.5 / total)
    div, final_div = 25.0, 1e4
    bounds = (0, int(pct_start * total), int(total))
    values = np.cumprod([cfg.lr / div, div, 1.0 / (div * final_div)])

    def onecycle(count: int) -> float:
        if count >= bounds[2]:
            return float(f32(values[2]))
        k = 0 if count < bounds[1] else 1
        pct = f32(count - bounds[k]) / f32(bounds[k + 1] - bounds[k])
        start, end = values[k], values[k + 1]
        cos = np.cos(f32(np.pi) * pct)
        return float(f32(end) + f32((start - end) / 2.0) * (cos + f32(1)))

    return onecycle


class OptState(NamedTuple):
    count: int                  # Adam's and the schedule's update count
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    notfinite_count: int        # consecutive non-finite gradients


class TrainState(NamedTuple):
    params: list[torch.Tensor]  # the encoder's parameters, updated in place
    opt_state: OptState
    step: int


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def init_opt_state(params) -> OptState:
    return OptState(0, [torch.zeros_like(p) for p in params],
                    [torch.zeros_like(p) for p in params], 0)


def opt_update(cfg: OptimizerCfg, schedule, grads, state: OptState
               ) -> tuple[list[torch.Tensor], OptState]:
    """apply_if_finite(chain(clip_by_global_norm, adam(schedule))) ->
    (updates to add to the parameters, new state)."""
    finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
    notfinite = 0 if finite else state.notfinite_count + 1
    if not (finite or notfinite > MAX_CONSECUTIVE_ERRORS):
        return [torch.zeros_like(g) for g in grads], state._replace(notfinite_count=notfinite)
    g_norm = global_norm(grads)
    if not bool(g_norm < cfg.grad_clip):
        grads = [(g / g_norm) * cfg.grad_clip for g in grads]
    count = state.count + 1
    lr = schedule(state.count)
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(count))
    mu = [(1 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - ADAM_B2) * (g * g) + ADAM_B2 * v for g, v in zip(grads, state.nu)]
    updates = [-lr * ((m / bc1) / (torch.sqrt(v / bc2 + ADAM_EPS_ROOT) + ADAM_EPS))
               for m, v in zip(mu, nu)]
    return updates, OptState(count, mu, nu, notfinite)
