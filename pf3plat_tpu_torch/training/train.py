"""Optimizer and train steps; port of `pf3plat_tpu/training/train.py`
(`OptimizerCfg`, `make_optimizer`, `TrainState`, `init_train_state`,
`make_train_step` on precomputed frozen inputs, `make_model_train_step`).

The optimizer is written out as plain functions with optax's semantics,
not with torch's library helpers, whose edges differ:

  * schedule: `optax.cosine_onecycle_schedule(max_steps + 10, lr,
    pct_start=max(0.01, 1.5 / total))` (div 25, final div 1e4). Its phase
    ends are int(pct_start * T) and T; `torch.optim.lr_scheduler.OneCycleLR`
    ends its phases one step earlier;
  * `clip_by_global_norm`: g * (max_norm / |g|) when |g| >= max_norm
    (`clip_grad_norm_` divides by |g| + 1e-6 instead);
  * Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), the bias correction
    counting from 1;
  * `apply_if_finite(max_consecutive_errors=100)`: a non-finite gradient
    gives a zero update and leaves the inner state (moments and the
    schedule's count) alone; after more than 100 consecutive failures the
    update is applied anyway. `TrainState.step` advances either way.

`make_optimizer(cfg)` puts these functions behind optax's interface
(`init(params)`, `update(grads, state)`). Trainable parameters are the
encoder's only; the frozen modules never get gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from .losses import LossCfg, total_loss

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


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """`make_optimizer`'s result: `init` / `update` over `init_opt_state` /
    `opt_update` with the schedule of `cfg`."""
    cfg: OptimizerCfg
    schedule: Callable[[int], float]

    def init(self, params) -> OptState:
        return init_opt_state(params)

    def update(self, grads, state: OptState) -> tuple[list[torch.Tensor], OptState]:
        return opt_update(self.cfg, self.schedule, grads, state)


def make_optimizer(cfg: OptimizerCfg) -> Optimizer:
    return Optimizer(cfg, make_schedule(cfg))


def init_train_state(model) -> TrainState:
    params = list(model.encoder.parameters())
    return TrainState(params, init_opt_state(params), 0)


def _psnr(color: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(torch.mean((color.detach() - target) ** 2),
                                           min=1e-12))


def _finish_step(state: TrainState, opt: Optimizer, loss, parts, color, target, timer,
                 grad_sync) -> tuple[TrainState, dict]:
    """The common end of both train steps: aux, backward, the optimizer
    update in place, the next state."""
    aux = {k: v.detach() for k, v in parts.items()}
    aux["psnr"] = _psnr(color, target)
    if timer:
        timer("loss")
    loss.backward()
    if timer:
        timer("backward")
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in state.params]
    if grad_sync is not None:
        grad_sync(grads)
    updates, opt_state = opt.update(grads, state.opt_state)
    with torch.no_grad():
        for p, u in zip(state.params, updates):
            p.add_(u)
    aux["loss"] = loss.detach()
    aux["grad_norm"] = global_norm(grads)
    if timer:
        timer("optimizer")
    return TrainState(state.params, opt_state, state.step + 1), aux


def make_train_step(encoder, decoder_cfg, loss_cfg: LossCfg, opt: Optimizer,
                    image_shape: tuple[int, int], lpips_apply=None):
    """The train step on precomputed frozen inputs (`train.py:84-156`):
    encoder, render at the predicted poses, losses, backward, update.

    `train_step(state, batch, ransac_noise=None, generator=None, timer=None,
    grad_sync=None) -> (state, aux)`, `state.params` the encoder's
    parameters (`TrainState(list(encoder.parameters()), opt.init(...), 0)`).
    The batch holds `context` (image (b, v, h, w, 3), intrinsics, near,
    far), `target` (image: with the union trick the context stack),
    `frozen` (`FrozenInputs` of the context views) and `corr`
    (`Correspondences`); tensors are moved to the encoder's device. `aux`
    holds the loss parts, `psnr`, `loss` and `grad_norm`; `timer` is called
    with "encoder", "decoder", "loss", "backward", "optimizer"."""
    from ..models.decoder import decode

    def train_step(state: TrainState, batch, ransac_noise=None, generator=None, timer=None,
                   grad_sync=None):
        dev = state.params[0].device
        ctx = batch["context"]
        images, intrinsics, near, far = (ctx[k].to(dev, torch.float32)
                                         for k in ("image", "intrinsics", "near", "far"))
        target = batch["target"]["image"].to(dev, torch.float32)
        for p in state.params:
            p.grad = None
        enc = encoder(images, intrinsics, near, far, batch["frozen"], batch["corr"], state.step,
                      ransac_noise=ransac_noise, generator=generator)
        if timer:
            timer("encoder")
        c2w = torch.linalg.inv(enc.refined_poses)  # (b, v, 4, 4) predicted c2w
        out = decode(decoder_cfg, enc.gaussians, c2w, intrinsics, near, far, image_shape)
        if timer:
            timer("decoder")
        loss, parts = total_loss(loss_cfg, out.color, target, enc, intrinsics, state.step,
                                 lpips_fn=lpips_apply)
        return _finish_step(state, opt, loss, parts, out.color, target, timer, grad_sync)

    return train_step


def make_model_train_step(model, loss_cfg: LossCfg, opt_cfg: OptimizerCfg, mesh=None):
    """Full-pipeline train step (`train.py:159-220`): frozen perception
    without gradients, encoder, render, losses, backward, update.

    `mesh` (`parallel.Mesh`) reaches the decoder's renders.
    `train_step(state, batch, ransac_noise=None, generator=None,
    timer=None, grad_sync=None) -> (state, aux)`; `grad_sync`, if given,
    is called with the gradients before the optimizer update and averages
    them in place across processes (`parallel.shard_train_step`). The
    batch holds `context` (image (b, v, h, w, 3), intrinsics, near, far)
    and `target` (image): with the union trick the target stack is the context stack. `aux` holds the loss
    parts, `psnr`, `loss` and `grad_norm` (the global norm before
    clipping). `timer`, if given, is called with "perceive", "encoder",
    "decoder", "loss", "backward", "optimizer" as each stage ends."""
    opt = make_optimizer(opt_cfg)

    def train_step(state: TrainState, batch, ransac_noise=None, generator=None, timer=None,
                   grad_sync=None):
        ctx = batch["context"]
        target = batch["target"]["image"].to(model.device, torch.float32)
        for p in state.params:
            p.grad = None
        enc, out = model(ctx["image"], ctx["intrinsics"], ctx["near"], ctx["far"], state.step,
                         ransac_noise=ransac_noise, generator=generator, timer=timer,
                         mesh=mesh)
        lpips_fn = model.lpips_apply if loss_cfg.lpips_weight > 0.0 else None
        intrinsics = ctx["intrinsics"].to(model.device, torch.float32)
        loss, parts = total_loss(loss_cfg, out.color, target, enc, intrinsics, state.step,
                                 lpips_fn=lpips_fn)
        return _finish_step(state, opt, loss, parts, out.color, target, timer, grad_sync)

    return train_step
