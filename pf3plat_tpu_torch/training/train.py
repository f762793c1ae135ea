"""Optimizer and train steps; port of `pf3plat_tpu/training/train.py`
(`OptimizerCfg`, `make_optimizer`, `TrainState`, `init_train_state`,
`make_train_step` on precomputed frozen inputs, `make_model_train_step`),
and NoPoSplat's train step (`make_noposplat_train_step`, no JAX twin).

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
(`init(params)`, `update(grads, state)`). The trainable parameters are
the architecture's (`model.trainable_parameters()`): PF3plat's encoder,
every parameter of NoPoSplat but its LPIPS VGG; the frozen modules never
get gradients.

The train steps update through `Optimizer.apply(params, grads, state)`,
in place. On the CPU it is `opt_update` followed by `p.add_`. On the card
it is two hand-written kernels over every leaf at once (`csrc/adam.cu`):
a deterministic norm-and-finite pass, one host read of its [sum of
squares, non-finite flag], the host's decision as `opt_update` makes it
(`adam_step`), then one fused clip-and-Adam pass with `opt_update`'s
float32 roundings; a non-finite step launches nothing more. Each applied
update counts the leaves and elements Adam touches (`adam.leaves`,
`adam.elements`), and one through the kernels `adam.fused_updates`, while
a profiler session records.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.rasterizer import kernels
from ..utils.profiling import count, span, stage, tracing
from .losses import LossCfg, render_loss, total_loss

MAX_CONSECUTIVE_ERRORS = 100
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
# Elements of one work item of the Adam kernels: a multiple of 4, so that
# every item starts at its leaf's 16-byte alignment.
ADAM_CHUNK = 1 << 16


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
    params: list[torch.Tensor]  # the trainable parameters, updated in place
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
    if tracing():
        count("adam.leaves", len(grads))
        count("adam.elements", sum(g.numel() for g in grads))
    g_norm = global_norm(grads)
    if not bool(g_norm < cfg.grad_clip):
        grads = [(g / g_norm) * cfg.grad_clip for g in grads]
    n = state.count + 1
    lr = schedule(state.count)
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(n))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(n))
    mu = [(1 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - ADAM_B2) * (g * g) + ADAM_B2 * v for g, v in zip(grads, state.nu)]
    updates = [-lr * ((m / bc1) / (torch.sqrt(v / bc2 + ADAM_EPS_ROOT) + ADAM_EPS))
               for m, v in zip(mu, nu)]
    return updates, OptState(n, mu, nu, notfinite)


class AdamStep(NamedTuple):
    """What the host hands the Adam kernel for one applied update."""
    norm: np.float32            # the global norm of the gradients
    clip: bool                  # scale by max_norm / norm first
    lr: float
    bc1: float                  # Adam's bias corrections at count n
    bc2: float


def adam_step(cfg: OptimizerCfg, schedule, state: OptState, sumsq: float, nonfinite: bool
              ) -> tuple[AdamStep | None, OptState]:
    """`opt_update`'s decisions from the gradients' sum of squares and
    whether any element is not finite -> (the update to apply, or None
    where `apply_if_finite` skips it; the next state, its moments the same
    tensors, updated in place by the kernel)."""
    finite = not nonfinite
    notfinite = 0 if finite else state.notfinite_count + 1
    if not (finite or notfinite > MAX_CONSECUTIVE_ERRORS):
        return None, state._replace(notfinite_count=notfinite)
    norm = np.sqrt(np.float32(sumsq))
    n = state.count + 1
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(n))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(n))
    step = AdamStep(norm, not bool(norm < np.float32(cfg.grad_clip)), schedule(state.count),
                    bc1, bc2)
    return step, OptState(n, state.mu, state.nu, notfinite)


def adam_work_list(params, mu, nu) -> np.ndarray:
    """The Adam kernels' work list: an (items, 4) int32 array of (leaf,
    start, length, vector length), each leaf cut in order into items of at
    most `ADAM_CHUNK` elements. An item's first `vector length` elements
    move in 16-byte accesses, the rest one at a time: its length rounded
    down to a multiple of 4 where the leaf's parameter and moments are
    16-byte aligned, else 0."""
    rows = []
    for leaf, ts in enumerate(zip(params, mu, nu)):
        numel = ts[0].numel()
        ok = all(t.data_ptr() % 16 == 0 for t in ts)
        if numel >= 2**31:
            raise ValueError(f"leaf {leaf}: {numel} elements, more than an int32 index")
        for start in range(0, numel, ADAM_CHUNK):
            length = min(ADAM_CHUNK, numel - start)
            rows.append((leaf, start, length, length & ~3 if ok else 0))
    return np.asarray(rows, np.int32).reshape(-1, 4)


class _AdamPlan:
    """What the Adam kernels keep for one set of parameters and moments,
    which stay in place from step to step: the work list and the pointer
    tables on the card, a pinned host table of the step's gradient
    pointers with its device copy, and the norm pass's scratch (a partial
    sum an item; the flag and ticket its last block rearms)."""

    def __init__(self, params, mu, nu):
        dev = params[0].device
        if dev.type != "cuda":
            raise ValueError(f"the Adam kernels need CUDA tensors, not {dev}")
        for name, group in (("params", params), ("mu", mu), ("nu", nu)):
            for p, t in zip(params, group):
                if t.device != dev or t.dtype != torch.float32 or t.shape != p.shape \
                        or not t.is_contiguous():
                    raise ValueError(f"{name}: want contiguous float32 tensors on {dev} "
                                     f"shaped as the parameters")
        items = adam_work_list(params, mu, nu)
        self.device = dev
        self.n_items = len(items)
        self.items = torch.from_numpy(items).to(dev)
        self.tables = [torch.tensor([t.data_ptr() for t in group], dtype=torch.int64,
                                    device=dev) for group in (params, mu, nu)]
        self.host_grads = torch.zeros(len(params), dtype=torch.int64, pin_memory=True)
        self.grads = torch.zeros(len(params), dtype=torch.int64, device=dev)
        self.partials = torch.empty(self.n_items, dtype=torch.float32, device=dev)
        self.sync = torch.zeros(2, dtype=torch.int32, device=dev)

    def set_grads(self, params, grads) -> None:
        """The step's gradient pointers to the card, one copy from pinned
        memory (the previous update's host read has waited for the last
        copy, so the host table is free)."""
        dev, f32 = self.device, torch.float32
        for p, g in zip(params, grads):
            if g is not None and (g.dtype is not f32 or g.shape != p.shape
                                  or not g.is_contiguous() or g.device != dev):
                raise ValueError(f"gradients: want contiguous float32 tensors on {dev} "
                                 f"shaped as the parameters")
        self.host_grads.numpy()[:] = [0 if g is None else g.data_ptr() for g in grads]
        self.grads.copy_(self.host_grads, non_blocking=True)


def adam_norm_cuda(plan: _AdamPlan) -> torch.Tensor:
    """The norm pass over the gradients `plan.set_grads` gave: a new (3,)
    float32 tensor [sum of squares, 1 if any element is not finite else 0,
    global norm]."""
    out = torch.empty(3, dtype=torch.float32, device=plan.device)
    ct = kernels.ctypes
    fn = kernels.load("adam").pf3_adam_norm
    fn.restype = ct.c_int
    fn.argtypes = [ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                   ct.c_void_p]
    rc = fn(kernels.ptr(plan.items), plan.n_items, kernels.ptr(plan.grads),
            kernels.ptr(plan.partials), kernels.ptr(plan.sync), kernels.ptr(out),
            kernels.stream_ptr(plan.device))
    kernels.check("adam", rc)
    kernels.LAUNCHES["adam"] += 1
    return out


def adam_update_cuda(plan: _AdamPlan, step: AdamStep, cfg: OptimizerCfg) -> None:
    """The update pass: clip, Adam and the parameter update of every leaf
    in place, with the float32 constants torch would use for
    `opt_update`'s Python scalars."""
    f32 = np.float32
    consts = (step.norm, f32(cfg.grad_clip), f32(1 - ADAM_B1), f32(ADAM_B1), f32(1 - ADAM_B2),
              f32(ADAM_B2), f32(1) / f32(step.bc1), f32(1) / f32(step.bc2), f32(ADAM_EPS_ROOT),
              f32(ADAM_EPS), f32(-step.lr))
    ct = kernels.ctypes
    fn = kernels.load("adam").pf3_adam_update
    fn.restype = ct.c_int
    fn.argtypes = [ct.c_void_p, ct.c_int, *[ct.c_void_p] * 4, ct.c_int,
                   *[ct.c_float] * len(consts), ct.c_void_p]
    params, mu, nu = plan.tables
    rc = fn(kernels.ptr(plan.items), plan.n_items, kernels.ptr(plan.grads), kernels.ptr(params),
            kernels.ptr(mu), kernels.ptr(nu), int(step.clip), *(float(c) for c in consts),
            kernels.stream_ptr(plan.device))
    kernels.check("adam", rc)
    kernels.LAUNCHES["adam"] += 1


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """`make_optimizer`'s result: `init` / `update` over `init_opt_state` /
    `opt_update` with the schedule of `cfg`, and `apply`, the update in
    place."""
    cfg: OptimizerCfg
    schedule: Callable[[int], float]
    # the Adam kernels' plan of the last parameter set, by its pointers
    _plans: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    def init(self, params) -> OptState:
        return init_opt_state(params)

    def update(self, grads, state: OptState) -> tuple[list[torch.Tensor], OptState]:
        return opt_update(self.cfg, self.schedule, grads, state)

    def apply(self, params, grads, state: OptState) -> tuple[OptState, torch.Tensor]:
        """One update of `params`, in place, from `grads` (None: a leaf
        without a gradient, zeros) -> (the next state, the gradients'
        global norm before clipping). CPU tensors take `opt_update` and
        `p.add_`; CUDA tensors the Adam kernels, which update the moments
        in place too, with one host sync."""
        if params[0].device.type != "cpu":
            return self._apply_cuda(params, grads, state)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        updates, state = self.update(grads, state)
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.add_(u)
        return state, global_norm(grads)

    def _apply_cuda(self, params, grads, state: OptState) -> tuple[OptState, torch.Tensor]:
        key = (tuple(map(torch.Tensor.data_ptr, itertools.chain(params, state.mu, state.nu))),
               tuple(map(torch.Tensor.numel, params)))
        plan = self._plans.get(key)
        if plan is None:
            self._plans.clear()
            plan = self._plans[key] = _AdamPlan(params, state.mu, state.nu)
        plan.set_grads(params, grads)
        out = adam_norm_cuda(plan)
        sumsq, flag = out[:2].tolist()  # the update's one host sync
        step, state = adam_step(self.cfg, self.schedule, state, sumsq, flag != 0.0)
        if step is not None:
            adam_update_cuda(plan, step, self.cfg)
            if tracing():
                count("adam.leaves", len(params))
                count("adam.elements", sum(p.numel() for p in params))
                count("adam.fused_updates", 1)
        return state, out[2]


def make_optimizer(cfg: OptimizerCfg) -> Optimizer:
    return Optimizer(cfg, make_schedule(cfg))


def init_train_state(model) -> TrainState:
    params = list(model.trainable_parameters())
    return TrainState(params, init_opt_state(params), 0)


def _psnr(color: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(torch.mean((color.detach() - target) ** 2),
                                           min=1e-12))


def _aux(parts: dict, color, target) -> dict:
    aux = {k: v.detach() for k, v in parts.items()}
    aux["psnr"] = _psnr(color, target)
    return aux


def _finish_step(state: TrainState, opt: Optimizer, loss, aux: dict, timer,
                 grad_sync) -> tuple[TrainState, dict]:
    """The common end of both train steps: backward, the optimizer update
    in place, the next state."""
    with stage("backward", timer):
        loss.backward()
    with stage("optimizer", timer):
        grads = [p.grad for p in state.params]
        if grad_sync is not None:  # the all-reduce wants a tensor for every leaf
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(state.params, grads)]
            grad_sync(grads)
        aux["loss"] = loss.detach()
        opt_state, aux["grad_norm"] = opt.apply(state.params, grads, state.opt_state)
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
    with "encoder", "decoder", "loss", "backward", "optimizer" as each stage
    ends (`utils.profiling.stage`)."""
    from ..models.decoder import decode

    def train_step(state: TrainState, batch, ransac_noise=None, generator=None, timer=None,
                   grad_sync=None):
        with span("pf3.train_step"):
            count("train_steps", 1)
            dev = state.params[0].device
            ctx = batch["context"]
            images, intrinsics, near, far = (ctx[k].to(dev, torch.float32)
                                             for k in ("image", "intrinsics", "near", "far"))
            target = batch["target"]["image"].to(dev, torch.float32)
            for p in state.params:
                p.grad = None
            with stage("encoder", timer):
                enc = encoder(images, intrinsics, near, far, batch["frozen"], batch["corr"],
                              state.step, ransac_noise=ransac_noise, generator=generator)
            with stage("decoder", timer):
                c2w = torch.linalg.inv(enc.refined_poses)  # (b, v, 4, 4) predicted c2w
                out = decode(decoder_cfg, enc.gaussians, c2w, intrinsics, near, far,
                             image_shape)
            with stage("loss", timer):
                loss, parts = total_loss(loss_cfg, out.color, target, enc, intrinsics,
                                         state.step, lpips_fn=lpips_apply)
                aux = _aux(parts, out.color, target)
            return _finish_step(state, opt, loss, aux, timer, grad_sync)

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
        with span("pf3.train_step"):
            count("train_steps", 1)
            ctx = batch["context"]
            target = batch["target"]["image"].to(model.device, torch.float32)
            for p in state.params:
                p.grad = None
            enc, out = model(ctx["image"], ctx["intrinsics"], ctx["near"], ctx["far"],
                             state.step, ransac_noise=ransac_noise, generator=generator,
                             timer=timer, mesh=mesh)
            lpips_fn = model.lpips_apply if loss_cfg.lpips_weight > 0.0 else None
            with stage("loss", timer):
                intrinsics = ctx["intrinsics"].to(model.device, torch.float32)
                loss, parts = total_loss(loss_cfg, out.color, target, enc, intrinsics,
                                         state.step, lpips_fn=lpips_fn)
                aux = _aux(parts, out.color, target)
            return _finish_step(state, opt, loss, aux, timer, grad_sync)

    return train_step


def make_noposplat_train_step(model, loss_cfg: LossCfg, opt_cfg: OptimizerCfg):
    """NoPoSplat's train step (`models/noposplat.py`): Gaussians from the two
    context views, renders of the targets, MSE + LPIPS, backward, update.

    The batch's `context` holds the example's view stack (image (b, v, h,
    w, 3), intrinsics, extrinsics c2w, near, far), the union of context and
    target views in frame order: its first and last views are the context,
    the views between them the targets (both views where there are only
    two), rendered at their ground-truth poses in the first view's frame
    with the context baseline scaled to 1 (`noposplat.canonical_poses`).
    `train_step(state, batch, generator=None, timer=None, grad_sync=None)
    -> (state, aux)` as `make_model_train_step`'s (the generator is unused:
    the step draws nothing); `timer` is called with "vit", "crossview",
    "heads", "decoder", "loss", "backward", "optimizer"."""
    from ..models.noposplat import canonical_poses

    opt = make_optimizer(opt_cfg)

    def train_step(state: TrainState, batch, generator=None, timer=None, grad_sync=None):
        with span("pf3.train_step"):
            count("train_steps", 1)
            ctx = batch["context"]
            images, intrinsics, extrinsics, near, far = (
                ctx[k].to(model.device, torch.float32)
                for k in ("image", "intrinsics", "extrinsics", "near", "far"))
            v = images.shape[1]
            context = [0, v - 1]
            targets = list(range(1, v - 1)) if v > 2 else context
            poses = canonical_poses(extrinsics)
            for p in state.params:
                p.grad = None
            _, out = model(images[:, context], intrinsics[:, context], poses[:, targets],
                           intrinsics[:, targets], near[:, targets], far[:, targets],
                           timer=timer)
            target = images[:, targets]
            lpips_fn = model.lpips_apply if loss_cfg.lpips_weight > 0.0 else None
            with stage("loss", timer):
                loss, parts = render_loss(loss_cfg, out.color, target, state.step,
                                          lpips_fn=lpips_fn)
                aux = _aux(parts, out.color, target)
            return _finish_step(state, opt, loss, aux, timer, grad_sync)

    return train_step
