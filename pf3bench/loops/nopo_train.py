"""`nopo_train`: NoPoSplat's training step on one card over a pool of
decoded batches. Set-up decodes `pool` batches of the mix's view count
through `main.batch_iterator` over seeded chunk files (the union of 2
context and `views - 2` target frames; batches with a repeated frame, and
so fewer views, are skipped) and holds them pinned on the host; each step
copies the next batch to the card without blocking, as a loader whose
workers keep ahead of the card would hand it over (`re10k-train.b14`
measures the decoding itself). The first `check_steps` steps run in
set-up through the same step object the window drives and keep what the
check follows. `fault` plants a fault for the check's own tests and
calibration ("unchanged": the step returns its state unchanged;
"half_batch": the loss over half the batch's rows)."""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from pf3bench import check, flops, harness, inputs, spec
from pf3bench.reference.models.noposplat import (
    RenderLossCfg, context_gaussians, render_loss, step_loss)
from pf3bench.reference.models.types import Gaussians
from pf3bench.reference.precision import reference_precision
from pf3bench.reference.training.train import (
    ADAM_B1, OptimizerCfg, init_opt_state, make_schedule, opt_update)

KEYS = ("image", "intrinsics", "extrinsics", "near", "far")
# scenes a block of the reference's network: its float32 activations for
# the whole batch do not fit the card beside the renders' plain backward
BLOCK = 4
# the control: the reference's training step one step below float32
SUBJECTS = {"program": None, "control": torch.bfloat16}


def pool_batches(cfg, traffic: dict, pinned: bool) -> list[dict]:
    """`traffic["pool"]` batches of `traffic["views"]` views from
    `main.batch_iterator`, as host tensors (pinned on a card's machine)."""
    from pf3plat_tpu_torch.main import batch_iterator

    batches = batch_iterator(cfg, "train", 0, 1, lambda: 0, traffic["batch"])
    pool = []
    try:
        while len(pool) < traffic["pool"]:
            raw = next(batches)["context"]
            if raw["image"].shape[1] != traffic["views"]:
                continue
            host = {k: torch.from_numpy(np.ascontiguousarray(raw[k], np.float32)) for k in KEYS}
            pool.append({k: t.pin_memory() if pinned else t for k, t in host.items()})
    finally:
        batches.close()
    return pool


def run(prog, traffic: dict, seed: int, seconds: float, trace_dir, data_dir, fault=None) -> dict:
    from pf3plat_tpu_torch.training.train import init_train_state, make_noposplat_train_step

    dev, model, cfg = prog.device, prog.model, prog.cfg
    cfg.dataset.roots = [inputs.write_chunks(data_dir, traffic, seed)]
    cfg.data_loader.seed = seed % 2**32
    pool = pool_batches(cfg, traffic, dev.type == "cuda")
    state = init_train_state(model)
    step_fn = make_noposplat_train_step(model, cfg.loss, cfg.optimizer)
    if fault == "unchanged":
        inner = step_fn

        def step_fn(state, batch, **kw):
            keep = [p.detach().clone() for p in state.params]
            _, aux = inner(state, batch, **kw)
            with torch.no_grad():
                for p, k in zip(state.params, keep):
                    p.copy_(k)
            return state._replace(step=state.step + 1), aux
    counter = {"step": 0}

    def step(clock) -> dict:
        nonlocal state
        i = counter["step"]
        batch = {"context": {k: t.to(dev, non_blocking=True) for k, t in
                             pool[i % len(pool)].items()}}
        state, aux = step_fn(state, batch, timer=clock)
        names = [k for k, v in aux.items() if v.dim() == 0]
        values = torch.stack([aux[k].float() for k in names]).tolist()  # one transfer
        counter["step"] = i + 1
        return dict(zip(names, values))

    checked = []
    with half_batch_loss() if fault == "half_batch" else contextlib.nullcontext():
        for s in range(traffic["check_steps"]):
            checked.append({"batch": s % len(pool), "loss": step(None)["loss"]})
            if s == 0:
                grad = [float(torch.linalg.vector_norm(m / (1 - ADAM_B1)))
                        for m in state.opt_state.mu]
    prog_out = {"loss": [c["loss"] for c in checked], "grad": grad,
                "params": [p.detach().to("cpu", copy=True) for p in state.params]}
    harness.synchronize(dev)
    setup_done = time.perf_counter()
    clocks = []

    def one(i):
        clock = harness.StageClock(dev).start()
        step(clock)
        clocks.append(clock)

    win = harness.Window(dev).run(one, seconds)
    rec = dict(setup_done=setup_done, **win, stage_ms=[c.stage_ms() for c in clocks],
               info={"parameters": sum(p.numel() for p in state.params),
                     "pool": len(pool)})
    if trace_dir is not None:
        def profiled():
            n = traffic["profile_steps"]
            for _ in range(n):
                step(None)
            return n
        rec["trace"] = harness.profile(dev, trace_dir, profiled)
    for c in checked:
        c["batch"] = pool[c["batch"]]
    rec["checked"] = checked
    rec["program"] = prog_out
    return rec


@contextlib.contextmanager
def half_batch_loss():
    """A planted fault: the loss, and so the gradient, taken over the
    first half of the batch's rows, the rest left out."""
    import pf3plat_tpu_torch.training.train as train_module

    whole = train_module.render_loss

    def half_loss(cfg, color, target, step, lpips_fn=None):
        n = color.shape[0] // 2
        return whole(cfg, color[:n], target[:n], step, lpips_fn=lpips_fn)

    train_module.render_loss = half_loss
    try:
        yield
    finally:
        train_module.render_loss = whole


def train_cfgs(tree: dict) -> tuple[RenderLossCfg, OptimizerCfg]:
    return (check.fill(RenderLossCfg, tree.get("loss", {})),
            check.fill(OptimizerCfg, tree.get("optimizer", {})))


def reference_steps(ref, steps: list[dict], tree: dict, device, precision=None) -> dict:
    """The reference's own training from the weights loaded in `ref` over
    the program's batches: each step's loss, the first gradient as Adam
    gets it (from its first moment), the first raw gradient's leaf norms
    and the trained parameters after the last step. The render and the loss
    take the whole batch, as the program's do (kernel B1's pair budget is a
    share of the whole batch's pairs); the network runs in blocks of
    `BLOCK` scenes (`blocked_backward`)."""
    loss_cfg, opt_cfg = train_cfgs(tree)
    schedule = make_schedule(opt_cfg)
    params = [p for _, p in ref.trainable()]
    for p in params:
        p.requires_grad_(True)
    state = init_opt_state(params)
    out = {"loss": []}
    ctx = check.Rounded(precision) if precision is not None else contextlib.nullcontext()
    with reference_precision():
        for step, rec in enumerate(steps):
            batch = {k: v.to(device) for k, v in rec["batch"].items()}
            for p in params:
                p.grad = None
            with ctx:
                loss = blocked_backward(ref, batch, loss_cfg, step)
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if step == 0:
                out["raw_grad"] = [float(torch.linalg.vector_norm(g)) for g in grads]
            updates, state = opt_update(opt_cfg, schedule, grads, state)
            with torch.no_grad():
                for p, u in zip(params, updates):
                    p.add_(u)
            out["loss"].append(loss)
            if step == 0:
                out["grad"] = [float(torch.linalg.vector_norm(m / (1 - ADAM_B1)))
                               for m in state.mu]
            del grads, updates
    out["params"] = [p.detach().to("cpu", copy=True) for p in params]
    return out


def blocked_backward(ref, batch: dict, cfg: RenderLossCfg, step: int) -> float:
    """The step's loss and its gradients in the reference's parameters,
    with the network's activations held for `BLOCK` scenes at a time: the
    Gaussians of every block without a graph, the whole batch's render and
    loss backward to them, then each block's network again, back-propagated
    from its rows of that gradient. The same arithmetic as one backward
    through the whole step (float32 is deterministic here), in a block's
    memory."""
    b = batch["image"].shape[0]
    blocks = [slice(lo, lo + BLOCK) for lo in range(0, b, BLOCK)]
    with torch.no_grad():
        fields = [context_gaussians(ref, batch, rows) for rows in blocks]
    g = [torch.cat(f).requires_grad_(True) for f in zip(*fields)]
    del fields
    loss, _ = render_loss(ref, Gaussians(*g), batch, cfg, step)
    loss.backward()
    for rows in blocks:
        torch.autograd.backward(context_gaussians(ref, batch, rows), [x.grad[rows] for x in g])
    return float(loss.detach())


def _reference(tree: dict, device):
    arch = spec.load_module(Path(__file__).parents[1] / "architectures" / "noposplat.py",
                            "pf3bench_architecture")
    return arch.build_reference(tree, device)


def gaps(tree: dict, rec: dict, prog_stats: dict, seed: int, device, traffic: dict,
         subject: str = "program", detail: dict | None = None) -> dict:
    """The reference's first steps from the seed's weights over the
    program's batches against the program's (`check.train_gaps`: the worst
    step's loss, the worst leaf's first gradient and change, the median
    leaf's change); with `subject` "control" the control (the reference
    with every product's operands in bfloat16) in the program's place."""
    if subject not in SUBJECTS:
        raise ValueError(f"a NoPoSplat training check has no subject {subject!r}")
    ref = _reference(tree, device)
    w0 = inputs.make_weights(prog_stats, seed, device)
    inputs.load_weights(ref, w0)
    names = [n for n, _ in ref.trainable()]
    w0 = [w0[n].detach().cpu().clone() for n in names]
    want = reference_steps(ref, rec["checked"], tree, device)
    if subject == "program":
        got = rec["program"]
    else:
        inputs.load_weights(ref, inputs.make_weights(prog_stats, seed, device))
        got = reference_steps(ref, rec["checked"], tree, device, SUBJECTS[subject])
    del ref
    if not rec["checked"]:
        return {"loss": math.inf}
    numbers, look = check.train_gaps(got, want, w0, names)
    if detail is not None:
        detail.update(look, reference_loss=want["loss"], subject_loss=got["loss"])
    return numbers


def random_batch(traffic: dict, tree: dict, b: int, device) -> dict:
    """A batch of `b` view stacks of the mix's shapes: random images, the
    mix's intrinsics, cameras 0.02 apart along x, the tree's near and far."""
    v = traffic["views"]
    h, w = tree["dataset"]["image_shape"]
    r = inputs.rng(0, inputs.SCENES)
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    extr[..., 0, 3] = 0.02 * np.arange(v, dtype=np.float32)
    host = {"image": r.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32),
            "intrinsics": inputs.intrinsics(traffic, v)[None].repeat(b, 0),
            "extrinsics": extr,
            "near": np.full((b, v), tree["dataset"].get("near", 1.0), np.float32),
            "far": np.full((b, v), tree["dataset"].get("far", 100.0), np.float32)}
    return {k: torch.as_tensor(x, device=device) for k, x in host.items()}


def work(ref, tree: dict, traffic: dict, device) -> dict:
    """The model FLOPs of one training step at the mix's batch (every
    trained module forward and backward, the frozen LPIPS VGG forward and
    its gradient to the images) and the step's forward attention calls,
    over the reference: both grow with the batch alone, so two batch sizes
    give the FLOPs and one the calls."""
    loss_cfg, _ = train_cfgs(tree)
    for _, p in ref.trainable():
        p.requires_grad_(True)
    got = []
    for b in (1, 2):
        calls = flops.AttentionCalls()
        with FlopCounterMode(display=False) as fc, calls:
            loss, _ = step_loss(ref, random_batch(traffic, tree, b, device), loss_cfg, 0)
            loss.backward()
        got.append((fc.get_total_flops(), calls.as_list()))
        ref.zero_grad(set_to_none=True)
    (one, calls), (two, _) = got
    batch = traffic["batch"]
    return {"model_flops": one + (batch - 1) * (two - one),
            "attention_calls": [dict(c, b=c["b"] * batch) for c in calls]}
