"""`train`: the training loop's per-step path on one card:
`main.batch_iterator` over seeded chunk files, pinned non-blocking copies,
the model train step with the step's RANSAC generator, one scalar transfer
a step. The first `check_steps` steps run in set-up, through the same call
and feed as the window's, on the one step object that the window then
drives, and keep what the check follows. `fault` plants a fault in the
step for the check's own tests and calibration ("unchanged": the step
returns its state unchanged; "half_batch": the loss over half the batch's
rows)."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from pf3bench import check, flops, harness, inputs

# the control: the reference's training step one step below float32
CONTROL = torch.bfloat16


def run(prog, traffic: dict, seed: int, seconds: float, trace_dir, data_dir, fault=None) -> dict:
    from pf3plat_tpu_torch.main import batch_iterator, step_generator
    from pf3plat_tpu_torch.training.train import (
        ADAM_B1, init_train_state, make_model_train_step)

    dev, model, cfg = prog.device, prog.model, prog.cfg
    root = inputs.write_chunks(data_dir, traffic, seed)
    cfg.dataset.roots = [root]
    cfg.data_loader.seed = seed % 2**32
    cfg.data_loader.batch_size = traffic["batch"]
    state = init_train_state(model)
    step_fn = make_model_train_step(model, cfg.loss, cfg.optimizer)
    if fault == "unchanged":
        inner = step_fn

        def step_fn(state, batch, **kw):
            keep = [p.detach().clone() for p in state.params]
            _, aux = inner(state, batch, **kw)
            with torch.no_grad():
                for p, k in zip(state.params, keep):
                    p.copy_(k)
            return state._replace(step=state.step + 1), aux
    holder = {"step": 0}
    batches = batch_iterator(cfg, "train", 0, 1, lambda: holder["step"], traffic["batch"])

    def to_device(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    def next_batch():
        raw = next(batches)
        return {"context": {k: to_device(v) for k, v in raw["context"].items() if k != "index"},
                "target": {"image": to_device(raw["target"]["image"])}}

    recorder = check.Recorder(model)
    waits, clocks = [], []

    def step(clock, keep: dict | None):
        nonlocal state
        a = time.perf_counter()
        batch = next_batch()
        waits.append((time.perf_counter() - a) * 1e3)
        s = holder["step"]
        recorder.on = keep is not None
        if keep is not None:
            keep["batch"] = {k: harness.host(batch["context"][k]) for k in
                             ("image", "intrinsics", "near", "far")}
            keep["batch"]["target"] = harness.host(batch["target"]["image"])
        state, aux = step_fn(state, batch, generator=step_generator(seed, s, dev), timer=clock)
        recorder.on = False
        names = [k for k, v in aux.items() if v.dim() == 0]
        values = torch.stack([aux[k].float() for k in names]).tolist()  # one transfer
        if keep is not None:
            kept = recorder.take()
            keep["frozen"], keep["corr"] = harness.host(kept["frozen"]), harness.host(kept["corr"])
            keep["loss"] = float(aux["loss"])
            keep["aux"] = dict(zip(names, values))
        holder["step"] = s + 1

    checked = []
    with half_batch_loss() if fault == "half_batch" else contextlib.nullcontext():
        for s in range(traffic["check_steps"]):
            checked.append({})
            step(None, checked[-1])
            if s == 0:
                grad = [float(torch.linalg.vector_norm(m / (1 - ADAM_B1)))
                        for m in state.opt_state.mu]
    prog_out = {"loss": [c["loss"] for c in checked], "grad": grad,
                "params": [p.detach().to("cpu", copy=True) for p in state.params]}
    harness.synchronize(dev)
    setup_done = time.perf_counter()
    first_wait = len(waits)

    def one(i):
        clock = harness.StageClock(dev).start()
        step(clock, None)
        clocks.append(clock)

    win = harness.Window(dev).run(one, seconds)
    matches = [int(c["corr"][3].sum()) / traffic["batch"] for c in checked]
    rec = dict(setup_done=setup_done, **win, stage_ms=[c.stage_ms() for c in clocks],
               data_wait_ms=waits[first_wait:first_wait + win["count"]],
               info={"valid_matches_a_pair": sum(matches) / len(matches)})
    if trace_dir is not None:
        def profiled():
            n = traffic["profile_steps"]
            for _ in range(n):
                step(None, None)
            return n
        rec["trace"] = harness.profile(dev, trace_dir, profiled)
    recorder.close()
    batches.close()
    rec["checked"] = checked
    rec["program"] = prog_out
    return rec


@contextlib.contextmanager
def half_batch_loss():
    """A planted fault: the training loss, and so the gradient, taken over
    the first half of the batch's rows, the rest left out."""
    import pf3plat_tpu_torch.training.train as train_module

    whole = train_module.total_loss

    def half(x):
        if isinstance(x, torch.Tensor):
            return x[: x.shape[0] // 2]
        return type(x)(*(half(t) for t in x)) if isinstance(x, tuple) else x

    def half_loss(cfg, color, target, enc, intrinsics, step, lpips_fn=None):
        return whole(cfg, half(color), half(target), half(enc), half(intrinsics), step,
                     lpips_fn=lpips_fn)

    train_module.total_loss = half_loss
    try:
        yield
    finally:
        train_module.total_loss = whole


SUBJECTS = {"program": None, "control": CONTROL, "tf32": "tf32"}


def gaps(tree: dict, rec: dict, prog_stats: dict, seed: int, device, traffic: dict,
         subject: str = "program", detail: dict | None = None) -> dict:
    """The reference's first steps from the seed's weights, following the
    program's batches and perception outputs, against the program's; with
    `subject` "control" the control (the reference a precision step down)
    in the program's place, with "tf32" the reference with its products'
    operands rounded to TF32 (a witness of what the program's own
    precision does to the numbers)."""
    ref = check.build_reference(tree, device)
    w0 = inputs.make_weights(prog_stats, seed, device)
    inputs.load_weights(ref, w0)
    names = [n for n, _ in ref.encoder.named_parameters(prefix="encoder")]
    w0 = [w0[n].detach().cpu().clone() for n in names]
    want = check.reference_steps(ref, rec["checked"], tree, seed, device)
    if subject == "program":
        got = rec["program"]
    else:
        inputs.load_weights(ref, inputs.make_weights(prog_stats, seed, device))
        got = check.reference_steps(ref, rec["checked"], tree, seed, device, SUBJECTS[subject])
    del ref
    numbers, look = check.train_gaps(got, want, w0, names)
    if detail is not None:
        detail.update(look, reference_loss=want["loss"], subject_loss=got["loss"])
    return numbers


def work(ref, tree: dict, traffic: dict, device) -> dict:
    """The model FLOPs of one step at the mix's batch, over the reference."""
    return flops.train_flops(ref, tree, traffic, device)
