"""`vggt_serve`: one client sends VGGT requests back to back (a closed loop).
A request is one of the seed's `pool` panned sequences of `views` frames
(`inputs.serve_scene`), held pinned on the host; it is copied to the card
without blocking and served by `model(images, timer=clock)` under no_grad,
and ends when the pose encoding, the depth and point maps and their
confidences are in pinned host buffers allocated at set-up (one
synchronisation). The check's sample of the window's requests keeps its
answer, its hooked tokens and its four pose passes, copied to the host once
the window has closed.

The check (`gaps`) follows the program stage by stage: the hooked tokens
from the images, the pose passes from the program's last pair, the depth
and point maps and their confidences from the program's hooked tokens (in
units of the reference's own gap in bfloat16, `request_gaps`).
The control is the reference in the program's place, its trunk's products
and attention in float8, its heads' products in bfloat16 and the camera
head's attention in float8 (each stated precision one step down), each
stage fed its own previous stage. `fault` plants a fault for the
check's own tests and calibration: "answer" alters the depth where it is
produced; "frame_only" confines every global block's attention to its own
frame."""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from pf3bench import check, flops, harness, inputs, spec

ANSWER = ("pose_enc", "depth", "depth_conf", "points", "points_conf")
# the control: the trunk (bfloat16) one step down, the heads (float32) one step down
CONTROL = (torch.float8_e4m3fn, torch.bfloat16)


class HeadsControl(check.Rounded):
    """The heads one precision step down: products' float32 operands in
    bfloat16 (`check.Rounded`), and the camera head's fused attention, whose
    operands the program already takes in bfloat16, with q, k and v in
    float8."""

    def __init__(self):
        super().__init__(CONTROL[1])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.attention:
            args = tuple(check.round_to(a, CONTROL[0]) for a in args[:3]) + tuple(args[3:])
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def images_of(traffic: dict, seed: int, index: int) -> torch.Tensor:
    """Request `index`'s frames (1, views, h, w, 3) as a host tensor."""
    return torch.from_numpy(inputs.serve_scene(traffic, seed, index)["images"])


@contextlib.contextmanager
def frame_only(model, frames: int):
    """The planted fault "frame_only": each global block of the program's
    aggregator takes its (b, S P, C) tokens as b S frames of P, with one
    frame's RoPE tables."""
    blocks = model.aggregator.global_blocks
    for blk in blocks:
        def confined(x, rope, inner=blk.forward):
            b, n, c = x.shape
            p = n // frames
            one = tuple(t[..., :p, :] for t in rope)
            return inner(x.reshape(b * frames, p, c), one).reshape(b, n, c)
        blk.forward = confined
    try:
        yield
    finally:
        for blk in blocks:
            del blk.forward


def run(prog, traffic: dict, seed: int, seconds: float, trace_dir, data_dir, fault=None) -> dict:
    dev, model = prog.device, prog.model
    cfg = model.cfg
    if cfg.hooks[-1] != cfg.depth - 1:
        raise ValueError("the check feeds the camera head the last hooked pair: it must be "
                         f"the last pair ({cfg.depth - 1}), not {cfg.hooks[-1]}")
    pinned = dev.type == "cuda"
    pool = [images_of(traffic, seed, i) for i in range(traffic["pool"])]
    if pinned:
        pool = [x.pin_memory() for x in pool]
    records, clocks, out = {}, [], {}
    sample = harness.Reservoir(traffic["check_requests"], seed, records)

    def request(i: int, clock, keep: bool) -> None:
        images = pool[i % len(pool)].to(dev, non_blocking=True)
        with torch.no_grad():
            got = model(images, timer=clock)
        answer = dict(zip(ANSWER, (got.pose_enc_list[-1], got.depth, got.depth_conf,
                                   got.world_points, got.world_points_conf)))
        if fault == "answer":
            answer["depth"] = answer["depth"] + 0.05
        if not out:  # the pinned host buffers, at the first (warm-up) request
            out.update({k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pinned)
                        for k, v in answer.items()})
        for k, v in answer.items():
            out[k].copy_(v, non_blocking=True)
        harness.synchronize(dev)
        if keep:  # device tensors, copied to the host once the window has closed
            records[i] = dict(index=i % len(pool), answer=answer, tokens=got.tokens,
                              passes=got.pose_enc_list)

    planted = frame_only(model, traffic["views"]) if fault == "frame_only" \
        else contextlib.nullcontext()
    with planted:
        for i in range(traffic["warmup_requests"]):
            request(traffic["pool"] + i, None, False)
        harness.synchronize(dev)
        setup_done = time.perf_counter()

        def one(i):
            clock = harness.StageClock(dev).start()
            request(i, clock, sample.take(i))
            clocks.append(clock)

        win = harness.Window(dev).run(one, seconds)
        for r in records.values():
            r.update(answer={k: harness.host(v) for k, v in r["answer"].items()},
                     tokens=harness.host(r["tokens"]), passes=harness.host(r["passes"]))
        views = traffic["views"]
        tokens = records[next(iter(records))]["tokens"][0].shape[2]
        rec = dict(setup_done=setup_done, **win, stage_ms=[c.stage_ms() for c in clocks],
                   info={"frames": views, "tokens_a_frame": tokens,
                         "global_tokens": views * tokens})
        if trace_dir is not None:
            def profiled():
                n = traffic["profile_requests"]
                for j in range(n):
                    request(10**6 + j, None, False)
                return n
            rec["trace"] = harness.profile(dev, trace_dir, profiled)
    rec["checked"] = records
    return rec


def _reference(tree: dict, device):
    arch = spec.load_module(Path(__file__).parents[1] / "architectures" / "vggt.py",
                            "pf3bench_architecture")
    return arch.build_reference(tree, device)


def control_record(ref, images: torch.Tensor) -> dict:
    """The control's record of a request: the reference in the program's
    place, the trunk's products and attention in float8, the heads'
    products in bfloat16 and the camera head's attention in float8
    (`HeadsControl`), each stage fed its own previous stage."""
    cfg = ref.cfg
    h, w = images.shape[2:4]
    with check.Rounded(CONTROL[0]):
        pairs = ref.pairs(images)
    tokens = [pairs[i] for i in cfg.hooks]
    with HeadsControl():
        passes = ref.poses(pairs[cfg.depth - 1])
        maps = ref.maps(tokens, h, w)
    return {"tokens": tokens, "passes": passes,
            "answer": {"pose_enc": passes[-1], "depth": maps["depth"],
                       "depth_conf": maps["depth_conf"], "points": maps["points"],
                       "points_conf": maps["points_conf"]}}


def request_gaps(ref, images: torch.Tensor, rec: dict, look: dict | None = None) -> dict:
    """The gaps of one request's record (the program's or the control's) to
    the reference, each stage from the record's previous one: *tokens* the
    worst hooked pair from the images, *poses* the worst of the four passes
    from the record's last pair (the answer's pose encoding is the last),
    and each map of the answer from the record's hooked tokens, in units of
    the reference's own gap one precision step below the heads' float32
    (its heads' products in bfloat16, from the same tokens; the control
    reads 1 by construction). The heads' rounding gaps swing with the
    weights, and their ratio between precisions with them (TF32 to
    bfloat16 from 3x to 48x, PERF.md): a fixed limit on a raw gap, or on
    one in TF32 units, cannot lie between the program's and the control's
    across weight draws, and this unit can."""
    cfg = ref.cfg
    h, w = images.shape[2:4]
    dev = images.device
    with torch.no_grad():
        pairs = ref.pairs(images)
        by_pair = [check.rel(a, pairs[i]) for a, i in zip(rec["tokens"], cfg.hooks)]
        del pairs
        tokens = [torch.as_tensor(t).to(dev) for t in rec["tokens"]]
        passes = ref.poses(tokens[-1])
        by_pass = [check.rel(a, b) for a, b in zip(rec["passes"], passes)]
        maps = ref.maps(tokens, h, w)
        with check.Rounded(CONTROL[1]):
            down = ref.maps(tokens, h, w)
    by_pass.append(check.rel(rec["answer"]["pose_enc"], passes[-1]))
    gaps = {"tokens": max(by_pair), "poses": max(by_pass)}
    for k in maps:
        gap, unit = check.rel(rec["answer"][k], maps[k]), check.rel(down[k], maps[k])
        gaps[k] = check.ratio(gap, unit)
        if look is not None:
            look.update({f"{k}_gap": gap, f"{k}_unit": unit})
    if look is not None:
        look.update(tokens_by_pair=by_pair, poses_by_pass=by_pass)
    return gaps


def gaps(tree: dict, rec: dict, prog_stats: dict, seed: int, device, traffic: dict,
         subject: str = "program", detail: dict | None = None) -> dict:
    """The worst gap of each number over the checked requests; with
    `subject` "control" the control in the program's place."""
    if subject not in ("program", "control"):
        raise ValueError(f"a VGGT serving check has no subject {subject!r}")
    if not rec["checked"]:
        return {"tokens": math.inf}
    ref = _reference(tree, device)
    inputs.load_weights(ref, inputs.make_weights(prog_stats, seed, device))
    worst: dict = {}
    for r in rec["checked"].values():
        images = images_of(traffic, seed, r["index"]).to(device)
        if subject == "control":
            with torch.no_grad():
                r = control_record(ref, images)
        look = None
        if detail is not None:
            look = {}
            detail.setdefault("requests", []).append(look)
        for k, v in request_gaps(ref, images, r, look).items():
            worst[k] = max(worst.get(k, 0.0), v)
        del r
    del ref
    return worst


def merge_row_blocks(calls: list[dict]) -> list[dict]:
    """The reference's attention calls with its blocks of query rows put
    back together: the calls of one (b, h, m, d) whose rows add up to whole
    calls of m queries become those calls."""
    groups: dict = {}
    for c in calls:
        groups.setdefault((c["b"], c["h"], c["m"], c["d"]), []).append(c)
    out = []
    for (b, h, m, d), group in sorted(groups.items()):
        rows = sum(c["n"] * c["count"] for c in group)
        if rows % m == 0 and any(c["n"] != m for c in group):
            out.append(dict(b=b, h=h, n=m, m=m, d=d, count=rows // m))
        else:
            out.extend(group)
    return out


def work(ref, tree: dict, traffic: dict, device) -> dict:
    """The model FLOPs of one request and its attention calls, through the
    reference (its global attention's blocks of query rows put back
    together)."""
    images = images_of(traffic, 0, 0).to(device)
    ref.requires_grad_(False)  # served: FlopCounterMode then tracks no gradient
    calls = flops.AttentionCalls()
    with torch.no_grad(), FlopCounterMode(display=False) as fc, calls:
        ref(images)
    return {"model_flops": fc.get_total_flops(),
            "attention_calls": merge_row_blocks(calls.as_list())}
