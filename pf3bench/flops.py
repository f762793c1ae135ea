"""The model FLOPs of one request or training step of a cell, and its
attention calls, counted once over the benchmark's plain reference (never
over the port) and kept as data in `cells/<workload>.json`:

    python3 -m pf3bench.flops --workload <name> [--device cuda] [--write]

`torch.utils.flop_counter.FlopCounterMode` counts the products and
convolutions (and attention as its two products) the reference executes.
Training counts perception forward only (it is frozen and takes no
gradient), the trained encoder, decoder and losses forward plus their
backward (twice forward), and the frozen LPIPS VGG forward plus its
gradient to the images (once forward); recomputation is not counted, so
the reference runs without remat here. The attention calls are every
`F.scaled_dot_product_attention` call of a request, with its shape.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import FlopCounterMode

from . import check, inputs
from .spec import Benchmark


class AttentionCalls(TorchFunctionMode):
    """Records (b, h, n, m, d) of each SDPA call; batch and heads fold into
    b (h = 1)."""

    def __init__(self):
        super().__init__()
        self.calls: dict[tuple, int] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.scaled_dot_product_attention:
            q, k = args[0], args[1]
            key = (int(np.prod(q.shape[:-2])), 1, q.shape[-2], k.shape[-2], q.shape[-1])
            self.calls[key] = self.calls.get(key, 0) + 1
        return func(*args, **kwargs)

    def as_list(self) -> list[dict]:
        return [dict(b=b, h=h, n=n, m=m, d=d, count=c)
                for (b, h, n, m, d), c in sorted(self.calls.items())]


@contextlib.contextmanager
def no_remat():
    """Checkpointed calls run plainly, so no recomputation is counted."""
    orig = torch.utils.checkpoint.checkpoint
    torch.utils.checkpoint.checkpoint = lambda fn, *a, use_reentrant=None, **k: fn(*a, **k)
    try:
        yield
    finally:
        torch.utils.checkpoint.checkpoint = orig


def serve_request(ref, traffic: dict, device, answer) -> dict:
    """The FLOPs and attention calls of one request of a serving mix
    through the reference; `answer` is the loop's answer worked out by the
    reference."""
    sc = inputs.serve_scene(traffic, 0, 0)
    req = dict(sc, ransac_seed=0)
    calls = AttentionCalls()
    with FlopCounterMode(display=False) as fc, calls:
        frozen, corr = check.perceive(ref, sc["images"], sc["intrinsics"], device)
        enc = check.encode(ref, req, (frozen.depth, frozen.features), tuple(corr), device)
        answer(ref, enc.gaussians, enc.refined_poses, req, device)
    return {"model_flops": fc.get_total_flops(), "attention_calls": calls.as_list()}


def train_step(ref, tree: dict, traffic: dict, batch: int, device) -> None:
    """One training step of the reference on a random batch of `batch`."""
    from .reference.training.losses import total_loss

    loss_cfg, _ = check.train_cfgs(tree)
    h, w = tree["dataset"]["image_shape"]
    v = 3
    r = inputs.rng(0, inputs.SCENES)
    images = torch.as_tensor(r.uniform(0, 1, (batch, v, h, w, 3)).astype(np.float32), device=device)
    intr = torch.as_tensor(inputs.intrinsics(traffic, v)[None].repeat(batch, 0), device=device)
    near = torch.ones((batch, v), device=device)
    far = torch.full((batch, v), 100.0, device=device)
    with torch.no_grad():
        frozen, corr = ref.perceive(images, intr)
    for p in ref.encoder.parameters():
        p.requires_grad_(True)
    enc = ref.encoder(images, intr, near, far, frozen, corr, 0,
                      generator=torch.Generator(device=device).manual_seed(0))
    color = check.decode(ref.cfg.decoder, enc.gaussians, torch.linalg.inv(enc.refined_poses),
                         intr, near, far, (h, w)).color
    loss, _ = total_loss(loss_cfg, color, images, enc, intr, 0,
                         lpips_fn=ref.lpips_apply if loss_cfg.lpips_weight > 0 else None)
    loss.backward()


def train_flops(ref, tree: dict, traffic: dict, device) -> dict:
    """The FLOPs of one training step at the mix's batch: perception and
    the encoder are per example, so two batch sizes give the count."""
    got = []
    for b in (1, 2):
        with FlopCounterMode(display=False) as fc:
            train_step(ref, tree, traffic, b, device)
        got.append(fc.get_total_flops())
        ref.zero_grad(set_to_none=True)
    return {"model_flops": got[0] + (traffic["batch"] - 1) * (got[1] - got[0])}


def count(bench: Benchmark, workload: str, device) -> dict:
    """The work of one request or step of `workload`, counted by its loop's
    `work` over the reference of the cell's architecture."""
    cell = bench.cell(workload)
    tree = bench.config(cell["config"])["config"]
    traffic = bench.traffic(cell["traffic"])
    arch = bench.architecture(cell["config"])
    ref = arch.build_reference(tree, device)
    inputs.load_weights(ref, inputs.make_weights(inputs.leaf_statistics(ref), 0, device))
    with arch.reference_precision(), no_remat():
        return bench.loop(traffic["kind"]).work(ref, tree, traffic, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--write", action="store_true",
                    help="merge the counts into cells/<workload>.json")
    args = ap.parse_args(argv)
    bench = Benchmark()
    got = count(bench, args.workload, torch.device(args.device))
    print(json.dumps({"workload": args.workload, **got}))
    if args.write:
        path = bench.here / "cells" / f"{args.workload}.json"
        data = bench.work(args.workload)
        data.update(got)
        path.write_text(json.dumps(data, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
