"""`serve`: one client sends evaluation requests back to back (a closed
loop). A request is `PF3plat.forward` on host arrays, rendering the
request's views; it ends when the rendered colors and the refined poses
are host numpy arrays. `fault="answer"` alters each answer where it is
produced (for the check's own tests)."""

from __future__ import annotations

import torch

from pf3bench import check, flops, harness

# the control: perception (bfloat16) one step down, the rest (float32) one step down
CONTROL = (torch.float8_e4m3fn, torch.bfloat16)


def run(prog, traffic: dict, seed: int, seconds: float, trace_dir, data_dir, fault=None) -> dict:
    def respond(model, args, gen, clock):
        enc, out = model(*args, 0, render_views=True, generator=gen, timer=clock)
        color = out.color.cpu().numpy()
        if fault == "answer":
            color[..., 0] += 0.05
        return enc, dict(color=color, refined_poses=enc.refined_poses.cpu().numpy())

    return harness.serve(prog, traffic, seed, seconds, trace_dir, respond)


def answer(model, gaussians, poses, rec: dict, device) -> dict:
    """The request's answer worked out by the reference."""
    return {"color": check.render_views(model, gaussians, poses, rec, device)}


def gaps(tree: dict, rec: dict, prog_stats: dict, seed: int, device, traffic: dict,
         subject: str = "program", detail: dict | None = None) -> dict:
    return harness.serve_gaps(tree, rec, prog_stats, seed, device, subject, answer, CONTROL,
                              detail)


def work(ref, tree: dict, traffic: dict, device) -> dict:
    """One request through the reference (for the FLOP count)."""
    return flops.serve_request(ref, traffic, device, answer)
