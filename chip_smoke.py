#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (pf3plat_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only (quick)
    python3 chip_smoke.py --attention-ablations  # where the forward attention
                                     # kernel's time goes (measurement builds)
    python3 chip_smoke.py --bwd-ablations  # where kernel B3's time goes
                                     # (measurement builds)
    python3 chip_smoke.py --fwd-ablations  # where kernels B2's and B6's
                                     # time goes (measurement builds)
    python3 chip_smoke.py --main     # build, one training step of record,
                                     # then phases main_train, main_test and
                                     # trace only

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  - GPU name and power limit (nvidia-smi), build of the nine
               kernel libraries;
     env     - what the machine offers the port: Python, torch and CUDA
               versions, which of PIL, yaml, safetensors, orbax, numpy,
               scipy, triton, einops import and their versions, g++,
               nvJPEG's library and header, host cores and memory;
  2. b1..b7_bench - the hand-written kernels (compact_pairs = B1,
               composite_fwd = B2, composite_bwd = B3, dup_reduce = B4,
               composite_bwd_blocks = B5, table_fwd = B6, table_bwd = B7)
               against their plain PyTorch versions on bench.py's scene (2
               views, 131,072 gaussians; fixed upstream gradients from numpy
               seeds 1 and 2); B5's merged blocks against B3's output; B2,
               B3, B5, B6 and B7 with the CTAs per SM the build reaches (B1,
               B2, B6, B7 also their registers), B3, B5, B6, B7 their shared
               memory, two runs bit-equal (B1 too, with its device
               operations); B2 and B6 with the work their data asks for
               (`fwd_work`, `table_fwd_work`);
     b1_sweep - B1 bit for bit against its plain version at the edges of
               its window rule (windows of 512, 4,096, 4,224 and 8,192 rows,
               the last two walked in several 4,096-row slices, a candidate
               count no multiple of any, none, some and all rows valid,
               the budgets at which a window is just appended and just
               dropped);
     bwd_sweep - B3 and B5 against their plain versions, merged B5 against
               B3, at the edges of their sub-block walk (segments starting
               and ending mid-chunk and mid-sub-block at chunk 128 and 64,
               one channel, tiles saturating inside their first sub-block,
               nproc of 0 and of n_chunks, tiles of 32 x 32 and 24 x 24
               pixels walked in parts, tiles of 12 x 12 and 20 x 20 pixels
               with idle lanes); B6 and B7 against their plain versions on
               the walks' table layout (nproc of 0 and of n_chunks, counts
               of 0 and past the capacity, one channel, saturating rows,
               tiles of 32 x 32 at chunk 128 and 64 and of 24 x 24 walked in
               parts, of 12 x 12 and 20 x 20 with idle lanes);
     attn_fwd_*, attn_bwd_* - the attention kernels against their plain
               versions at the training step's shapes (pose stack (9, 4,
               4097, 32), the same stacks without the pose token (9, 4, 2401,
               32), the frozen ViT for 9 views, read from the model's
               configuration) and, forward only, the serving request's (5
               views), two runs bit-equal, with SDPA on the same tensors as
               yardstick and the CTAs per SM the build reaches;
     attn_sweep - both kernels against their plain versions at ragged sizes
               (1 to 2,401 queries and keys around the tile sizes, n != m,
               head dims 32 and 64);
  3. render_fwd_bwd - the bench scene through `render`, forward and
               backward with autograd, once per kernel backend (`streamed`,
               `pallas`) and once each in 12 x 12 tiles: ms and
               Mrays/s (bench.py's definition), and the rasterizer's image
               and gradients against the same screen-space gaussians
               rendered on the CPU (plain versions);
     mesh_render - the bench scene through `render(..., mesh=)` on a
               (data=1, tile=4) mesh of the one card, three ways (`streamed`
               without compaction = the B5 path, `streamed` shard-local,
               `pallas`): image and gradients against the unsharded render;
  4. serve   - the full-width RE10K serving request (b=1, v=5, 256x256,
               ViT-L UniDepth, 1024 keypoints, 9 LightGlue layers, 128 depth
               candidates, SH degree 4, production rasterizer config), random
               weights from a seed, under torch.no_grad(): a warm-up, then 3
               timed requests with the launch counters zeroed just before and
               read just after; once with the `streamed` decoder (then b1/b2
               on the served request's own gaussians and a CPU reference
               render of one view) and once with `DecoderCfg(impl="pallas")`
               (then b6 on the same gaussians; the two decoders' images are
               compared and the difference printed);
  5. depth   - `decode(..., depth_mode="depth")` on the served request's
               gaussians through both kernel backends;
     perceive_precision - `PF3plat.perceive` on the serving request under
               bf16 autocast (the default), in float32 ("highest") and in
               float32 with bf16-rounded matmul / convolution operands (the
               JAX package's rule): ms of each, depth, feature and match
               differences from "highest";
  6. train   - the training step of record (configs/re10k.yaml: the same
               model, b=3, v=3 at 256x256 with the target stack = the
               context stack, LossCfg(), OptimizerCfg()), random weights from
               a seed: a warm-up step, then 2 timed steps split into
               perceive / encoder / decoder / loss / backward / optimizer by
               CUDA events, with the launch counters zeroed just before and
               read just after; once per kernel backend, plus one `streamed`
               step without budget truncation whose loss and gradient norm
               the `pallas` step must match; `train_mesh`: the same step
               through a (data=2, tile=2) mesh of the one card, once without
               compaction (B2 and B5 four times a step; loss and gradient
               norm against the unsharded step, which then runs once more
               for its own spread) and once with the production
               config (shard-local: B1-B4 four times a step); then b1..b7 on
               the warm-up step's own render inputs (9 cameras of 131,072
               gaussians);
     train_frozen - `make_train_step` (the step on precomputed frozen
               inputs from `perceive`) on the same batch: one timed step
               after a warm-up, B1-B4 once, loss and gradient norm equal to
               `make_model_train_step`'s from the same parameters and
               generator (1e-4 relative);
  7. main_train - the training entry point, `main([...])` as
               `python -m pf3plat_tpu_torch.main` runs it, on
               configs/re10k.yaml at full width (b=3: the published
               single-GPU protocol; everything else as the config says) over
               synthetic chunks from numpy seed 0 in build/main_data (a
               `.pfchunk` root and a `.torch` root, 2 chunks x 2 scenes x 80
               frames of 360 x 640 JPEGs): run A trains 4 steps with
               validation and checkpoints every 2 steps (keep 2), run B
               resumes it for a fifth. Per step: ms, the ms the loop waited
               for its batch (data_wait_ms), the stage split by CUDA events,
               peak memory, launches. Gates: finite losses; step 1's loss
               equal to a direct make_model_train_step call on the batch main
               drew with the same generator (1e-5 relative); checkpoints 2
               and 4, `frozen/` once; validation folders of steps 0, 2, 4
               with comparison.png and wobble.gif; 4 log rows; launches per
               step equal to the train phase's; run B resumed from step 4
               with the saved tensors bit for bit and one finite step;
     main_test - the serving entry point, `main([...])` as `python -m
               pf3plat_tpu_torch.main configs/re10k_test.yaml` runs it, at
               full width over the test splits of the same data (8 scenes:
               2 roots x 2 chunks x 2), restored from main_train's
               checkpoints, through an evaluation index in the released
               schema (context [i, i + 45], 3 targets, one null key), with
               depth panels and 30-frame videos; the index generator's CLI
               first on each root. Gates: the restore line; 8 finite scores;
               benchmark.json's count 8 - 5; torch.cuda memory numbers;
               every artifact; request 0's PSNR equal to a direct forward on
               its batch and generator (1e-5 relative); launches per request
               = the serve phase's plus one B1 and one B2 for each extra
               render (depth, 2 x 5 video chunks). Per request: ms, launches;
               the benchmark median, peak bytes, the first batch's wait;
     trace   - in a child process (`--trace-child`): torch.profiler windows
               over two warm steps of main's loop and one serving request;
               per window device-busy ms against wall ms (the idle share)
               and the ten operations with the most device time, traces
               under build/traces/; fails on a window without device
               events. `late_probe`: one short session in this process;
  8. the kernels line, the nvidia-smi line, and the final
     {"ok": true, "device": ...} line.

It imports nothing of JAX. Without CUDA, or outside a checkout of the
repository, it fails before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
LOG = REPO / "build" / "chip_smoke.jsonl"
SEED = 0
TOL_B2 = 1e-5
# B3 per channel: max|kernel - plain| <= TOL_B3 * max|plain| (256-pixel sums
# taken in another order); B4 bit-exact.
TOL_B3 = 1e-4
# Operations per (pixel, in-segment pair) evaluation, counted from the
# kernels' sources: B2 ~20 FP32 + 3 SFU; B3 repeats B2's forward sweep and
# adds ~59 in its reverse sweep (see csrc/composite_bwd.cu).
OPS_B2, OPS_B3 = 23, 82
# B6 and B7 run the same per-evaluation arithmetic over dense tables
# (csrc/table_fwd.cu, csrc/table_bwd.cu).
OPS_B6, OPS_B7 = OPS_B2, OPS_B3
# Streamed and dense-table images of one request differ where a pixel
# saturates (their chunk boundaries differ): at most the T left at a reset,
# < 1e-2, times a colour. Gated only when the pair budget did not overflow.
TOL_BACKENDS = 2e-2
# Loss and gradient norm of a training step, dense tables against the
# streamed backend without budget truncation: the same pairs, composited in
# chunks that start at other slots (saturated pixels differ slightly).
TOL_TRAIN_BACKENDS = 1e-2
# Shard-local mesh render against the unsharded one: a tile's chunks start
# at other pairs (offsets into the shard's own sorted array), so a saturated
# pixel resets its transmittance elsewhere (the reason of TOL_BACKENDS): at
# most the T left at a reset, < 1e-2, times a colour in the image, on few
# pixels (the mean is printed), and the same share of a field's largest
# gradient. Gated only where no shard's budget overflowed.
TOL_SHARD_LOCAL_IMG = TOL_BACKENDS
TOL_SHARD_LOCAL_GRAD = 1e-2
# Loss and gradient norm of the B5-path sharded training step against the
# unsharded step without compaction (the same pairs in the same chunks).
TOL_TRAIN_MESH = 1e-4
# kernels the model's own layers launch per request / per training step
MODEL_FWD_KERNELS = ("attention_fwd",)
MODEL_TRAIN_KERNELS = ("attention_fwd", "attention_bwd")
# kernels each decoder backend must launch: forward (serving), and training
FWD_KERNELS = {"streamed": ("compact_pairs", "composite_fwd"), "pallas": ("table_fwd",)}
TRAIN_KERNELS = {"streamed": ("compact_pairs", "composite_fwd", "composite_bwd", "dup_reduce"),
                 "pallas": ("table_fwd", "table_bwd")}
# Published H100 peaks (NVIDIA data sheet; SXM part, PCIe part).
PEAKS = {"sxm": dict(bw=3.35e12, fp32=67e12, bf16=989e12),
         "pcie": dict(bw=2.0e12, fp32=51e12, bf16=756e12)}
# Merged B5 blocks against B3's dP (one arithmetic, shared source): relative
# to the largest gradient; exact equality is reported beside it.
TOL_B5_B3 = 1e-6
# Attention kernels against their plain versions, relative to the largest
# magnitude of each output: bf16-rounded probabilities and dS, f32 sums taken
# in another order, a fast exp. The log-sum-exp is f32 throughout.
TOL_ATTN = 1e-2
TOL_LSE = 1e-3
# Least scale of a gradient's gate in the ragged-size sweep, as a share of
# the largest value among dq, dk and dv of the same case.
SWEEP_FLOOR = 1e-3
# The pose and depth stacks' attention at the training batch (b * v = 9
# views, 4 heads, 64 x 64 tokens + the pose token, head dim 32).
ATTN_POSE_SHAPE = (9, 4, 4097, 4097, 32)
# The same stacks' layers without the pose token (49 x 49 tokens).
ATTN_DEPTH_SHAPE = (9, 4, 2401, 2401, 32)
# Views of the serving request (b = 1): its attention shapes are the pose
# stack's and the ViT's at this batch.
SERVE_VIEWS = 5


def ptxas_registers(report: str, kernel: str = "") -> int | None:
    """The register count in an `-Xptxas -v` report of the first kernel
    whose mangled name contains `kernel`."""
    entry = None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entry = ln
        elif "Used" in ln and "registers" in ln and kernel in (entry or ""):
            return int(ln.split("Used")[1].split("registers")[0])
    return None


def emit(obj) -> None:
    """Print one JSON line, and append it to build/chip_smoke.jsonl in the
    checkout (the whole run's record where a caller keeps only the end of
    the output)."""
    line = json.dumps(obj)
    print(line, flush=True)
    LOG.parent.mkdir(exist_ok=True)
    with LOG.open("a") as f:
        f.write(line + "\n")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_scene(device):
    """bench.py's scene (bench.py:69-110), numpy seed 0, as the decoder
    renders it: b*v = 2 cameras, 131,072 gaussians each."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    b, v, h, w = 1, 2, 256, 256
    n = 2 * h * w
    xs = rng.uniform(-2, 2, (b, n))
    ys = rng.uniform(-2, 2, (b, n))
    surf_z = 4.0 + 0.3 * np.sin(3 * xs) * np.cos(2 * ys)
    far_z = rng.uniform(8.0, 12.0, (b, n))
    is_far = rng.random((b, n)) < 0.3
    means = np.stack([xs, ys, np.where(is_far, far_z, surf_z)], axis=-1)
    scales = rng.uniform(0.004, 0.012, (b, n, 3))
    cov = np.zeros((b, n, 3, 3))
    for i in range(3):
        cov[..., i, i] = scales[..., i] ** 2
    sh = (rng.standard_normal((b, n, 3, 25)) * 0.2).astype(np.float32)
    opac = np.where(is_far, rng.uniform(0.2, 0.6, (b, n)), rng.uniform(0.7, 0.99, (b, n)))

    def to(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    rep = lambda x: x.repeat_interleave(v, dim=0)  # noqa: E731
    extr = to(np.broadcast_to(np.eye(4), (b * v, 4, 4)))
    intr = to(np.broadcast_to(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]),
                              (b * v, 3, 3)))
    return dict(extrinsics=extr, intrinsics=intr, near=to(np.ones(b * v)),
                means=rep(to(means)), covariances=rep(to(cov)), sh=rep(to(sh)),
                opacities=rep(to(opac)), background=to(np.zeros((b * v, 3))))


def project(scene, image_shape, config):
    """The render path up to the screen-space gaussians (api.render)."""
    from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians

    scale = 1.0 / scene["near"]
    extr = scene["extrinsics"].clone()
    extr[..., :3, 3] = extr[..., :3, 3] * scale[:, None]
    cam = make_camera(extr, scene["intrinsics"], image_shape)
    sh = scene["sh"]
    deg = int(math.isqrt(sh.shape[-1])) - 1
    return project_gaussians(
        cam, scene["means"] * scale[:, None, None],
        scene["covariances"] * (scale[:, None, None, None] ** 2),
        scene["opacities"], sh, deg, config)


def peaks():
    import torch

    return PEAKS["pcie" if "PCIe" in torch.cuda.get_device_name(0) else "sxm"]


# Device operations of one B1 call as the source makes them: the memset of
# its status words and ticket, the one-pass kernel and the tail fill
# (csrc/compact_pairs.cu). check_b1 counts them in the run.
B1_LAUNCHES = dict(kernels=2, memsets=1, copies=0, other=0)


def device_operations(fn) -> dict:
    """The device operations one call of `fn` enqueues, counted by type in a
    CUDA graph capture of the call (libcuda's cuGraphGetNodes): kernels,
    memsets, copies, other nodes. A call that used another stream would
    fail the capture."""
    import collections
    import ctypes

    import torch

    fn()  # anything built or loaded at first use, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = collections.Counter()
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds[{0: "kernels", 1: "copies", 2: "memsets"}.get(t.value, "other")] += 1
    del graph
    torch.cuda.synchronize()
    return {k: kinds[k] for k in B1_LAUNCHES}


def b1_equal(got: dict, ref: dict) -> bool:
    """Two B1 outputs equal bit for bit (keys, ids, counts, features)."""
    import torch

    return all(torch.equal(got[k], ref[k]) for k in ("tile", "dkey", "ids", "counts")) and \
        torch.equal(got["feats"].view(torch.int32), ref["feats"].view(torch.int32))


def check_b1(screen, image_shape, config, tag: str, regs: dict) -> dict:
    """Kernel B1 vs its plain version, bit for bit, two runs equal; times,
    bound, registers of its one-pass kernel and the device operations one
    call makes (`device_operations`; fails if they are not the source's)."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import compact

    b, n = screen.depth.shape
    cand = compact.build_candidates(screen, image_shape, config)
    budget = compact.pairs_budget(config, b, n)
    window = config.compact_window
    got = compact.compact_candidates_cuda(cand, budget, window)
    ref = compact.compact_candidates_plain(cand, budget, window)
    torch.cuda.synchronize()
    if not b1_equal(got, ref):
        raise AssertionError(f"B1 {tag}: differs from the plain version")
    if not b1_equal(compact.compact_candidates_cuda(cand, budget, window), got):
        raise AssertionError(f"B1 {tag}: two runs on the same inputs differ")
    written, total = (int(x) for x in got["counts"])
    n_cand = cand["valid"].numel()
    plane = torch.cat([torch.stack([cand["tile"], cand["dkey"], cand["pid"]]).view(torch.float32),
                       cand["feats"]])
    valid = cand["valid"]
    ms = cuda_ms(lambda: compact.compact_candidates_cuda(cand, budget, window), 20)
    plain_ms = cuda_ms(lambda: compact.compact_candidates_plain(cand, budget, window), 5)
    library_ms = cuda_ms(lambda: plane[:, valid], 20)
    moved = n_cand * (1 + 12 + 36) + budget * 48 + 8
    bound_ms = moved / peaks()["bw"] * 1e3
    ops = device_operations(lambda: compact.compact_candidates_cuda(cand, budget, window))
    if ops != B1_LAUNCHES:
        raise AssertionError(f"B1 {tag}: one call made {ops}, the source makes {B1_LAUNCHES}")
    row = dict(phase=f"b1_{tag}", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes",
               candidates=n_cand, written=written, total=total, budget=budget,
               two_runs_bit_equal=True, device_operations=ops,
               registers=regs.get("compact_pairs"))
    emit(row)
    return row


def b1_sweep() -> dict:
    """Kernel B1 bit for bit against its plain version, and two runs equal,
    at the edges of its window rule: windows of 512, 4,096, 4,224 and 8,192
    rows (the last two walked in several 4,096-row slices) over 1,000,003
    candidates (no multiple of any), 60% of them valid (numpy
    seed 3), none valid and all valid; budgets of `budget_fit` and
    `budget_fit - 128`, where `budget_fit` is the smallest budget at which
    window k (the middle one) is still appended, and one that every window
    fits."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import compact

    n_cand = 1_000_003
    rng = np.random.default_rng(3)
    cand = dict(
        tile=torch.as_tensor(rng.integers(0, 2**31 - 1, n_cand, dtype=np.int32), device="cuda"),
        dkey=torch.as_tensor(rng.integers(0, 2**31 - 1, n_cand, dtype=np.int32), device="cuda"),
        pid=torch.arange(n_cand, dtype=torch.int32, device="cuda"),
        feats=torch.as_tensor(rng.standard_normal((9, n_cand), dtype=np.float32), device="cuda"))
    flags = {"random": torch.as_tensor(rng.random(n_cand) < 0.6, device="cuda"),
             "none": torch.zeros(n_cand, dtype=torch.bool, device="cuda"),
             "all": torch.ones(n_cand, dtype=torch.bool, device="cuda")}
    cases = {}
    for window in (512, 4096, 4224, 8192):
        n_windows = -(-n_cand // window)
        roomy = -(-(n_cand + window + 128) // 128) * 128
        for name, valid in flags.items():
            c = dict(cand, valid=valid)
            pad = torch.zeros(n_windows * window, dtype=torch.int64, device="cuda")
            pad[:n_cand] = valid.long()
            prefix = torch.cumsum(pad.view(n_windows, window).sum(1), 0)
            k = n_windows // 2
            fit = (int(prefix[k - 1]) // 128) * 128 + window + 128
            budgets = {"budget_fit": fit, "budget_fit-128": fit - 128, "all_fit": roomy}
            for bname, budget in budgets.items():
                got = compact.compact_candidates_cuda(c, budget, window)
                ref = compact.compact_candidates_plain(c, budget, window)
                again = compact.compact_candidates_cuda(c, budget, window)
                tag = f"w{window}_{name}_{bname}"
                if not b1_equal(got, ref):
                    raise AssertionError(f"b1_sweep {tag}: differs from the plain version")
                if not b1_equal(again, got):
                    raise AssertionError(f"b1_sweep {tag}: two runs differ")
                written, total = (int(x) for x in got["counts"])
                cases[tag] = dict(budget=budget, written=written, total=total,
                                  window_k=k, rows_before_k=int(prefix[k - 1]),
                                  rows_through_k=int(prefix[k]))
    row = dict(phase="b1_sweep", candidates=n_cand, bit_exact=True, two_runs_equal=True,
               cases=cases)
    emit(row)
    return row


def check_b2(screen, image_shape, background, config, tag: str, regs: dict) -> dict:
    """Kernel B2 vs its plain version on the same sorted inputs, two runs
    bit-equal; times, bound, CTAs an SM, registers (`regs`: per kernel
    library, from its build) and the work its data asks for."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import streamed

    from pf3plat_tpu_torch.ops.rasterizer import kernels

    args, _ = streamed.prepare_streamed(screen, image_shape, background, config)
    got = streamed.composite_fwd_cuda(**args)
    ref = streamed.composite_fwd_plain(**args)
    errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
    if not all(math.isfinite(e) and e <= TOL_B2 for e in errs):
        raise AssertionError(f"B2 {tag}: max abs err (img, tfin, tchk) {errs} > {TOL_B2}")
    del ref
    again = streamed.composite_fwd_cuda(**args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not same:
        raise AssertionError(f"B2 {tag}: two runs on the same inputs differ")
    del got, again
    rows = args["base"].shape[0]
    pairs = int(args["counts"].sum())
    p = config.tile_size ** 2
    evaluations = p * pairs
    ms = cuda_ms(lambda: streamed.composite_fwd_cuda(**args), 20)
    plain_ms = cuda_ms(lambda: streamed.composite_fwd_plain(**args), 3, warmup=1)
    n_chunks = config.tile_capacity // config.chunk + 1
    moved = pairs * 36 + rows * (4 * 4 + 12) + rows * p * 4 * (3 + 1 + n_chunks)
    ops = evaluations * OPS_B2
    pk = peaks()
    t_bytes, t_ops = moved / pk["bw"] * 1e3, ops / pk["fp32"] * 1e3
    row = dict(phase=f"b2_{tag}", max_abs_err=max(errs), err_img=errs[0], err_tfin=errs[1],
               err_tchk=errs[2], ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_bytes, t_ops), bound_by="operations" if t_ops >= t_bytes else "bytes",
               tile_rows=rows, pairs_in_segments=pairs, evaluations=evaluations,
               ctas_per_sm=kernels.occupancy("composite_fwd", config.tile_size, config.chunk),
               registers=regs.get("composite_fwd"), two_runs_bit_equal=same,
               fwd_work=fwd_work(args))
    emit(row)
    return row


def fwd_work(args) -> dict:
    """What kernel B2's walk asks of this data (`walk_work`): its windows'
    chunks, the segment [off, off + count) of each."""
    import torch

    cfg = args["config"]
    ck = cfg.chunk
    off, end = args["off"], (args["off"] + args["counts"]).to(torch.int64)
    lane = torch.arange(ck, device=off.device)

    def chunks():
        for i in range(cfg.tile_capacity // ck + 1):
            cols = args["base"].to(torch.int64)[:, None] * ck + i * ck + lane[None]
            j = i * ck + lane[None]
            yield args["featP"][:, cols], (j >= off[:, None]) & (j < end[:, None])

    return walk_work(chunks(), args)


def table_fwd_work(args) -> dict:
    """What kernel B6's walk asks of these tables (`walk_work`): each row's
    walked chunks, the segment its first min(count, cap) slots."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import pallas_impl

    cfg = args["config"]
    ck = cfg.chunk
    counts = args["counts"].clamp(max=cfg.tile_capacity).to(torch.int64)
    lane = torch.arange(ck, device=counts.device)

    def chunks():
        for i in range(cfg.tile_capacity // ck):
            yield (pallas_impl._chunk_data(args["table"], i, ck),
                   i * ck + lane[None] < counts[:, None])

    return walk_work(chunks(), args)


def walk_work(chunks, args) -> dict:
    """What a forward walk asks of its data, counted with the plain
    arithmetic (`streamed._chunk_alpha`, the running log sum; the power in
    the plain version's rounding) over `chunks`, which yields each chunk's
    data (>= 6 feature rows, rows, chunk) and segment mask (rows, chunk):
    the rows' pair counts (mean and quantiles), the in-segment (pixel, pair)
    evaluations, those a pixel reaches before its chunk's first dead pair
    and whose power passes the skip test (candidates: pair_alpha runs),
    those that contribute (alive, alpha != 0), and the (warp, sub-block)
    steps with at least one candidate among the warp's 32 pixels and the
    sub-block's 8 pairs."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import streamed

    cfg = args["config"]
    ck, ts = cfg.chunk, cfg.tile_size
    p = ts * ts
    sub = streamed.bwd_sub_block()
    px, py = streamed._pixel_centres(args["tile_ids"], args["tiles_x"], ts)
    evals = cand_n = contrib = steps = steps_cand = 0
    tcar = torch.ones((args["tile_ids"].numel(), p), device=px.device)
    for data, seg in chunks:
        if not bool(seg.any()):
            continue
        alpha, dx, dy, _, _ = streamed._chunk_alpha(data, px, py, seg, cfg)  # (rows, p, ck)
        power = (-0.5 * (data[2][:, None, :] * dx * dx + data[4][:, None, :] * dy * dy)
                 - data[3][:, None, :] * dx * dy)
        op = data[5][:, None, :]
        thr = torch.where(op > 0, torch.log(cfg.alpha_min / op.clamp(min=1e-30)) - 0.01,
                          torch.full_like(op, float("inf")))
        t_after = tcar[:, :, None] * torch.exp(streamed.running_sum(torch.log1p(-alpha)))
        alive = (t_after >= cfg.transmittance_min) & seg[:, None, :]
        dead = seg[:, None, :] & ~alive
        reached = seg[:, None, :] & (torch.cumsum(dead.int(), dim=-1) - dead.int() == 0)
        cand = reached & ~(power < thr)
        evals += int(seg.sum()) * p
        cand_n += int(cand.sum())
        contrib += int((alive & (alpha != 0)).sum())
        n_pad, warps = -(-ck // sub) * sub, -(-p // 32)  # idle lanes: no candidate
        padded = torch.nn.functional.pad(cand, (0, n_pad - ck, 0, warps * 32 - p))
        per_step = padded.reshape(cand.shape[0], warps, 32, n_pad // sub, sub).any(dim=(2, 4))
        seg_sb = torch.nn.functional.pad(seg, (0, n_pad - ck)).reshape(
            seg.shape[0], n_pad // sub, sub).any(dim=2)  # (rows, n_sub)
        steps += int(seg_sb.sum()) * warps
        steps_cand += int(per_step.sum())
        t_last = torch.amin(torch.where(alive, t_after, torch.full_like(t_after, float("inf"))),
                            dim=-1)
        tcar = torch.where(alive.any(dim=-1), t_last, tcar)
    counts = args["counts"].float()
    q = torch.quantile(counts, torch.tensor([0.0, 0.5, 0.9, 0.99, 1.0], device=counts.device))
    return dict(pairs_per_row_mean=float(counts.mean()),
                pairs_per_row_q0_50_90_99_100=[float(x) for x in q],
                evaluations=evals, candidates=cand_n, candidate_share=cand_n / max(evals, 1),
                contributing=contrib, warp_sub_block_steps=steps,
                warp_sub_block_steps_with_candidate=steps_cand,
                step_candidate_share=steps_cand / max(steps, 1))


def backward_inputs(screen, image_shape, background, config):
    """What kernels B3 and B5 take for `screen`: the sorted pairs, B2's
    final T and checkpoints, and a fixed upstream image gradient from numpy
    seed 1 -> (B2's arguments, prepare_streamed's extras, the backward's
    keyword arguments)."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import streamed

    args, extra = streamed.prepare_streamed(screen, image_shape, background, config)
    _, tfin, tchk = streamed.composite_fwd_cuda(**args)
    rows = args["base"].shape[0]
    p = config.tile_size ** 2
    g_tiles = torch.as_tensor(
        np.random.default_rng(1).standard_normal((rows, args["channels"], p)).astype(np.float32),
        device="cuda")
    bwd = dict(featP=args["featP"], base=args["base"], off=args["off"], counts=args["counts"],
               tile_ids=args["tile_ids"], nproc=streamed.n_processed(tchk),
               bg_rows=args["bg_rows"], tfin=tfin, tchk=tchk, g_tiles=g_tiles,
               tiles_x=args["tiles_x"], channels=args["channels"], config=config)
    return args, extra, bwd


def check_backward(screen, image_shape, background, config, tag: str):
    """Kernels B3 and B4 vs their plain versions on the same inputs: the
    sorted pairs and B2's checkpoints of `screen`, and a fixed upstream
    image gradient from numpy seed 1. -> (B3 row, B4 row)."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import compact, kernels, streamed

    args, extra, bwd = backward_inputs(screen, image_shape, background, config)
    rows = args["base"].shape[0]
    got = streamed.composite_bwd_cuda(**bwd)
    ref = streamed.composite_bwd_plain(**bwd)
    errs = {}
    for name, a, r in (("dP", got[0], ref[0]), ("dbg", got[1], ref[1])):
        for k in range(a.shape[0] if name == "dP" else a.shape[1]):
            ak, rk = (a[k], r[k]) if name == "dP" else (a[:, k], r[:, k])
            err = float((ak - rk).abs().max())
            scale = float(rk.abs().max())
            if not (math.isfinite(err) and err <= TOL_B3 * scale):
                raise AssertionError(f"B3 {tag}: {name}[{k}] max abs err {err} > "
                                     f"{TOL_B3} * {scale}")
            errs[f"{name}{k}"] = err
    again = streamed.composite_bwd_cuda(**bwd)
    same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if not same:
        raise AssertionError(f"B3 {tag}: two runs on the same inputs differ")
    del again
    pairs = int(args["counts"].sum())
    p = config.tile_size ** 2
    evaluations = p * pairs
    ms = cuda_ms(lambda: streamed.composite_bwd_cuda(**bwd), 10)
    plain_ms = cuda_ms(lambda: streamed.composite_bwd_plain(**bwd), 2, warmup=1)
    n_cols = args["featP"].shape[1]
    n_chunks = config.tile_capacity // config.chunk + 1
    moved = (2 * 36 * n_cols + rows * 4 * 5 + rows * 12 * 2
             + rows * p * 4 * (n_chunks + 1 + args["channels"]))
    pk = peaks()
    t_bytes, t_ops = moved / pk["bw"] * 1e3, evaluations * OPS_B3 / pk["fp32"] * 1e3
    b3 = dict(phase=f"b3_{tag}", max_abs_err=max(errs.values()), errs=errs, tol_rel=TOL_B3,
              ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=max(t_bytes, t_ops),
              bound_by="operations" if t_ops >= t_bytes else "bytes", tile_rows=rows,
              pairs_in_segments=pairs, evaluations=evaluations,
              ctas_per_sm=kernels.occupancy("composite_bwd", config.tile_size, config.chunk),
              smem_bytes=kernels.smem_bytes("composite_bwd", config.tile_size, config.chunk),
              two_runs_bit_equal=same)
    emit(b3)

    # B4 on the unsorted kernel gradients (the backward's own order)
    b, n = screen.depth.shape
    ids_u, perm = torch.sort(extra["ids_sorted"])
    grads = got[0][:, : ids_u.numel()][:, perm].contiguous()
    ids_u = ids_u.contiguous()
    n_gauss, max_dup = b * n, config.max_dup
    red = compact.dup_reduce_cuda(grads, ids_u, n_gauss, max_dup)
    red_ref = compact.dup_reduce_plain(grads, ids_u, n_gauss, max_dup)
    if not torch.equal(red.view(torch.int32), red_ref.view(torch.int32)):
        raise AssertionError(f"B4 {tag}: sums differ from the plain version")
    real = int((ids_u < n_gauss * max_dup).sum())
    owner = (ids_u[:real] // max_dup).to(torch.int64)
    written = grads[:, :real]
    ms = cuda_ms(lambda: compact.dup_reduce_cuda(grads, ids_u, n_gauss, max_dup), 20)
    plain_ms = cuda_ms(lambda: compact.dup_reduce_plain(grads, ids_u, n_gauss, max_dup), 5)
    library_ms = cuda_ms(
        lambda: torch.zeros(9, n_gauss, device="cuda").index_add_(1, owner, written), 20)
    moved = grads.numel() * 4 + ids_u.numel() * 4 + red.numel() * 4
    b4 = dict(phase=f"b4_{tag}", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, bound_ms=moved / pk["bw"] * 1e3, bound_by="bytes",
              rows=ids_u.numel(), real_rows=real, gaussians=n_gauss)
    emit(b4)
    return b3, b4


def check_b5(screen, image_shape, background, config, tag: str) -> dict:
    """Kernel B5 vs its plain version on the sorted pairs and B2's
    checkpoints of `screen` (fixed upstream gradient, numpy seed 1), per
    feature row at B3's tolerance; then its merged blocks against kernel
    B3's dP on the same inputs (the same arithmetic: TOL_B5_B3)."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import kernels, streamed

    args, _, bwd = backward_inputs(screen, image_shape, background, config)
    rows = args["base"].shape[0]
    got = streamed.composite_bwd_blocks_cuda(**bwd)
    ref = streamed.composite_bwd_blocks_plain(**bwd)
    errs = {}
    for name, a, r in (("dblk", got[0], ref[0]), ("dbg", got[1], ref[1])):
        for k in range(a.shape[2] if name == "dblk" else a.shape[1]):
            ak, rk = (a[:, :, k], r[:, :, k]) if name == "dblk" else (a[:, k], r[:, k])
            err = float((ak - rk).abs().max())
            scale = float(rk.abs().max())
            if not (math.isfinite(err) and err <= TOL_B3 * scale):
                raise AssertionError(f"B5 {tag}: {name}[{k}] max abs err {err} > "
                                     f"{TOL_B3} * {scale}")
            errs[f"{name}{k}"] = err
    del ref
    n_cols = args["featP"].shape[1]
    merged = streamed.merge_blocks(got[0], args["base"], n_cols)
    dP, dbg = streamed.composite_bwd_cuda(**bwd)
    diff = float((merged - dP).abs().max())
    scale = float(dP.abs().max())
    if not (diff <= TOL_B5_B3 * scale and torch.equal(got[1], dbg)):
        raise AssertionError(f"B5 {tag}: merged blocks differ from B3's dP by {diff} "
                             f"(> {TOL_B5_B3} * {scale}) or d(bg) differs")
    again = streamed.composite_bwd_blocks_cuda(**bwd)
    same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if not same:
        raise AssertionError(f"B5 {tag}: two runs on the same inputs differ")
    del again
    pairs = int(args["counts"].sum())
    p = config.tile_size ** 2
    evaluations = p * pairs
    ms = cuda_ms(lambda: streamed.composite_bwd_blocks_cuda(**bwd), 10)
    merge_ms = cuda_ms(lambda: streamed.merge_blocks(got[0], args["base"], n_cols), 10)
    plain_ms = cuda_ms(lambda: streamed.composite_bwd_blocks_plain(**bwd), 2, warmup=1)
    n_chunks = config.tile_capacity // config.chunk + 1
    moved = (36 * n_cols + rows * 4 * 5 + rows * 12 * 2
             + rows * p * 4 * (n_chunks + 1 + args["channels"]) + got[0].numel() * 4)
    pk = peaks()
    t_bytes, t_ops = moved / pk["bw"] * 1e3, evaluations * OPS_B3 / pk["fp32"] * 1e3
    row = dict(phase=f"b5_{tag}", max_abs_err=max(errs.values()), errs=errs, tol_rel=TOL_B3,
               merged_vs_b3_max_abs_diff=diff, merged_equals_b3=bool(torch.equal(merged, dP)),
               ms=ms, merge_ms=merge_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes", tile_rows=rows,
               block_bytes=got[0].numel() * 4, pairs_in_segments=pairs, evaluations=evaluations,
               ctas_per_sm=kernels.occupancy("composite_bwd_blocks", config.tile_size,
                                             config.chunk),
               smem_bytes=kernels.smem_bytes("composite_bwd_blocks", config.tile_size,
                                             config.chunk),
               two_runs_bit_equal=same)
    emit(row)
    return row


def bwd_errors(bwd, tag: str) -> dict:
    """Kernels B3 and B5 against their plain versions on the backward's
    inputs `bwd` (per feature row and d(bg) channel at TOL_B3 of its largest
    plain value), B5's merged blocks against B3's dP (TOL_B5_B3, d(bg)
    equal), and a second launch of each bit-equal to the first -> the worst
    relative errors."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import streamed

    n_cols = bwd["featP"].shape[1]
    got3, got5 = streamed.composite_bwd_cuda(**bwd), streamed.composite_bwd_blocks_cuda(**bwd)
    ref3, ref5 = streamed.composite_bwd_plain(**bwd), streamed.composite_bwd_blocks_plain(**bwd)
    worst = {}
    for name, a, r in (("dP", got3[0], ref3[0]), ("dblk", got5[0].transpose(0, 2), ref5[0].transpose(0, 2)),
                       ("dbg", got3[1].T, ref3[1].T), ("dbg_b5", got5[1].T, ref5[1].T)):
        for k in range(a.shape[0]):
            err = float((a[k] - r[k]).abs().max())
            scale = float(r[k].abs().max())
            if not (math.isfinite(err) and err <= TOL_B3 * scale):
                raise AssertionError(f"bwd_sweep {tag}: {name}[{k}] max abs err {err} > "
                                     f"{TOL_B3} * {scale}")
            worst[name] = max(worst.get(name, 0.0), err / scale if scale > 0 else 0.0)
    merged = streamed.merge_blocks(got5[0], bwd["base"], n_cols)
    diff = float((merged - got3[0]).abs().max())
    if not (diff <= TOL_B5_B3 * float(got3[0].abs().max()) and torch.equal(got5[1], got3[1])):
        raise AssertionError(f"bwd_sweep {tag}: merged B5 differs from B3 by {diff}")
    again3, again5 = streamed.composite_bwd_cuda(**bwd), streamed.composite_bwd_blocks_cuda(**bwd)
    if not all(torch.equal(a, b) for a, b in zip((*got3, *got5), (*again3, *again5))):
        raise AssertionError(f"bwd_sweep {tag}: two runs on the same inputs differ")
    worst.update(merged_vs_b3=diff, merged_equals_b3=bool(torch.equal(merged, got3[0])))
    return worst


def saturating_screen(device):
    """Screen-space gaussians of two 256 x 256 views (bench.py's image
    size) in which every 16 x 16 tile holds 40-46 gaussians (so segments
    start and end at every offset of a sub-block) that cover the whole tile
    (alpha ~ opacity on every pixel), depth-sorted as listed. The tiles take
    turns among four opacity patterns: three fronts of 0.995 (alpha clamped
    at 0.99: every pixel dead at the segment's second or third pair, inside
    its first sub-block when the segment starts at most 5 pairs into one), 0.5 (dead
    near the 14th pair, on either side of a sub-block boundary from pixel
    to pixel), 0.2 (dead near the 41st) and 0.04 (alive
    to the end). -> (ScreenGaussians, pattern of each tile row)."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.ops.rasterizer.types import ScreenGaussians

    rng = np.random.default_rng(7)
    views, tiles = 2, 16 * 16
    fields = {k: [] for k in ("xy", "depth", "conic", "radius", "color", "opacity")}
    patterns = []
    for v in range(views):
        per = {k: [] for k in fields}
        for t in range(tiles):
            k = 40 + t * 5 % 7
            pat = (t + v) % 4
            patterns.append(pat)
            op = np.full(k, (0.04, 0.5, 0.2, 0.04)[pat], np.float32)
            if pat == 0:
                op[:3] = 0.995
            cx, cy = (t % 16) * 16 + 8.0, (t // 16) * 16 + 8.0
            per["xy"].append(np.stack([cx + rng.uniform(-0.5, 0.5, k),
                                       cy + rng.uniform(-0.5, 0.5, k)], -1))
            per["depth"].append(1.0 + t * 0.01 + np.arange(k) * 1e-4)
            per["conic"].append(np.tile([1e-4, 0.0, 1e-4], (k, 1)))
            per["radius"].append(np.full(k, 7.5))
            per["color"].append(rng.uniform(0, 1, (k, 3)))
            per["opacity"].append(op)
        for key in fields:
            fields[key].append(np.concatenate(per[key]))

    def to(a, dtype=torch.float32):
        return torch.as_tensor(np.stack(a), device=device).to(dtype)

    t = {k: to(v) for k, v in fields.items()}
    return ScreenGaussians(valid=torch.ones_like(t["depth"], dtype=torch.bool), **t), patterns


def bwd_sweep() -> dict:
    """Kernels B3 and B5 (`bwd_errors`) at the edges of the sub-block walk,
    at bench.py's size (two 256 x 256 views, 512 tile rows): the bench
    scene's segments, which start and end at any offset of a chunk and of a
    sub-block, with chunk 128 and 64; the same in one channel; the
    saturating scene (`saturating_screen`); the bench scene with `nproc` set
    to 0 on every third tile row and to n_chunks (chunks the forward never
    reached: checkpoint 0, every pair dead) on the next; the bench scene in
    tiles of 32 x 32 and 24 x 24 pixels (walked in 4 parts of 256 and 3 of
    192 pixels) and of 12 x 12 and 20 x 20 pixels (144 pixels on 160 lanes,
    400 in 2 parts of 224: idle lanes). Then kernels B6 (`b6_errors`) and
    B7 (`table_bwd_errors`), the forward and backward walks on dense
    tables: the bench scene at the production config, with capacity 256 and
    chunk 64 (many rows walk every chunk) and every third row's checkpoints
    set to 0 before B7 (nproc 0), in one channel, the saturating scene,
    tiles of 32 x 32 at chunk 128 and 64 and of 24 x 24 at chunk 64 (walked
    in parts), of 12 x 12 and 20 x 20 (idle lanes), and at capacity 256
    with every fifth row's count set to 0 and every full row's past the
    capacity."""
    import torch

    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, streamed

    sub = streamed.bwd_sub_block()
    shape = (256, 256)
    scene = bench_scene("cuda")
    screen = project(scene, shape, PRODUCTION_CONFIG)
    bg = scene["background"]
    sat, patterns = saturating_screen("cuda")
    one = screen._replace(color=screen.color[..., :1].contiguous())
    cases = (("bench_chunk128", screen, bg, PRODUCTION_CONFIG),
             ("bench_chunk64", screen, bg, dataclasses.replace(PRODUCTION_CONFIG, chunk=64)),
             ("bench_one_channel", one, bg[:, :1].contiguous(), PRODUCTION_CONFIG),
             ("saturating", sat, bg, RasterizeConfig()),
             ("nproc_edges", screen, bg, PRODUCTION_CONFIG),
             ("tile32_chunk32", screen, bg,
              dataclasses.replace(PRODUCTION_CONFIG, tile_size=32, chunk=32)),
             ("tile24_chunk64", screen, bg,
              dataclasses.replace(PRODUCTION_CONFIG, tile_size=24, chunk=64)),
             ("tile12_chunk128", screen, bg, dataclasses.replace(PRODUCTION_CONFIG, tile_size=12)),
             ("tile20_chunk64", screen, bg,
              dataclasses.replace(PRODUCTION_CONFIG, tile_size=20, chunk=64)))
    report = {}
    for tag, scr, background, config in cases:
        args, _, bwd = backward_inputs(scr, shape, background, config)
        n_chunks = config.tile_capacity // config.chunk + 1
        nproc = bwd["nproc"]
        if tag == "nproc_edges":
            r = torch.arange(nproc.numel(), device=nproc.device)
            nproc = torch.where(r % 3 == 0, 0, torch.where(r % 3 == 1, n_chunks, nproc))
            bwd["nproc"] = nproc.to(torch.int32).contiguous()
        off, end = args["off"], args["off"] + args["counts"]
        rows = dict(
            rows=off.numel(),
            start_mid_sub_block=int((off % sub != 0).sum()),
            end_mid_sub_block=int((end % sub != 0).sum()),
            start_mid_chunk=int((off % config.chunk != 0).sum()),
            over_one_chunk=int(((end - 1) // config.chunk > off // config.chunk).sum()),
            nproc_zero=int((bwd["nproc"] == 0).sum()),
            nproc_all=int((bwd["nproc"] == n_chunks).sum()))
        if tag == "saturating":
            front = torch.as_tensor(patterns, device=off.device) == 0
            rows["dead_in_first_sub_block"] = int((front & (off % sub <= sub - 3)).sum())
        report[tag] = dict(channels=args["channels"], tile_size=config.tile_size,
                           chunk=config.chunk, **rows, **bwd_errors(bwd, tag))
    del args, bwd
    small = dataclasses.replace(PRODUCTION_CONFIG, tile_capacity=256, chunk=64)
    table_cases = (("table_bench_chunk128", screen, bg, PRODUCTION_CONFIG),
                   ("table_nproc_edges", screen, bg, small),
                   ("table_one_channel", one, bg[:, :1].contiguous(), PRODUCTION_CONFIG),
                   ("table_saturating", sat, bg, RasterizeConfig()),
                   ("table_tile32_chunk128", screen, bg,
                    dataclasses.replace(PRODUCTION_CONFIG, tile_size=32)),
                   ("table_tile32_chunk64", screen, bg,
                    dataclasses.replace(PRODUCTION_CONFIG, tile_size=32, chunk=64)),
                   ("table_tile24_chunk64", screen, bg,
                    dataclasses.replace(PRODUCTION_CONFIG, tile_size=24, chunk=64)),
                   ("table_tile12_chunk128", screen, bg,
                    dataclasses.replace(PRODUCTION_CONFIG, tile_size=12)),
                   ("table_tile20_chunk64", screen, bg,
                    dataclasses.replace(PRODUCTION_CONFIG, tile_size=20, chunk=64)),
                   ("table_count_edges", screen, bg, small))
    for tag, scr, background, config in table_cases:
        args = table_inputs(scr, shape, background, config)
        rows_n = args["table"].shape[0]
        if tag == "table_count_edges":
            # every fifth row's count 0 (its table still full: nothing is
            # walked), every full row's count past the capacity
            r = torch.arange(rows_n, device="cuda")
            full = args["counts"] == config.tile_capacity
            args["counts"] = torch.where(r % 5 == 0, 0, torch.where(
                full, config.tile_capacity + 37, args["counts"])).to(torch.int32).contiguous()
        b6 = b6_errors(args, tag)
        zero = torch.arange(rows_n, device="cuda") % 3 == 0 if tag == "table_nproc_edges" else None
        bwd = table_backward_inputs(args, zero)
        nproc = streamed.n_processed(bwd["tchk"])
        n_chunks = config.tile_capacity // config.chunk
        _, _, worst = table_bwd_errors(bwd, tag)
        report[tag] = dict(channels=args["channels"], tile_size=config.tile_size,
                           chunk=config.chunk, rows=rows_n, nproc_zero=int((nproc == 0).sum()),
                           nproc_all=int((nproc == n_chunks).sum()),
                           partial_last_chunk=int((args["counts"] % config.chunk != 0).sum()),
                           count_zero=int((args["counts"] == 0).sum()),
                           count_over_cap=int((args["counts"] > config.tile_capacity).sum()),
                           b6=b6, **worst)
    row = dict(phase="bwd_sweep", tol_rel=TOL_B3, tol_merged=TOL_B5_B3, sub_block=sub,
               cases=report)
    emit(row)
    return row


def bwd_work(bwd) -> dict:
    """What the backward walk's data asks for, counted with the plain
    arithmetic (`streamed._chunk_alpha`, the running log sum): in-segment
    (pixel, pair) evaluations of the walked chunks, those that contribute
    (alive, and alpha != 0 or unclamped), the (warp, pair) steps with at
    least one contributing pixel among the warp's 32, and the tile rows'
    pair counts (mean, largest)."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import streamed

    cfg = bwd["config"]
    ck, ts = cfg.chunk, cfg.tile_size
    px, py = streamed._pixel_centres(bwd["tile_ids"], bwd["tiles_x"], ts)
    off, end = bwd["off"], (bwd["off"] + bwd["counts"]).to(torch.int64)
    lane = torch.arange(ck, device=off.device)
    evals = contrib = warp_steps = steps = 0
    for i in range(cfg.tile_capacity // ck + 1):
        cols = bwd["base"].to(torch.int64)[:, None] * ck + i * ck + lane[None]
        data = bwd["featP"][:, cols]
        j = i * ck + lane[None]
        seg = (j >= off[:, None]) & (j < end[:, None]) & (i < bwd["nproc"])[:, None]
        alpha, _, _, _, unclamped = streamed._chunk_alpha(data, px, py, seg, cfg)
        t_after = bwd["tchk"][:, i, :, None] * torch.exp(
            streamed.running_sum(torch.log1p(-alpha)))
        live = (t_after >= cfg.transmittance_min) & seg[:, None, :]
        c = live & ((alpha != 0) | unclamped)  # (rows, p, ck)
        evals += int(seg.sum()) * ts * ts
        contrib += int(c.sum())
        warp_steps += int(c.reshape(c.shape[0], -1, 32, ck).any(dim=2).sum())
        steps += int(seg.sum()) * ts * ts // 32
    counts = bwd["counts"].float()
    return dict(evaluations=evals, contributing=contrib, warp_pair_steps=steps,
                warp_pair_steps_contributing=warp_steps, pairs_per_row_mean=float(counts.mean()),
                pairs_per_row_max=int(counts.max()))


BWD_ABLATIONS = ("full", "no replay", "no shuffles", "no reciprocal",
                 "no feature copies in the loop", "no reverse sweep")


def bwd_ablations() -> dict:
    """Where kernel B3's time goes: measurement builds of
    `csrc/composite_bwd.cu` that each leave one part out (`PF3_BWD_ABLATE`
    = 1..5, composite_bwd_walk.cuh; their results are wrong and are not
    read), timed beside the full kernel on bench.py's scene and on the
    saturating scene, all walking the tile rows heaviest first as the
    wrapper does, and the full kernel once more with the rows in their
    order; with the work the two scenes ask for (`bwd_work`) and each
    build's registers."""
    import torch

    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, kernels, streamed

    ct = kernels.ctypes
    reports = {}
    names = list(BWD_ABLATIONS)
    libs = kernels.build_variants(
        "composite_bwd", [{"PF3_BWD_ABLATE": i} for i in range(len(BWD_ABLATIONS))], reports)
    for lib in libs:
        lib.pf3_composite_bwd.restype = ct.c_int
        lib.pf3_composite_bwd.argtypes = ([ct.c_void_p, ct.c_longlong] + [ct.c_void_p] * 10
                                          + [ct.c_int] * 6 + [ct.c_float] * 4
                                          + [ct.c_void_p] * 3)
    shape = (256, 256)
    scene = bench_scene("cuda")
    sat, _ = saturating_screen("cuda")
    times, stats = {}, {}
    for tag, screen, cfg in (("bench", project(scene, shape, PRODUCTION_CONFIG),
                              PRODUCTION_CONFIG),
                             ("saturating", sat, RasterizeConfig())):
        _, _, b = backward_inputs(screen, shape, scene["background"], cfg)
        dP = torch.zeros((9, b["featP"].shape[1]), device="cuda")
        dbg = torch.empty((b["base"].shape[0], b["channels"]), device="cuda")
        heavy = streamed.heaviest_first(b["counts"])
        runs = [(name, lib, heavy) for name, lib in zip(names, libs)]
        in_order = torch.arange(b["base"].shape[0], dtype=torch.int32, device="cuda")
        runs.append(("full, rows in their order", libs[0], in_order))
        for name, lib, order in runs:

            def launch(fn=lib.pf3_composite_bwd, order=order):
                kernels.check("composite_bwd (measurement build)", fn(
                    kernels.ptr(b["featP"]), b["featP"].shape[1], kernels.ptr(b["base"]),
                    kernels.ptr(b["off"]), kernels.ptr(b["counts"]), kernels.ptr(b["tile_ids"]),
                    kernels.ptr(b["nproc"]), kernels.ptr(order),
                    kernels.ptr(b["bg_rows"]), kernels.ptr(b["tfin"]), kernels.ptr(b["tchk"]),
                    kernels.ptr(b["g_tiles"]), b["base"].shape[0], b["channels"], b["tiles_x"],
                    cfg.tile_size, cfg.chunk, cfg.tile_capacity // cfg.chunk + 1,
                    cfg.alpha_clamp, cfg.alpha_min, 1.0 - cfg.alpha_clamp, cfg.transmittance_min,
                    kernels.ptr(dP), kernels.ptr(dbg), kernels.stream_ptr(dP.device)))

            times.setdefault(name, {})[tag] = cuda_ms(launch, 20)
        stats[tag] = bwd_work(b)
    ptxas = {name: [ln.strip() for ln in reports.get(Path(lib._name).name, "").splitlines()
                    if "registers" in ln or "spill" in ln] for name, lib in zip(names, libs)}
    row = dict(phase="b3_ablations", ms=times, work=stats, ptxas=ptxas)
    emit(row)
    return row


FWD_ABLATIONS = ("full", "no power-test skip", "no cp.async prefetch", "no colour update")


def fwd_ablations() -> dict:
    """Where the forward walk's time goes: measurement builds of
    `csrc/composite_fwd.cu` (kernel B2) and `csrc/table_fwd.cu` (kernel B6)
    that each leave one part out (`PF3_FWD_ABLATE` = 1..3; the first two
    compute the same results, the third wrong images, none is read), timed
    beside the full kernel on bench.py's scene and on the saturating scene, all
    starting the tile rows heaviest first as the wrappers do, and the full
    kernel once more with the rows in their order; with the work the two
    scenes ask for (`fwd_work`, `table_fwd_work`) and each build's
    registers."""
    import torch

    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, kernels, streamed

    ct = kernels.ctypes
    reports = {}
    libs = {
        "composite_fwd": kernels.build_variants(
            "composite_fwd", [{"PF3_FWD_ABLATE": i} for i in range(len(FWD_ABLATIONS))],
            reports),
        "table_fwd": kernels.build_variants(
            "table_fwd", [{"PF3_FWD_ABLATE": i} for i in range(len(FWD_ABLATIONS))], reports),
    }
    for lib in libs["composite_fwd"]:
        lib.pf3_composite_fwd.restype = ct.c_int
        lib.pf3_composite_fwd.argtypes = ([ct.c_void_p, ct.c_longlong] + [ct.c_void_p] * 6
                                          + [ct.c_int] * 6 + [ct.c_float] * 4
                                          + [ct.c_void_p] * 4)
    for lib in libs["table_fwd"]:
        lib.pf3_table_fwd.restype = ct.c_int
        lib.pf3_table_fwd.argtypes = ([ct.c_void_p] * 5 + [ct.c_int] * 7 + [ct.c_float] * 4
                                      + [ct.c_void_p] * 4)
    shape = (256, 256)
    scene = bench_scene("cuda")
    sat, _ = saturating_screen("cuda")
    times = {"composite_fwd": {}, "table_fwd": {}}
    stats = {"composite_fwd": {}, "table_fwd": {}}
    for tag, screen, cfg in (("bench", project(scene, shape, PRODUCTION_CONFIG),
                              PRODUCTION_CONFIG),
                             ("saturating", sat, RasterizeConfig())):
        p = cfg.tile_size ** 2
        a, _ = streamed.prepare_streamed(screen, shape, scene["background"], cfg)
        t = table_inputs(screen, shape, scene["background"], cfg)
        for name, args in (("composite_fwd", a), ("table_fwd", t)):
            rows = args["counts"].shape[0]
            n_chunks = cfg.tile_capacity // cfg.chunk + (name == "composite_fwd")
            img = torch.empty((rows, args["channels"], p), device="cuda")
            tfin = torch.empty((rows, 1, p), device="cuda")
            tchk = torch.empty((rows, n_chunks, p), device="cuda")
            heavy = streamed.heaviest_first(args["counts"])
            runs = [(n, lib, heavy) for n, lib in zip(FWD_ABLATIONS, libs[name])]
            in_order = torch.arange(rows, dtype=torch.int32, device="cuda")
            runs.append(("full, rows in their order", libs[name][0], in_order))
            for label, lib, order in runs:
                if name == "composite_fwd":
                    def launch(fn=lib.pf3_composite_fwd, order=order, a=args):
                        return fn(
                            kernels.ptr(a["featP"]), a["featP"].shape[1], kernels.ptr(a["base"]),
                            kernels.ptr(a["off"]), kernels.ptr(a["counts"]),
                            kernels.ptr(a["tile_ids"]), kernels.ptr(order),
                            kernels.ptr(a["bg_rows"]), rows, a["channels"], a["tiles_x"],
                            cfg.tile_size, cfg.chunk, n_chunks, cfg.alpha_clamp, cfg.alpha_min,
                            1.0 - cfg.alpha_clamp, cfg.transmittance_min, kernels.ptr(img),
                            kernels.ptr(tfin), kernels.ptr(tchk), kernels.stream_ptr(img.device))
                else:
                    def launch(fn=lib.pf3_table_fwd, order=order, a=args):
                        return fn(
                            kernels.ptr(a["table"]), kernels.ptr(a["counts"]),
                            kernels.ptr(a["tile_ids"]), kernels.ptr(order),
                            kernels.ptr(a["bg_rows"]), rows, a["channels"], cfg.tile_capacity,
                            a["tiles_x"], cfg.tile_size, cfg.chunk, n_chunks, cfg.alpha_clamp,
                            cfg.alpha_min, 1.0 - cfg.alpha_clamp, cfg.transmittance_min,
                            kernels.ptr(img), kernels.ptr(tfin), kernels.ptr(tchk),
                            kernels.stream_ptr(img.device))

                def checked(launch=launch, name=name):
                    kernels.check(f"{name} (measurement build)", launch())

                times[name].setdefault(label, {})[tag] = cuda_ms(checked, 20)
        stats["composite_fwd"][tag] = fwd_work(a)
        stats["table_fwd"][tag] = table_fwd_work(t)
    ptxas = {name: {n: [ln.strip() for ln in reports.get(Path(lib._name).name, "").splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, lib in zip(FWD_ABLATIONS, libs[name])} for name in libs}
    out = {}
    for name, phase in (("composite_fwd", "b2_ablations"), ("table_fwd", "b6_ablations")):
        out[name] = dict(phase=phase, ms=times[name], work=stats[name], ptxas=ptxas[name])
        emit(out[name])
    return out


def sm_clock_hz() -> float:
    """The SM clock the exponential bound is reckoned at: the card's maximum
    (`nvidia-smi --query-gpu=clocks.max.sm`, MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0].split()[0]) * 1e6


def attention_inputs(b: int, h: int, n: int, m: int, d: int):
    """q, k, v and the output's cotangent from numpy seeds 3-6, bf16 on the card."""
    import numpy as np
    import torch

    def make(seed, tokens):
        x = np.random.default_rng(seed).standard_normal((b, h, tokens, d)).astype(np.float32)
        return torch.as_tensor(x, device="cuda").to(torch.bfloat16).contiguous()

    return make(3, n), make(4, m), make(5, m), make(6, n)


def attention_errors(q, k, v, g, tag: str, floor: float = 0.0):
    """Both attention kernels against their plain versions on these tensors;
    raises outside the tolerances: max|kernel - plain| <= TOL_ATTN *
    max|plain| per output (bf16 products, sums in another order; a gradient's
    scale is at least `floor` times the three gradients' largest value), the
    log-sum-exp within TOL_LSE. -> (out, lse, (dq, dk, dv), errors)."""
    import torch

    from pf3plat_tpu_torch.models import layers

    scale = q.shape[-1] ** -0.5
    out, lse = layers.attention_fwd_cuda(q, k, v, scale)
    ref_out, ref_lse = layers.attention_fwd_plain(q, k, v, scale)
    grads = layers.attention_bwd_cuda(q, k, v, out, lse, g, scale)
    ref_grads = layers.attention_bwd_plain(q, k, v, out, lse, g, scale)
    torch.cuda.synchronize()
    errs = dict(lse=float((lse - ref_lse).abs().max()), out_max=float(ref_out.abs().max()))
    if not errs["lse"] <= TOL_LSE:
        raise AssertionError(f"attention {tag}: lse err {errs['lse']} > {TOL_LSE}")
    grad_floor = floor * max(float(r.abs().max()) for r in ref_grads)
    for name, a, r in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref_out, *ref_grads)):
        err = float((a - r).abs().max())
        sc = max(float(r.abs().max()), 0.0 if name == "out" else grad_floor)
        if not (math.isfinite(err) and err <= TOL_ATTN * sc):
            raise AssertionError(f"attention {tag}: {name} err {err} > {TOL_ATTN} * {sc}")
        errs[name] = err
    return out, lse, grads, errs


def check_attention(tag: str, b: int, h: int, n: int, m: int, d: int, backward: bool = True):
    """The attention kernels vs their plain versions at (b, h, n | m, d), at
    `attention_errors`' tolerances, two runs bit-equal, then timed. Library
    yardstick: SDPA on the same bf16 tensors. Bounds: the larger of the bytes
    (inputs read once, outputs written once), the tensor-core operations
    (4 n m d b h forward, 10 n m d b h backward, at the dense bf16 peak) and
    the n m b h exponentials at 16 per SM and clock (`exp_ms`).
    -> (forward row, backward row); the backward is checked always and timed
    if `backward`."""
    import torch
    import torch.nn.functional as F

    from pf3plat_tpu_torch.models import layers

    q, k, v, g = attention_inputs(b, h, n, m, d)
    scale = d**-0.5
    out, lse, grads, errs = attention_errors(q, k, v, g, tag)
    again = (*layers.attention_fwd_cuda(q, k, v, scale),
             *layers.attention_bwd_cuda(q, k, v, out, lse, g, scale))
    if not all(torch.equal(a, r) for a, r in zip((out, lse, *grads), again)):
        raise AssertionError(f"attention {tag}: two runs on the same inputs differ")
    del grads, again
    torch.cuda.empty_cache()

    fwd_ms = cuda_ms(lambda: layers.attention_fwd_cuda(q, k, v, scale), 10)
    fwd_plain = cuda_ms(lambda: layers.attention_fwd_plain(q, k, v, scale), 2, warmup=1)
    torch.cuda.empty_cache()
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
    flops = 4.0 * n * m * d * b * h
    moved_f = (q.numel() + 2 * k.numel()) * 2 + out.numel() * 4 + lse.numel() * 4
    occ = layers.attention_occupancy(d)
    phases = [("attn_fwd", fwd_ms, fwd_plain, lib_fwd, flops, moved_f, errs["out"],
               dict(err_lse=errs["lse"], out_max=errs["out_max"], ctas_per_sm=occ["fwd"]))]
    if backward:
        bwd_ms = cuda_ms(lambda: layers.attention_bwd_cuda(q, k, v, out, lse, g, scale), 5)
        bwd_plain = cuda_ms(lambda: layers.attention_bwd_plain(q, k, v, out, lse, g, scale), 2,
                            warmup=1)
        torch.cuda.empty_cache()
        ql, kl, vl = (x.clone().requires_grad_(True) for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl)
        lib_bwd = cuda_ms(
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g, retain_graph=True), 5)
        moved_b = ((2 * q.numel() + 2 * k.numel()) * 2 + out.numel() * 4 + lse.numel() * 4
                   + (q.numel() + 2 * k.numel()) * 4)
        phases.append(
            ("attn_bwd", bwd_ms, bwd_plain, lib_bwd, 2.5 * flops, moved_b,
             max(errs[x] for x in ("dq", "dk", "dv")),
             dict(errs={x: errs[x] for x in ("dq", "dk", "dv")},
                  library_fwd_bwd_ms=lib_fwd + lib_bwd,
                  ctas_per_sm=[occ["bwd_dkdv"], occ["bwd_dq"]])))
    pk = peaks()
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_exp = float(n) * m * b * h / (16.0 * sms * clock) * 1e3
    rows = []
    for phase, ms, plain_ms, lib, ops, moved, err, extra in phases:
        bounds = {"bytes": moved / pk["bw"] * 1e3, "operations": ops / pk["bf16"] * 1e3,
                  "exponentials": t_exp}
        by = max(bounds, key=bounds.get)
        row = dict(phase=f"{phase}_{tag}", shape=[b, h, n, m, d], max_abs_err=err,
                   tol_rel=TOL_ATTN, ms=ms, plain_ms=plain_ms, library_ms=lib,
                   bound_ms=bounds[by], bound_by=by, exp_ms=t_exp, sm_clock_mhz=clock / 1e6,
                   sms=sms, bound_ms_without_exp=max(bounds["bytes"], bounds["operations"]),
                   tflops=ops / (ms * 1e-3) / 1e12, **extra)
        emit(row)
        rows.append(row)
    return rows


def sweep_attention() -> dict:
    """Both attention kernels against their plain versions at ragged sizes:
    (b, h) = (2, 3), head dims 32 and 64, n and m around the 64-row tiles and
    the 128-row CTAs, n != m included. With a single key every probability is
    1 and dq and dk are exactly zero; kernel and plain version then both hold
    rounding noise, so a gradient's gate never goes below SWEEP_FLOOR of the
    largest of the three gradients (dv = sum of dO is of full size there)."""
    sizes = (1, 63, 64, 65, 127, 128, 129, 257, 2401)
    pairs = [(n, n) for n in sizes]
    pairs += list(zip(sizes, sizes[1:] + sizes[:1])) + list(zip(sizes, sizes[4:] + sizes[:4]))
    worst = dict(lse=0.0, out=0.0, dq=0.0, dk=0.0, dv=0.0)
    for d in (32, 64):
        for n, m in pairs:
            q, k, v, g = attention_inputs(2, 3, n, m, d)
            errs = attention_errors(q, k, v, g, f"sweep n={n} m={m} d={d}", SWEEP_FLOOR)[-1]
            worst = {x: max(worst[x], errs[x]) for x in worst}
    row = dict(phase="attn_sweep", cases=2 * len(pairs), pairs=pairs, tol_rel=TOL_ATTN,
               tol_lse=TOL_LSE, floor=SWEEP_FLOOR, worst_abs_err=worst)
    emit(row)
    return row


ATTENTION_ABLATIONS = ("full", "no softmax", "no ex2", "no copies in the loop",
                       "no barrier in the loop", "no P V")


def attention_ablations() -> dict:
    """Where the forward attention kernel's time goes: measurement builds of
    `csrc/attention_fwd.cu` that each leave one part out
    (`PF3_ATTENTION_ABLATE` = 1..5; their results are wrong and are not
    read), timed beside the full kernel at the pose-stack and the ViT shape
    of the training step. What a part's absence saves is what it costs on
    the critical path, not its share of a unit's work."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import kernels

    ct = kernels.ctypes
    libs = kernels.build_variants(
        "attention_fwd", [{"PF3_ATTENTION_ABLATE": i} for i in range(len(ATTENTION_ABLATIONS))])
    vit_shape = vit_attention_shape(model_config(), ATTN_POSE_SHAPE[0], (256, 256))
    times = {}
    for tag, (b, h, n, m, d) in (("pose", ATTN_POSE_SHAPE), ("vit", vit_shape)):
        q, k, v, _ = attention_inputs(b, h, n, m, d)
        out = torch.empty((b, h, n, d), dtype=torch.float32, device="cuda")
        lse = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
        for name, lib in zip(ATTENTION_ABLATIONS, libs):
            fn = lib.pf3_attention_fwd
            fn.restype = ct.c_int
            fn.argtypes = [ct.c_void_p] * 5 + [ct.c_int] * 4 + [ct.c_float, ct.c_void_p]

            def launch(fn=fn):
                kernels.check("attention_fwd (measurement build)", fn(
                    kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(out),
                    kernels.ptr(lse), b * h, n, m, d, d**-0.5, kernels.stream_ptr(q.device)))

            times.setdefault(name, {})[tag] = cuda_ms(launch, 20)
    row = dict(phase="attn_fwd_ablations", shapes=dict(pose=ATTN_POSE_SHAPE, vit=vit_shape),
               ms=times)
    emit(row)
    return row


def table_inputs(screen, image_shape, background, config) -> dict:
    """The dense-table backend up to its composite: binning + table gather
    (the keyword arguments of `composite_table_fwd`)."""
    from pf3plat_tpu_torch.ops.rasterizer import binning, pallas_impl

    binned = binning.bin_gaussians_batched(screen, image_shape, config)
    return pallas_impl.prepare_tables(screen, binned, background, config)


def table_work(args) -> tuple[int, int]:
    """(slots in walked chunks, (pixel, slot) evaluations) of this data."""
    cfg = args["config"]
    chunks = -(-args["counts"].long() // cfg.chunk)
    walked = int(chunks.sum()) * cfg.chunk
    return walked, walked * cfg.tile_size**2


def b6_errors(args, tag: str) -> dict:
    """Kernel B6 against its plain version on the tables `args` (image,
    final T and checkpoints at B2's tolerance; whether T and the checkpoints
    are exact is reported), and a second launch bit-equal to the first."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import pallas_impl

    got = pallas_impl.composite_table_fwd_cuda(**args)
    ref = pallas_impl.composite_table_fwd_plain(**args)
    errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
    if not all(math.isfinite(e) and e <= TOL_B2 for e in errs):
        raise AssertionError(f"B6 {tag}: max abs err (img, tfin, tchk) {errs} > {TOL_B2}")
    exact = all(torch.equal(a, r) for a, r in zip(got[1:], ref[1:]))
    again = pallas_impl.composite_table_fwd_cuda(**args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"B6 {tag}: two runs on the same inputs differ")
    return dict(err_img=errs[0], err_tfin=errs[1], err_tchk=errs[2], tfin_tchk_exact=exact,
                two_runs_bit_equal=True)


def check_b6(args, tag: str, regs: dict) -> dict:
    """Kernel B6 vs its plain version on the same tables (`b6_errors`);
    times, bound, CTAs an SM, shared memory, registers and the work its data
    asks for (`table_fwd_work`)."""
    from pf3plat_tpu_torch.ops.rasterizer import kernels, pallas_impl

    errs = b6_errors(args, tag)
    cfg, ch = args["config"], args["channels"]
    rows, feat, p = args["table"].shape[0], 6 + ch, cfg.tile_size**2
    n_chunks = cfg.tile_capacity // cfg.chunk
    slots, evaluations = table_work(args)
    ms = cuda_ms(lambda: pallas_impl.composite_table_fwd_cuda(**args), 20)
    plain_ms = cuda_ms(lambda: pallas_impl.composite_table_fwd_plain(**args), 3, warmup=1)
    moved = slots * feat * 4 + rows * (8 + 4 * ch) + rows * p * 4 * (ch + 1 + n_chunks)
    pk = peaks()
    t_bytes, t_ops = moved / pk["bw"] * 1e3, evaluations * OPS_B6 / pk["fp32"] * 1e3
    row = dict(phase=f"b6_{tag}", max_abs_err=max(errs[k] for k in ("err_img", "err_tfin",
                                                                     "err_tchk")),
               **errs, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_bytes, t_ops), bound_by="operations" if t_ops >= t_bytes else "bytes",
               tile_rows=rows, slots_in_tables=int(args["counts"].sum()), walked_slots=slots,
               evaluations=evaluations,
               ctas_per_sm=kernels.occupancy("table_fwd", cfg.tile_size, cfg.chunk),
               smem_bytes=kernels.smem_bytes("table_fwd", cfg.tile_size, cfg.chunk),
               registers=regs.get("table_fwd"), fwd_work=table_fwd_work(args))
    emit(row)
    return row


def table_backward_inputs(args, zero_rows=None) -> dict:
    """What kernel B7 takes for the tables `args`: B6's final T and
    checkpoints (every checkpoint of the rows in `zero_rows` set to 0: no
    chunk of theirs is walked) and fixed cotangents of the image (numpy
    seed 1) and of the final T (numpy seed 2)."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import pallas_impl

    cfg, ch = args["config"], args["channels"]
    rows, p = args["table"].shape[0], cfg.tile_size**2
    _, tfin, tchk = pallas_impl.composite_table_fwd_cuda(**args)
    if zero_rows is not None:
        tchk[zero_rows] = 0.0
    g_img = torch.as_tensor(
        np.random.default_rng(1).standard_normal((rows, ch, p)).astype(np.float32), device="cuda")
    g_tfin = torch.as_tensor(
        np.random.default_rng(2).standard_normal((rows, 1, p)).astype(np.float32), device="cuda")
    return dict(table=args["table"], counts=args["counts"], tile_ids=args["tile_ids"],
                bg_rows=args["bg_rows"], tfin=tfin, tchk=tchk, g_img=g_img, g_tfin=g_tfin,
                tiles_x=args["tiles_x"], channels=ch, config=cfg)


def table_bwd_errors(bwd, tag: str):
    """Kernel B7 against its plain version on `bwd` (per table column and
    d(bg) channel at TOL_B3 of its largest plain value), and a second launch
    bit-equal to the first -> (kernel outputs, errors, worst relative error
    per output)."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import pallas_impl

    got = pallas_impl.composite_table_bwd_cuda(**bwd)
    ref = pallas_impl.composite_table_bwd_plain(**bwd)
    errs, worst = {}, {}
    for name, a, r in (("dtab", got[0], ref[0]), ("dbg", got[1], ref[1])):
        for k in range(a.shape[-1]):
            err = float((a[..., k] - r[..., k]).abs().max())
            scale = float(r[..., k].abs().max())
            if not (math.isfinite(err) and err <= TOL_B3 * scale):
                raise AssertionError(f"B7 {tag}: {name}[{k}] max abs err {err} > "
                                     f"{TOL_B3} * {scale}")
            errs[f"{name}{k}"] = err
            worst[name] = max(worst.get(name, 0.0), err / scale if scale > 0 else 0.0)
    again = pallas_impl.composite_table_bwd_cuda(**bwd)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"B7 {tag}: two runs on the same inputs differ")
    return got, errs, worst


def check_b7(args, tag: str, regs: dict) -> dict:
    """Kernel B7 vs its plain version on the same tables, B6's final T and
    checkpoints, and fixed cotangents of the image (numpy seed 1) and of
    the final T (numpy seed 2); per table column at B3's tolerance, two runs
    bit-equal."""
    from pf3plat_tpu_torch.ops.rasterizer import kernels, pallas_impl

    cfg, ch = args["config"], args["channels"]
    rows, feat, p = args["table"].shape[0], 6 + ch, cfg.tile_size**2
    n_chunks = cfg.tile_capacity // cfg.chunk
    bwd = table_backward_inputs(args)
    _, errs, _ = table_bwd_errors(bwd, tag)
    slots, evaluations = table_work(args)
    ms = cuda_ms(lambda: pallas_impl.composite_table_bwd_cuda(**bwd), 10)
    plain_ms = cuda_ms(lambda: pallas_impl.composite_table_bwd_plain(**bwd), 2, warmup=1)
    moved = (slots * feat * 4 + rows * (8 + 4 * ch) + rows * p * 4 * (n_chunks + 2 + ch)
             + rows * cfg.tile_capacity * feat * 4 + rows * ch * 4)
    pk = peaks()
    t_bytes, t_ops = moved / pk["bw"] * 1e3, evaluations * OPS_B7 / pk["fp32"] * 1e3
    row = dict(phase=f"b7_{tag}", max_abs_err=max(errs.values()), errs=errs, tol_rel=TOL_B3,
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes", tile_rows=rows,
               walked_slots=slots, evaluations=evaluations,
               ctas_per_sm=kernels.occupancy("table_bwd", cfg.tile_size, cfg.chunk),
               smem_bytes=kernels.smem_bytes("table_bwd", cfg.tile_size, cfg.chunk),
               registers=regs.get("table_bwd"), two_runs_bit_equal=True)
    emit(row)
    return row


def check_tables(screen, image_shape, background, config, tag: str, regs: dict,
                 backward: bool = True):
    """B6 (and B7) on the dense tables of `screen` -> (B6 row, B7 row)."""
    args = table_inputs(screen, image_shape, background, config)
    return check_b6(args, tag, regs), check_b7(args, tag, regs) if backward else None


def composite(screen, image_shape, background, config, impl):
    """`render`'s compositing stage for a kernel backend."""
    from pf3plat_tpu_torch.ops.rasterizer.binning import bin_gaussians_batched
    from pf3plat_tpu_torch.ops.rasterizer.pallas_impl import composite_tiles_pallas_batched
    from pf3plat_tpu_torch.ops.rasterizer.streamed import composite_streamed_batched

    if impl == "streamed":
        return composite_streamed_batched(screen, image_shape, background, config)
    binned = bin_gaussians_batched(screen, image_shape, config)
    return composite_tiles_pallas_batched(screen, binned, image_shape, background, config)


def render_fwd_bwd(scene, config, impl: str, tag: str | None = None):
    """The bench scene through `render(impl=...)`, forward and backward: ms and
    Mrays/s (bench.py:245-246: 2 views x 256 x 256 rays over the fwd+bwd
    time); then the rasterizer's image (at B2's tolerance) and gradients
    (per field at the B3 tolerance) on the card against the same
    screen-space gaussians rendered on the CPU through the plain versions.
    (The projection is left out of that comparison: the two devices round
    it differently, which can reorder near-equal depth keys.)"""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import render
    from pf3plat_tpu_torch.ops.rasterizer.types import ScreenGaussians

    diff = ("means", "covariances", "sh", "opacities", "background")
    leaves = {k: scene[k].clone().requires_grad_(k in diff) for k in scene}
    tgt = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (2, 256, 256, 3)).astype(
        np.float32), device="cuda")

    def step():
        for k in diff:
            leaves[k].grad = None
        img = render(**leaves, far=leaves["near"] * 100, image_shape=(256, 256),
                     impl=impl, config=config, device="cuda")
        ((img - tgt) ** 2).mean().backward()

    ms = cuda_ms(step, 10)
    rays = 2 * 256 * 256
    grads_finite = all(bool(torch.isfinite(leaves[k].grad).all()) for k in diff)
    if not grads_finite:
        raise AssertionError(f"render_fwd_bwd {impl}: non-finite gradients")

    screen = project(scene, (256, 256), config)
    fields = ("xy", "conic", "opacity", "color")
    errs = {}
    outs, imgs = [], []
    for dev in ("cuda", "cpu"):
        scr = {f: getattr(screen, f).detach().to(dev).clone() for f in ScreenGaussians._fields}
        bg = scene["background"].detach().to(dev).clone().requires_grad_(True)
        for f in fields:
            scr[f].requires_grad_(True)
        img = composite(ScreenGaussians(**scr), (256, 256), bg, config, impl)
        ((img - tgt.to(dev)) ** 2).mean().backward()
        outs.append([scr[f].grad.cpu() for f in fields] + [bg.grad.cpu()])
        imgs.append(img.detach().cpu())
    img_err = float((imgs[0] - imgs[1]).abs().max())
    if not img_err <= TOL_B2:
        raise AssertionError(f"render_fwd_bwd {impl}: image card vs CPU {img_err} > {TOL_B2}")
    for name, a, r in zip(fields + ("background",), *outs):
        err = float((a - r).abs().max())
        scale = float(r.abs().max())
        if not (math.isfinite(err) and err <= TOL_B3 * scale):
            raise AssertionError(f"render_fwd_bwd {impl}: d{name} card vs CPU {err} > "
                                 f"{TOL_B3} * {scale}")
        errs[name] = err
    emit(dict(phase="render_fwd_bwd", impl=impl, case=tag, tile_size=config.tile_size, ms=ms,
              mrays_per_s=rays / (ms * 1e-3) / 1e6, img_err_vs_cpu=img_err, tol_img=TOL_B2,
              grad_err_vs_cpu=errs, tol_rel=TOL_B3))


def mesh_render(scene, mesh):
    """The bench scene through `render(..., mesh=mesh)`, forward and
    backward, three ways, each against the same render without a mesh:
    `streamed` without compaction (B2 per shard, B5 + merge backward) and
    `pallas` (B6 / B7 per shard) at B3's tolerance, per field of the
    gradient relative to its largest value; `streamed` with the production
    config (shard-local pipeline) at TOL_SHARD_LOCAL_* where no shard's
    budget overflowed, else finiteness only, with written / total per shard
    reported."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, compact, kernels, render
    from pf3plat_tpu_torch.ops.rasterizer.shard_local import shard_pairs_budget

    diff = ("means", "covariances", "sh", "opacities", "background")
    shape = (256, 256)
    tgt = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (2, 256, 256, 3)).astype(
        np.float32), device="cuda")

    def run(impl, config, mesh_arg):
        leaves = {k: scene[k].clone().requires_grad_(k in diff) for k in scene}
        kernels.reset_launches()
        img = render(**leaves, far=leaves["near"] * 100, image_shape=shape, impl=impl,
                     config=config, device="cuda", mesh=mesh_arg)
        ((img - tgt) ** 2).mean().backward()
        torch.cuda.synchronize()
        return img.detach(), {k: leaves[k].grad for k in diff}, dict(kernels.LAUNCHES)

    cases = (("streamed_blocks", "streamed", RasterizeConfig(),
              dict(composite_fwd=mesh.size, composite_bwd_blocks=mesh.size, composite_bwd=0)),
             ("streamed_shard_local", "streamed", PRODUCTION_CONFIG,
              dict(compact_pairs=mesh.size, composite_fwd=mesh.size, composite_bwd=mesh.size,
                   dup_reduce=mesh.size)),
             ("pallas", "pallas", PRODUCTION_CONFIG,
              dict(table_fwd=mesh.size, table_bwd=mesh.size)))
    for name, impl, config, want in cases:
        img, grads, launches = run(impl, config, mesh)
        ref_img, ref_grads, _ = run(impl, config, None)
        wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
        if wrong:
            raise AssertionError(f"mesh_render {name}: launches {wrong}, want {want}")
        img_err = float((img - ref_img).abs().max())
        errs = {k: float((grads[k] - ref_grads[k]).abs().max()) for k in diff}
        scales = {k: float(ref_grads[k].abs().max()) for k in diff}
        finite = math.isfinite(img_err) and all(math.isfinite(e) for e in errs.values())
        row = dict(phase="mesh_render", case=name, mesh=mesh.shape, img_max_abs_err=img_err,
                   img_mean_abs_err=float((img - ref_img).abs().mean()), grad_max_abs_err=errs, grad_scale=scales, launches=want)
        if name == "streamed_shard_local":
            screen = project(scene, shape, config)
            b, n = screen.depth.shape
            rows = b * 256
            rps = rows // mesh.size
            budget = shard_pairs_budget(config, b, n, mesh.size)
            stats = []
            for k in range(mesh.size):
                cp = compact.compact_pairs(screen, shape, config, tile_lo=k * rps,
                                           tile_hi=(k + 1) * rps, budget_override=budget)
                stats.append([int(cp["written"]), int(cp["total"])])
            gated = all(w == tot for w, tot in stats)
            tol_img, tol_grad = TOL_SHARD_LOCAL_IMG, TOL_SHARD_LOCAL_GRAD
            row.update(shard_budget=budget, written_total_per_shard=stats, gated=gated)
        else:
            gated, tol_img, tol_grad = True, TOL_B2, TOL_B3
        row.update(tol_img=tol_img, tol_grad_rel=tol_grad)
        emit(row)
        ok = finite and (not gated or (img_err <= tol_img and all(
            errs[k] <= tol_grad * scales[k] for k in diff)))
        if not ok:
            raise AssertionError(f"mesh_render {name}: sharded render differs from the "
                                 f"unsharded one: image {img_err}, gradients {errs}")


def model_config(impl: str = "streamed", raster=None, config: str = "re10k.yaml"):
    """The model of `configs/<config>` through the port's own config loader
    and `main.model_config` (the configs' model: UniDepth ViT-L/14, 128
    depth candidates, SH degree 4, 1024 keypoints / 512 matches / 9 LightGlue
    layers, `DecoderCfg()` = `streamed` with the production rasterizer
    config); `impl` picks the decoder backend, `raster` (if given) its
    rasterizer config."""
    from pf3plat_tpu_torch.main import model_config as main_model_config
    from pf3plat_tpu_torch.models.backbones.unidepth import UniDepthCfg
    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG, DecoderCfg
    from pf3plat_tpu_torch.models.encoder import EncoderCfg
    from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
    from pf3plat_tpu_torch.models.pf3plat import PF3platCfg
    from pf3plat_tpu_torch.utils.config import load_config

    cfg = load_config(REPO / "configs" / config)
    decoder = DecoderCfg(impl=impl, raster=raster or cfg.decoder.raster)
    got = dataclasses.replace(main_model_config(cfg), decoder=decoder)
    # the fields this script set by hand before it read the config files
    want = PF3platCfg(
        encoder=EncoderCfg(num_depth_candidates=128,
                           gaussian_adapter=GaussianAdapterCfg(sh_degree=4)),
        decoder=DecoderCfg(impl=impl, raster=raster or PRODUCTION_CONFIG),
        unidepth=UniDepthCfg(),
        max_keypoints=1024, max_matches=512, lightglue_layers=9,
    )
    if got != want:
        raise AssertionError(f"configs/{config} gives {got}, not the model of record {want}")
    return got


def vit_attention_shape(cfg, views: int, image_shape):
    """(b, h, n, m, d) of the frozen ViT's self-attention for `views`
    images, read from the model's configuration: UniDepth's inference
    resolution in patches plus the class token."""
    from pf3plat_tpu_torch.models.backbones.unidepth import infer_shapes

    vit = cfg.unidepth.vit
    (hi, wi), _ = infer_shapes(image_shape, cfg.unidepth.pixels_bounds, vit.patch_size)
    n = (hi // vit.patch_size) * (wi // vit.patch_size) + 1
    return views, vit.num_heads, n, n, vit.embed_dim // vit.num_heads


@contextlib.contextmanager
def capture_decode():
    """Record the decoder's inputs (decode -> render) of the model calls
    made inside the block: the render scene of the main path."""
    import pf3plat_tpu_torch.models.pf3plat as pf3plat_mod

    captured = {}
    decode = pf3plat_mod.decode

    def recording(cfg, gaussians, extrinsics, intrinsics, near, far, image_shape, **kwargs):
        captured.update(gaussians=type(gaussians)(*(x.detach() for x in gaussians)),
                        extrinsics=extrinsics.detach(), intrinsics=intrinsics.detach(),
                        near=near.detach(), far=far.detach())
        return decode(cfg, gaussians, extrinsics, intrinsics, near, far, image_shape, **kwargs)

    pf3plat_mod.decode = recording
    try:
        yield captured
    finally:
        pf3plat_mod.decode = decode


@contextlib.contextmanager
def capture_attention():
    """Record the (b, h, n, m, d) of every attention the model hands to the
    hand-written kernels inside the block."""
    from pf3plat_tpu_torch.models import layers

    shapes = set()
    forward = layers.attention_fwd

    def recording(q, k, v, scale):
        shapes.add((*q.shape[:3], k.shape[2], q.shape[3]))
        return forward(q, k, v, scale)

    layers.attention_fwd = recording
    try:
        yield shapes
    finally:
        layers.attention_fwd = forward


def serve(impl: str = "streamed", n_requests: int = 3, timed_shapes=frozenset()):
    """The serving request through `DecoderCfg(impl=impl)` -> (the decoder's
    captured inputs, launches, the last request's image on the CPU). Fails
    unless the request's attention ran at every one of `timed_shapes`."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.ops.rasterizer import kernels

    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    model = PF3plat(model_config(impl, config="re10k_test.yaml"), device="cuda")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    b, v, h, w = 1, 5, 256, 256
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32), device="cuda")
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, v, 3, 3)).astype(np.float32),
        device="cuda")
    near = torch.ones((b, v), device="cuda")
    far = torch.full((b, v), 100.0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def request(timer=None):
        with torch.no_grad():
            return model(images, intr, near, far, 0, generator=gen, timer=timer)

    with capture_decode() as captured, capture_attention() as attn_shapes:
        request()  # warm-up: allocator, cuBLAS/cuDNN plans, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    per_request = []
    for _ in range(n_requests):
        events = {"start": torch.cuda.Event(enable_timing=True)}

        def timer(stage, events=events):
            events[stage] = torch.cuda.Event(enable_timing=True)
            events[stage].record()

        wall0 = time.perf_counter()
        events["start"].record()
        enc, out = request(timer)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - wall0) * 1e3
        per_request.append(dict(
            total_ms=wall,
            perceive_ms=events["start"].elapsed_time(events["perceive"]),
            encoder_ms=events["perceive"].elapsed_time(events["encoder"]),
            decoder_ms=events["encoder"].elapsed_time(events["decoder"]),
        ))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    n_g = 2 * h * w
    checks = {
        "color": (out.color, (b, v, h, w, 3)),
        "refined_poses": (enc.refined_poses, (b, v, 4, 4)),
        "means": (enc.gaussians.means, (b, n_g, 3)),
        "opacities": (enc.gaussians.opacities, (b, n_g)),
        "depths": (enc.depths, (b, v, h, w)),
    }
    for name, (x, shape) in checks.items():
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"serve: {name} has shape {tuple(x.shape)} (want {shape}) "
                                 "or non-finite values")
    if not set(timed_shapes) <= attn_shapes:
        raise AssertionError(f"serve: attention shapes {sorted(attn_shapes)} lack some of "
                             f"{sorted(timed_shapes)}")
    for name in FWD_KERNELS[impl] + MODEL_FWD_KERNELS:
        if launches[name] < n_requests:
            raise AssertionError(f"serve {impl}: kernel {name} launched {launches[name]} times "
                                 f"in {n_requests} requests")
    emit(dict(phase="serve", impl=impl, model_build_s=build_s, requests=per_request,
              max_memory_allocated_bytes=peak, launches=launches,
              attention_shapes=sorted(attn_shapes),
              matches_valid=int(enc.correspondences.valid.sum()),
              color_mean=float(out.color.mean())))
    return captured, launches, out.color.cpu()


def train(impl: str = "streamed", n_steps: int = 2, raster=None, mesh=None):
    """The training step of record on the card through
    `DecoderCfg(impl=impl)` (production rasterizer config unless `raster` is
    given; through `mesh` if given, phase `train_mesh`): a warm-up step (its
    render inputs are kept for the kernel checks), then `n_steps` timed
    steps -> (captured render inputs, launches, the warm-up's and the steps'
    losses and gradient norms, the attention shapes seen)."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.ops.rasterizer import kernels
    from pf3plat_tpu_torch.parallel import shard_batch, shard_train_step
    from pf3plat_tpu_torch.training.losses import LossCfg
    from pf3plat_tpu_torch.training.train import (
        OptimizerCfg, init_train_state, make_model_train_step)

    torch.manual_seed(SEED)
    model = PF3plat(model_config(impl, raster), device="cuda")
    exact = impl == "streamed" and raster is not None and raster.pairs_budget_factor == 0
    # launches per step of the decoder's kernels: once each, or once per shard
    per_step_launches = {k: 1 for k in TRAIN_KERNELS[impl]}
    if exact:  # no compaction: no B1, no B4
        per_step_launches = {"composite_fwd": 1, "composite_bwd": 1}
    if mesh is not None:
        if exact:  # the blocks backward takes B3's place
            per_step_launches = {"composite_fwd": 1, "composite_bwd_blocks": 1, "composite_bwd": 0}
        per_step_launches = {k: n * mesh.size for k, n in per_step_launches.items()}
    rng = np.random.default_rng(SEED)
    # re10k.yaml: b=3, 2 context views + 1 target spliced by the union
    # trick (the target stack is the context stack), 256x256
    b, v, h, w = 3, 3, 256, 256
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32), device="cuda")
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, v, 3, 3)).astype(np.float32),
        device="cuda")
    batch = dict(context=dict(image=images, intrinsics=intr, near=torch.ones((b, v), device="cuda"),
                              far=torch.full((b, v), 100.0, device="cuda")),
                 target=dict(image=images))
    step_fn = make_model_train_step(model, LossCfg(), OptimizerCfg(), mesh=mesh)
    if mesh is not None:
        step_fn = shard_train_step(step_fn, mesh)
        batch = shard_batch(mesh, batch)
    state = init_train_state(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    with capture_decode() as captured, capture_attention() as attn_shapes:
        state, warm_aux = step_fn(state, batch, generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    stages = ("perceive", "encoder", "decoder", "loss", "backward", "optimizer")
    per_step = []
    for _ in range(n_steps):
        events = {"start": torch.cuda.Event(enable_timing=True)}

        def timer(stage, events=events):
            events[stage] = torch.cuda.Event(enable_timing=True)
            events[stage].record()

        before = dict(kernels.LAUNCHES)
        wall0 = time.perf_counter()
        events["start"].record()
        state, aux = step_fn(state, batch, generator=gen, timer=timer)
        torch.cuda.synchronize()
        row = dict(total_ms=(time.perf_counter() - wall0) * 1e3)
        wrong = {k: kernels.LAUNCHES[k] - before[k] for k, want in per_step_launches.items()
                 if kernels.LAUNCHES[k] - before[k] != want}
        missing = [k for k in MODEL_TRAIN_KERNELS if kernels.LAUNCHES[k] == before[k]]
        if wrong or missing:
            raise AssertionError(f"train {impl}: launches in a step {wrong} (want "
                                 f"{per_step_launches}); not launched: {missing}")
        prev = "start"
        for stage in stages:
            row[f"{stage}_ms"] = events[prev].elapsed_time(events[stage])
            prev = stage
        row.update({k: float(x) for k, x in aux.items()})
        per_step.append(row)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for row in per_step:
        bad = [k for k, x in row.items() if not math.isfinite(x)]
        if bad:
            raise AssertionError(f"train {impl}: non-finite {bad}")
    emit(dict(phase="train" if mesh is None else "train_mesh", impl=impl,
              mesh=None if mesh is None else mesh.shape,
              pairs_budget_factor=(raster or model.cfg.decoder.raster).pairs_budget_factor,
              batch=[b, v, h, w], steps=per_step, max_memory_allocated_bytes=peak,
              launches=launches, attention_shapes=sorted(attn_shapes),
              warmup_loss=float(warm_aux["loss"])))
    trace = [dict(loss=float(warm_aux["loss"]), grad_norm=float(warm_aux["grad_norm"]))]
    trace += [dict(loss=r["loss"], grad_norm=r["grad_norm"]) for r in per_step]
    del model, state, step_fn
    torch.cuda.empty_cache()
    return captured, launches, trace, attn_shapes


def render_scene(captured):
    """The decoder's render inputs (decode -> render), flattened to b*v
    cameras with each batch element's gaussians repeated per view."""
    import torch

    g = captured["gaussians"]
    b, v = captured["extrinsics"].shape[:2]
    rep = lambda x: x.repeat_interleave(v, dim=0)  # noqa: E731
    return dict(extrinsics=captured["extrinsics"].reshape(b * v, 4, 4),
                intrinsics=captured["intrinsics"].reshape(b * v, 3, 3),
                near=captured["near"].reshape(b * v), means=rep(g.means),
                covariances=rep(g.covariances), sh=rep(g.harmonics), opacities=rep(g.opacities),
                background=torch.zeros((b * v, 3), device="cuda"))


def reference_check(scene, config):
    """One served view rendered end to end on the CPU (plain versions)
    against the card (kernels), from the same projected gaussians."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer.streamed import composite_streamed_batched
    from pf3plat_tpu_torch.ops.rasterizer.types import ScreenGaussians

    screen = project(scene, (256, 256), config)
    one = ScreenGaussians(*(f[:1] for f in screen))
    gpu = composite_streamed_batched(one, (256, 256), scene["background"][:1], config)
    cpu = composite_streamed_batched(
        ScreenGaussians(*(f.cpu() for f in one)), (256, 256),
        scene["background"][:1].cpu(), config)
    err = float((gpu.cpu() - cpu).abs().max())
    if not err <= TOL_B2:
        raise AssertionError(f"reference: card vs CPU render max abs err {err} > {TOL_B2}")
    emit(dict(phase="reference", view=0, max_abs_err=err, tol=TOL_B2))


def depth_phase(captured, config):
    """`decode(..., depth_mode="depth")` on the served request's gaussians
    through both kernel backends: finite, non-negative depth; where the
    accumulated opacity is above 0.5 (final T < 0.5) the opacity-normalised
    depth lies inside the range of the gaussians' camera depths; the share
    of those pixels inside [near, far] is reported."""
    import torch

    from pf3plat_tpu_torch.geometry.projection import se3_inverse
    from pf3plat_tpu_torch.models.decoder import DecoderCfg, decode
    from pf3plat_tpu_torch.ops.rasterizer import kernels, render

    g = captured["gaussians"]
    extr, intr = captured["extrinsics"], captured["intrinsics"]
    near, far = captured["near"], captured["far"]
    b, v = extr.shape[:2]
    scene = render_scene(captured)
    w2c = se3_inverse(scene["extrinsics"])
    cam_z = torch.einsum("bij,bnj->bni", w2c[:, 2:3, :3], scene["means"])[..., 0] \
        + w2c[:, 2, 3][:, None]
    ones = torch.ones_like(scene["opacities"])[..., None, None]
    report = {}
    with torch.no_grad():
        for impl in ("streamed", "pallas"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = decode(DecoderCfg(impl=impl, raster=config), g, extr, intr, near, far,
                         (256, 256), depth_mode="depth")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: kernels.LAUNCHES[k] for k in FWD_KERNELS[impl]}
            if any(n < 2 for n in launches.values()):  # one colour + one depth render
                raise AssertionError(f"depth {impl}: launches {launches}")
            depth = out.depth.reshape(b * v, 256, 256)
            if tuple(out.depth.shape) != (b, v, 256, 256) or not bool(
                    torch.isfinite(depth).all()) or float(depth.min()) < 0.0:
                raise AssertionError(f"depth {impl}: wrong shape, non-finite or negative depth")
            # accumulated opacity = 1 - final T: the same render with colour 1
            acc = render(scene["extrinsics"], scene["intrinsics"], scene["near"],
                         far.reshape(b * v), (256, 256), scene["background"][:, :1],
                         scene["means"], scene["covariances"], ones, scene["opacities"],
                         use_sh=False, impl=impl, config=config, device="cuda")[..., 0]
            solid = acc > 0.5
            if not bool(solid.any()):
                raise AssertionError(f"depth {impl}: no pixel with final T < 0.5")
            mean_z = depth / acc.clamp(min=1e-6)
            zmin = torch.where(cam_z > 0, cam_z, torch.full_like(cam_z, float("inf"))).amin(dim=1)
            zmax = cam_z.amax(dim=1)
            lo, hi = zmin[:, None, None] * (1 - 1e-3), zmax[:, None, None] * (1 + 1e-3)
            if not bool(((mean_z >= lo) & (mean_z <= hi))[solid].all()):
                raise AssertionError(f"depth {impl}: normalised depth outside the gaussians' range")
            nr, fr = near.reshape(-1)[:, None, None], far.reshape(-1)[:, None, None]
            inside = ((mean_z >= nr) & (mean_z <= fr))[solid].float().mean()
            report[impl] = dict(ms_first_call=ms, launches=launches, depth_mean=float(depth.mean()),
                                depth_max=float(depth.max()), solid_share=float(solid.float().mean()),
                                solid_inside_near_far=float(inside), depth=depth)
    a, c = report["streamed"].pop("depth"), report["pallas"].pop("depth")
    emit(dict(phase="depth", mode="depth", streamed=report["streamed"], pallas=report["pallas"],
              backends_max_abs_diff=float((a - c).abs().max()),
              backends_mean_abs_diff=float((a - c).abs().mean())))


def env_inventory() -> dict:
    """What the machine offers the port: versions, which Python packages
    import (and their versions), the host compiler, nvJPEG's library and
    header, host cores and memory."""
    import importlib
    import os
    import platform
    import shutil

    import torch

    imports = {}
    for name in ("PIL", "yaml", "safetensors", "orbax.checkpoint", "numpy", "scipy",
                 "triton", "einops"):
        try:
            mod = importlib.import_module(name)
            imports[name] = getattr(mod, "__version__", True)
        except ImportError:
            imports[name] = False
    gxx = shutil.which("g++")
    if gxx:
        gxx = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    meminfo = Path("/proc/meminfo")
    mem_kib = (int(meminfo.read_text().split("MemTotal:")[1].split()[0])
               if meminfo.exists() else None)
    cuda = Path("/usr/local/cuda")
    return dict(phase="env", python=platform.python_version(), torch=torch.__version__,
                cuda=torch.version.cuda, imports=imports, gxx=gxx,
                nvjpeg_libs=sorted(p.name for p in (cuda / "lib64").glob("libnvjpeg.so*")),
                nvjpeg_header=(cuda / "include" / "nvjpeg.h").exists(),
                host_cores=os.cpu_count(),
                host_memory_gib=None if mem_kib is None else mem_kib / 2**20)


# The training entry point's runs (phase main_train): synthetic RE10K-shaped
# chunks, checkpoints and run outputs under build/.
MAIN_DATA = REPO / "build" / "main_data"
MAIN_CKPT = REPO / "build" / "main_ckpt"
MAIN_OUT = REPO / "build" / "main_out"
TRACE_DIR = REPO / "build" / "traces"
# frames per scene: re10k.yaml's context gap is 75
MAIN_FRAMES = 80
# RE10K's original_image_shape, JPEG quality
MAIN_IMAGE = (360, 640)
MAIN_JPEG_QUALITY = 90
# the first step through `main` against a direct `make_model_train_step`
# call on the same batch, parameters and generator: relative, on the loss
TOL_MAIN_STEP = 1e-5
# The serving entry point's run (phase main_test): outputs under build/.
MAIN_TEST = REPO / "build" / "main_test"
# request 0's PSNR through `main` against a direct forward on its batch,
# parameters and generator, scored the same way: relative
TOL_MAIN_TEST_PSNR = 1e-5
# loss and gradient norm of `make_train_step` on precomputed frozen inputs
# against `make_model_train_step` on the same batch, parameters and
# generator: relative (the encoder's backward is not bit-reproducible, the
# gate of the sharded step)
TOL_TRAIN_FROZEN = 1e-4
MAIN_REDUCED = ["data_loader.batch_size 14 -> 3 (the published single-GPU protocol, "
                "re10k.yaml:26-34)", "max_steps 300001 -> 4 (run A) / 5 (run B)",
                "train.val_check_interval 500 -> 2", "checkpointing.every_n_steps 10000 -> 2",
                "checkpointing.keep 5 -> 2"]


def write_main_data(root: Path) -> list[Path]:
    """Two dataset roots of synthetic RE10K-shaped scenes from numpy seed 0,
    one of `.pfchunk` files (the port's `write_pfchunk`) and one of `.torch`
    chunks, each with `train/` and `test/` splits of 2 chunks x 2 scenes x
    80 frames of 360 x 640 JPEGs (quality 90): a smooth texture panned
    across the frames with camera rows to match (normalised fx 0.86, fy
    1.53, the camera moving 0.02 a frame along x). The training scenes are
    drawn first (keys `<root>_<chunk>_<scene>`), then the test scenes (keys
    `test_<root>_<chunk>_<scene>`)."""
    import io
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from pf3plat_tpu_torch.native import write_pfchunk

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    h, w = MAIN_IMAGE
    shift = 4  # pixels a frame
    roots = [root / "pfchunk", root / "torch"]
    for split, prefix in (("train", ""), ("test", "test_")):
        for kind, r in zip(("pfchunk", "torch"), roots):
            (r / split).mkdir(parents=True)
            for c in range(2):
                scenes = []
                for s in range(2):
                    small = (rng.uniform(0, 255, (h // 8, (w + shift * MAIN_FRAMES) // 8, 3))
                             .astype(np.uint8))
                    tex = np.asarray(Image.fromarray(small).resize(
                        (w + shift * MAIN_FRAMES, h), Image.BICUBIC), np.float32)
                    tex += rng.normal(0, 6, tex.shape)
                    tex = np.clip(tex, 0, 255).astype(np.uint8)
                    cams = np.zeros((MAIN_FRAMES, 18), np.float32)
                    cams[:, :4] = [0.86, 1.53, 0.5, 0.5]
                    frames = []
                    for f in range(MAIN_FRAMES):
                        w2c = np.eye(4, dtype=np.float32)
                        w2c[0, 3] = -0.02 * f
                        cams[f, 6:] = w2c[:3].reshape(-1)
                        buf = io.BytesIO()
                        Image.fromarray(tex[:, f * shift:f * shift + w]).save(
                            buf, format="JPEG", quality=MAIN_JPEG_QUALITY)
                        frames.append(buf.getvalue())
                    scenes.append({"key": f"{prefix}{kind}_{c}_{s}", "cameras": cams,
                                   "images": frames})
                if kind == "pfchunk":
                    write_pfchunk(r / split / f"{c:06}.pfchunk", scenes)
                else:
                    torch.save([{"key": sc["key"], "cameras": torch.from_numpy(sc["cameras"]),
                                 "images": [torch.frombuffer(bytearray(b), dtype=torch.uint8)
                                            for b in sc["images"]]} for sc in scenes],
                               r / split / f"{c:06}.torch")
    return roots


def main_argv(roots, max_steps: int, ckpt: Path, out: Path, *extra) -> list[str]:
    """`main`'s argv for the runs of record: configs/re10k.yaml at b=3."""
    return [str(REPO / "configs" / "re10k.yaml"),
            "dataset.roots=" + json.dumps([str(r) for r in roots]),
            "data_loader.batch_size=3", f"max_steps={max_steps}",
            "train.val_check_interval=2", "checkpointing.every_n_steps=2",
            "checkpointing.keep=2", f'checkpointing.directory="{ckpt}"',
            f'output_dir="{out}"', f'test.output_path="{out}/test/x"', *extra]


class Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def timed_batches(batch_iterator, waits: list):
    """`batch_iterator` whose every wait for the next batch is appended to
    `waits` (ms)."""
    def timed(*args, **kwargs):
        it = batch_iterator(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            waits.append((time.perf_counter() - t0) * 1e3)
            yield batch

    return timed


@contextlib.contextmanager
def instrument_main(on_call=None, after_call=None, timed: bool = True):
    """Record what `main` does inside the block: each train-step call
    (launches of every kernel; with `timed`, also host ms, the stage split
    by CUDA events, peak memory and the loss) and each wait for the next
    batch (`data_wait_ms`). `on_call(index, model, state, batch, kwargs)`
    runs before a step, `after_call(index)` after it. Patches
    `training.train.make_model_train_step` and `main.batch_iterator`, which
    `main.run_train` looks up when it runs."""
    import torch

    import pf3plat_tpu_torch.main as port_main
    from pf3plat_tpu_torch.ops.rasterizer import kernels
    from pf3plat_tpu_torch.training import train as train_mod

    rec = {"steps": [], "data_wait_ms": []}
    make_step, batch_iterator = train_mod.make_model_train_step, port_main.batch_iterator
    stages = ("perceive", "encoder", "decoder", "loss", "backward", "optimizer")

    def recording_make_step(model, *args, **kwargs):
        step = make_step(model, *args, **kwargs)

        def instrumented(state, batch, **kw):
            index = len(rec["steps"])
            if on_call is not None:
                on_call(index, model, state, batch, kw)
            before = dict(kernels.LAUNCHES)
            if not timed:
                state, aux = step(state, batch, **kw)
                rec["steps"].append(dict(step=state.step, launches={
                    k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}))
                if after_call is not None:
                    after_call(index)
                return state, aux
            events = {"start": torch.cuda.Event(enable_timing=True)}

            def timer(stage):
                events[stage] = torch.cuda.Event(enable_timing=True)
                events[stage].record()

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wall0 = time.perf_counter()
            events["start"].record()
            state, aux = step(state, batch, timer=timer, **kw)
            torch.cuda.synchronize()
            row = dict(step=state.step, ms=(time.perf_counter() - wall0) * 1e3,
                       views=int(batch["context"]["image"].shape[1]),
                       launches={k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES},
                       max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            prev = "start"
            for stage in stages:
                row[f"{stage}_ms"] = events[prev].elapsed_time(events[stage])
                prev = stage
            row.update(loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]))
            rec["steps"].append(row)
            if after_call is not None:
                after_call(index)
            return state, aux

        return instrumented

    train_mod.make_model_train_step = recording_make_step
    port_main.batch_iterator = timed_batches(batch_iterator, rec["data_wait_ms"])
    try:
        yield rec
    finally:
        train_mod.make_model_train_step = make_step
        port_main.batch_iterator = batch_iterator


def run_main(argv) -> str:
    """`python -m pf3plat_tpu_torch.main <argv>` in this process; returns
    what it printed."""
    from pf3plat_tpu_torch import main as port_main

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        port_main.main(argv)
    return tee.text()


def main_train(train_per_step: dict) -> dict:
    """The training entry point at full width (configs/re10k.yaml, b=3,
    256 x 256, UniDepth ViT-L, 128 depth candidates, SH degree 4,
    PRODUCTION_CONFIG) on synthetic chunks of both formats. Run A trains 4
    steps with validation every 2 and checkpoints every 2 (keep 2); run B
    resumes it for a fifth step. `train_per_step`: the `train` phase's
    launches per step, which every step through `main` must repeat.
    Returns the per-kernel launches of one step through `main`."""
    import gc
    import shutil

    import numpy as np
    import torch

    from pf3plat_tpu_torch import main as port_main
    from pf3plat_tpu_torch.training import train as train_mod
    from pf3plat_tpu_torch.training.train import OptState, TrainState
    from pf3plat_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    roots = write_main_data(MAIN_DATA)
    data_s = time.perf_counter() - t0
    for d in (MAIN_CKPT, MAIN_OUT):
        shutil.rmtree(d, ignore_errors=True)

    # run A
    first = {}

    def keep_first(index, model, state, batch, kw):
        if index == 0:
            # on the host, so the copy does not count in the steps' peak memory
            first.update(model={k: v.detach().to("cpu", copy=True)
                                for k, v in model.state_dict().items()},
                         batch=batch, generator=kw["generator"].get_state(), step=state.step)

    argv_a = main_argv(roots, 4, MAIN_CKPT, MAIN_OUT)
    t0 = time.perf_counter()
    with instrument_main(keep_first) as rec_a:
        out_a = run_main(argv_a)
    run_a_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    steps = rec_a["steps"]
    for i, row in enumerate(steps):  # batch k was waited for before step k
        row["data_wait_ms"] = rec_a["data_wait_ms"][i]
    losses = [r["loss"] for r in steps]
    if len(steps) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"main_train run A: {len(steps)} steps, losses {losses}")
    if "failed" in out_a:
        raise AssertionError("main_train run A: a validation failed:\n" + out_a[-2000:])

    # step 1 again through a direct make_model_train_step call: the batch
    # main drew, the model as it was, the same generator state
    cfg = load_config(argv_a[0], argv_a[1:])
    model = port_main.build_model(cfg, "cuda")
    model.load_state_dict(first.pop("model"))
    params = list(model.encoder.parameters())
    state = TrainState(params, OptState(0, [torch.zeros_like(p) for p in params],
                                        [torch.zeros_like(p) for p in params], 0), first["step"])
    gen = torch.Generator(device="cuda")
    gen.set_state(first["generator"])
    _, aux = train_mod.make_model_train_step(model, cfg.loss, cfg.optimizer)(
        state, first.pop("batch"), generator=gen)
    direct = float(aux["loss"])
    step1_rel = abs(direct - losses[0]) / abs(losses[0])
    del model, state, params, aux
    gc.collect()
    torch.cuda.empty_cache()
    if not step1_rel <= TOL_MAIN_STEP:
        raise AssertionError(f"main_train: step 1's loss {losses[0]} through main against "
                             f"{direct} directly: {step1_rel} > {TOL_MAIN_STEP}")

    ckpts = sorted(int(p.name) for p in (MAIN_CKPT / "state").iterdir())
    frozen = sorted(p.name for p in MAIN_CKPT.iterdir() if p.name.startswith("frozen"))
    if ckpts != [2, 4] or frozen != ["frozen"]:
        raise AssertionError(f"main_train run A: checkpoints {ckpts}, frozen dirs {frozen}")
    val_dir = MAIN_OUT / "test" / "validation"
    val_steps = sorted(p.name for p in val_dir.iterdir())
    missing = [f"{d}/{f}" for d in ("step_0000000", "step_0000002", "step_0000004")
               for f in ("comparison.png", "wobble.gif") if not (val_dir / d / f).exists()]
    if missing:
        raise AssertionError(f"main_train run A: validation artifacts missing: {missing} "
                             f"(folders {val_steps})")
    log_rows = (MAIN_OUT / "scalars.jsonl").read_text().splitlines()
    if len(log_rows) != 4:
        raise AssertionError(f"main_train run A: {len(log_rows)} log rows, want 4")
    per_step = steps[0]["launches"]
    wrong = [(i + 1, k, r["launches"][k], n) for i, r in enumerate(steps)
             for k, n in train_per_step.items() if r["launches"][k] != n]
    if wrong:
        raise AssertionError(f"main_train: launches per step through main (step, kernel, "
                             f"got, train phase) {wrong}")

    # run B: the same run resumed for one more step
    saved = torch.load(MAIN_CKPT / "state" / "4" / "state.pt", map_location="cpu",
                       weights_only=True)
    restored = {}

    def check_restored(index, model, state, batch, kw):
        if index == 0:
            got = state.params + state.opt_state.mu + state.opt_state.nu
            want = saved["params"] + saved["mu"] + saved["nu"]
            restored.update(
                tensors_bit_equal=len(got) == len(want) and all(
                    torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                count=(state.opt_state.count, saved["count"]),
                step=(state.step, saved["step"]),
                notfinite_count=(state.opt_state.notfinite_count, saved["notfinite_count"]))

    t0 = time.perf_counter()
    with instrument_main(check_restored) as rec_b:
        out_b = run_main(main_argv(roots, 5, MAIN_CKPT, MAIN_OUT))
    run_b_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    if "resumed from step 4" not in out_b:
        raise AssertionError("main_train run B: no 'resumed from step 4' in its output")
    if not (restored.get("tensors_bit_equal") and all(
            a == b for a, b in (restored[k] for k in ("count", "step", "notfinite_count")))):
        raise AssertionError(f"main_train run B: restored state differs from run A's "
                             f"step-4 checkpoint: {restored}")
    steps_b = rec_b["steps"]
    if len(steps_b) != 1 or not math.isfinite(steps_b[0]["loss"]):
        raise AssertionError(f"main_train run B: steps {steps_b}")
    steps_b[0]["data_wait_ms"] = rec_b["data_wait_ms"][0]

    emit(dict(phase="main_train", config="configs/re10k.yaml", reduced=MAIN_REDUCED,
              batch=[3, steps[0]["views"], 256, 256], data_s=data_s,
              data=[f"{r.name}: 2 chunks x 2 scenes x {MAIN_FRAMES} frames of "
                    f"{MAIN_IMAGE[0]}x{MAIN_IMAGE[1]} JPEG q{MAIN_JPEG_QUALITY}" for r in roots],
              run_a_s=run_a_s, run_b_s=run_b_s,
              steps=[{k: v for k, v in r.items() if k != "launches"} for r in steps],
              resumed_step=[{k: v for k, v in r.items() if k != "launches"} for r in steps_b],
              launches_per_step=per_step, train_phase_per_step=train_per_step,
              step1_loss_main=losses[0], step1_loss_direct=direct, step1_rel_diff=step1_rel,
              tol=TOL_MAIN_STEP, checkpoints=ckpts, validation=val_steps,
              log_rows=len(log_rows), restored=restored,
              data_wait_ms_mean=float(np.mean([r["data_wait_ms"] for r in steps[1:]]))))
    return per_step


@contextlib.contextmanager
def instrument_test():
    """Record what `main` does in `mode=test` inside the block: per request
    (`Evaluator.run_example`) the host ms around it (ending in a device
    synchronisation), the launches of every kernel, and each wait for the
    next batch; request 0's evaluator, raw batch and generator state are
    kept for the direct check. Patches `Evaluator.run_example` and
    `main.batch_iterator`, which `main.run_test` looks up when it runs."""
    import torch

    import pf3plat_tpu_torch.main as port_main
    from pf3plat_tpu_torch.evaluation.evaluator import Evaluator
    from pf3plat_tpu_torch.ops.rasterizer import kernels

    rec = {"requests": [], "data_wait_ms": []}
    run_example, batch_iterator = Evaluator.run_example, port_main.batch_iterator

    def recording(self, example, generator, step_idx):
        if step_idx == 0:
            rec.update(evaluator=self, example=example, generator=generator.get_state())
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = run_example(self, example, generator, step_idx)
        torch.cuda.synchronize()
        rec["requests"].append(dict(
            ms=(time.perf_counter() - t0) * 1e3, views=int(example["context"]["image"].shape[1]),
            launches={k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}))
        return record

    Evaluator.run_example = recording
    port_main.batch_iterator = timed_batches(batch_iterator, rec["data_wait_ms"])
    try:
        yield rec
    finally:
        Evaluator.run_example = run_example
        port_main.batch_iterator = batch_iterator


def main_test(serve_per_request: dict | None) -> dict:
    """The serving entry point at full width: `main` on configs/re10k_test.yaml
    (b=1, 2 context + 3 target views spliced into v=5, 256 x 256, LPIPS,
    depth panels, 30-frame wobble and interpolation videos) over the test
    splits of the main_train data (8 scenes), restored from main_train's
    checkpoint directory, through an evaluation index in the released
    schema. First the index generator's CLI on each root. Gates: the
    restore line; 8 scores, finite PSNR / SSIM / LPIPS; benchmark.json's
    count 8 - 5; peak memory from torch.cuda; every artifact; request 0's
    PSNR equal to a direct `PF3plat.forward` on its batch and generator
    (1e-5 relative); launches per request = the serve phase's (when given;
    else request 0's) plus one B1 and one B2 per extra render (depth, and
    two videos of ceil(30 / 6) chunks). Returns the launches per request."""
    import shutil

    import numpy as np
    import torch

    from pf3plat_tpu_torch.evaluation import index_generator
    from pf3plat_tpu_torch.evaluation.evaluator import VIDEO_CHUNK
    from pf3plat_tpu_torch.ops.rasterizer import kernels
    from pf3plat_tpu_torch.training.metrics import compute_psnr

    roots = [MAIN_DATA / "pfchunk", MAIN_DATA / "torch"]
    shutil.rmtree(MAIN_TEST, ignore_errors=True)
    MAIN_TEST.mkdir(parents=True)
    generated = {}
    for r in roots:
        t0 = time.perf_counter()
        out_json = MAIN_TEST / f"generated_index_{r.name}.json"
        index_generator.main([str(r), "--out", str(out_json)])
        gen = json.loads(out_json.read_text())
        generated[r.name] = dict(valid=sum(v is not None for v in gen.values()), total=len(gen),
                                 s=time.perf_counter() - t0)
    keys = sorted(f"test_{r.name}_{c}_{s}" for r in roots for c in range(2) for s in range(2))
    index = {}
    for k, key in enumerate(keys):
        i = 5 + 3 * k
        index[key] = {"context": [i, i + 45],
                      "target": [int(x) for x in np.round(np.linspace(i, i + 45, 5)[1:-1])]}
    index["scene_not_in_the_data"] = None  # the released index's null entries
    (MAIN_TEST / "index.json").write_text(json.dumps(index))

    frames = 30
    argv = [str(REPO / "configs" / "re10k_test.yaml"),
            "dataset.roots=" + json.dumps([str(r) for r in roots]),
            f'evaluation_index="{MAIN_TEST / "index.json"}"',
            f'checkpointing.directory="{MAIN_CKPT}"', f'test.output_path="{MAIN_TEST / "out"}"',
            "test.save_video=true", f"test.video_frames={frames}"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()  # peak_memory.json: this run's peak
    kernels.reset_launches()
    with instrument_test() as rec:
        printed = run_main(argv)
    launches = dict(kernels.LAUNCHES)
    run_s = time.perf_counter() - t0
    out = MAIN_TEST / "out"
    n_req = len(keys)
    if "loaded checkpoint at step" not in printed:
        raise AssertionError("main_test: no 'loaded checkpoint at step' in its output")
    scores = json.loads((out / "scores_all_avg.json").read_text())
    bench = json.loads((out / "benchmark.json").read_text())
    memory = json.loads((out / "peak_memory.json").read_text())
    bad = [k for k in ("psnr", "ssim", "lpips") if not math.isfinite(scores["all"].get(k, math.nan))]
    if scores["all"]["count"] != n_req or bad or len(rec["requests"]) != n_req:
        raise AssertionError(f"main_test: {len(rec['requests'])} requests, scores "
                             f"{scores['all']} (want count {n_req}, finite psnr/ssim/lpips)")
    if bench["encoder_decoder"]["count"] != n_req - 5:
        raise AssertionError(f"main_test: benchmark.json {bench} (want count {n_req - 5})")
    if not all(isinstance(memory.get(k), int) and memory[k] > 0
               for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")):
        raise AssertionError(f"main_test: peak_memory.json {memory}")
    files = {"images/pred": 3 * n_req, "images/gt": 3 * n_req, "compare": n_req,
             "depth": n_req, "video": 2 * n_req}
    found = {d: len(list((out / d).glob("*.png" if d != "video" else "*.gif"))) for d in files}
    if found != files:
        raise AssertionError(f"main_test: artifacts {found}, want {files}")

    # request 0 again through a direct forward: its batch, the restored
    # model, the same generator state; scored as the evaluator scores
    model = rec["evaluator"].model
    ctx = rec["example"]["context"]
    images, intr, near, far = (torch.as_tensor(np.asarray(ctx[k]), dtype=torch.float32,
                                               device="cuda")
                               for k in ("image", "intrinsics", "near", "far"))
    gen = torch.Generator(device="cuda")
    gen.set_state(rec["generator"])
    with torch.no_grad():
        _, pred = model(images, intr, near, far, 0, depth_mode="depth", generator=gen)
        psnr = float(compute_psnr(images[0, 1:-1], pred.color[0, 1:-1]).mean())
    record0 = json.loads((out / "metrics.txt").read_text().splitlines()[0])
    psnr_rel = abs(psnr - record0["psnr"]) / abs(record0["psnr"])
    if not psnr_rel <= TOL_MAIN_TEST_PSNR:
        raise AssertionError(f"main_test: request 0's PSNR {record0['psnr']} through main, "
                             f"{psnr} directly: {psnr_rel} > {TOL_MAIN_TEST_PSNR}")

    # launches per request: a serving request's, plus one B1 and one B2 for
    # the depth render and for each video chunk
    renders = 1 + 2 * math.ceil(frames / VIDEO_CHUNK)
    base = serve_per_request or {k: n for k, n in rec["requests"][0]["launches"].items()
                                 if k == "attention_fwd"}
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(base)
    for k in FWD_KERNELS["streamed"]:
        want[k] = base.get(k, 1) + renders
    wrong = [(i, k, r["launches"][k], want[k]) for i, r in enumerate(rec["requests"])
             for k in want if r["launches"][k] != want[k]]
    if wrong or sum(r["launches"]["attention_fwd"] for r in rec["requests"]) == 0:
        raise AssertionError(f"main_test: launches per request (request, kernel, got, want) "
                             f"{wrong[:8]}")
    times = rec["evaluator"].benchmarker.execution_times["encoder_decoder"]
    emit(dict(phase="main_test", config="configs/re10k_test.yaml", batch=[1, 5, 256, 256],
              index_generator=generated, requests=n_req, run_s=run_s,
              request_ms=[r["ms"] for r in rec["requests"]],
              encoder_decoder_ms=[x * 1e3 for x in times],
              benchmark_median_ms=bench["encoder_decoder"]["median_s"] * 1e3,
              benchmark_mean_ms=bench["encoder_decoder"]["mean_s"] * 1e3,
              peak_bytes_in_use=memory["peak_bytes_in_use"], bytes_limit=memory["bytes_limit"],
              first_batch_wait_ms=rec["data_wait_ms"][0],
              data_wait_ms=rec["data_wait_ms"][1:], scores_all=scores["all"],
              request0_psnr_main=record0["psnr"], request0_psnr_direct=psnr,
              request0_psnr_rel_diff=psnr_rel, tol=TOL_MAIN_TEST_PSNR,
              launches_per_request=rec["requests"][0]["launches"], launches_want=want,
              launches_serve_per_request=serve_per_request, renders_beyond_serve=renders,
              launches_total=launches, artifacts=found))
    del rec, model
    return want


def train_frozen() -> dict:
    """`make_train_step` (the step on precomputed frozen inputs) at full
    width: the training step of record's batch (b=3, v=3, 256 x 256,
    configs/re10k.yaml's model, random weights from the seed), frozen inputs
    from `model.perceive`; a warm-up step, then one timed step from the
    initial parameters, whose loss and gradient norm must equal
    `make_model_train_step`'s step from the same parameters, batch and
    generator to TOL_TRAIN_FROZEN. B1-B4 launch once in the step."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.ops.rasterizer import kernels
    from pf3plat_tpu_torch.training.losses import LossCfg
    from pf3plat_tpu_torch.training.train import (
        OptimizerCfg, TrainState, make_model_train_step, make_optimizer, make_train_step)

    torch.manual_seed(SEED)
    model = PF3plat(model_config(), device="cuda")
    rng = np.random.default_rng(SEED)
    b, v, h, w = 3, 3, 256, 256
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32), device="cuda")
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, v, 3, 3)).astype(np.float32),
        device="cuda")
    ctx = dict(image=images, intrinsics=intr, near=torch.ones((b, v), device="cuda"),
               far=torch.full((b, v), 100.0, device="cuda"))
    params = list(model.encoder.parameters())
    initial = [p.detach().clone() for p in params]
    opt = make_optimizer(OptimizerCfg())

    def fresh() -> TrainState:
        with torch.no_grad():
            for p, x in zip(params, initial):
                p.copy_(x)
        return TrainState(params, opt.init(params), 0)

    def generator():
        return torch.Generator(device="cuda").manual_seed(SEED + 1)

    t0 = time.perf_counter()
    frozen, corr = model.perceive(images, intr)
    torch.cuda.synchronize()
    perceive_ms = (time.perf_counter() - t0) * 1e3
    batch = dict(context=ctx, target=dict(image=images), frozen=frozen, corr=corr)
    step = make_train_step(model.encoder, model.cfg.decoder, LossCfg(), opt, (h, w),
                           lpips_apply=model.lpips_apply)
    step(fresh(), batch, generator=generator())  # warm-up
    state = fresh()
    torch.cuda.synchronize()
    kernels.reset_launches()
    events = {"start": torch.cuda.Event(enable_timing=True)}

    def timer(stage):
        events[stage] = torch.cuda.Event(enable_timing=True)
        events[stage].record()

    wall0 = time.perf_counter()
    events["start"].record()
    _, aux = step(state, batch, generator=generator(), timer=timer)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - wall0) * 1e3
    launches = dict(kernels.LAUNCHES)
    stages, prev = {}, "start"
    for stage in ("encoder", "decoder", "loss", "backward", "optimizer"):
        stages[f"{stage}_ms"] = events[prev].elapsed_time(events[stage])
        prev = stage
    got = {k: float(aux[k]) for k in ("loss", "grad_norm")}
    _, aux_m = make_model_train_step(model, LossCfg(), OptimizerCfg())(
        fresh(), dict(context=ctx, target=dict(image=images)), generator=generator())
    want = {k: float(aux_m[k]) for k in ("loss", "grad_norm")}
    rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in got)
    emit(dict(phase="train_frozen", batch=[b, v, h, w], ms=ms, perceive_ms_outside=perceive_ms,
              **stages, launches=launches, make_train_step=got, make_model_train_step=want,
              max_rel_diff=rel, tol=TOL_TRAIN_FROZEN))
    once = {k: launches[k] for k in TRAIN_KERNELS["streamed"]}
    if any(n != 1 for n in once.values()) or not all(launches[k] for k in MODEL_TRAIN_KERNELS):
        raise AssertionError(f"train_frozen: launches {launches} (B1-B4 once, attention both)")
    if not all(math.isfinite(x) for x in got.values()) or not rel <= TOL_TRAIN_FROZEN:
        raise AssertionError(f"train_frozen: make_train_step {got} against "
                             f"make_model_train_step {want}: {rel} > {TOL_TRAIN_FROZEN}")
    del model, state, batch, frozen, corr
    torch.cuda.empty_cache()
    return launches


def bf16_operands():
    """A torch function mode that rounds the operands of every matmul,
    convolution and library attention to bf16 and computes in float32: the
    JAX package's `default_matmul_precision("bfloat16")` (one bf16 pass,
    float32 sums and outputs). Biases stay float32."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    two = {F.linear, torch.conv1d, torch.conv2d, F.conv1d, F.conv2d, F.conv_transpose2d}
    every = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.bmm,
             torch.einsum, F.scaled_dot_product_attention}
    last_two = {torch.addmm, torch.baddbmm}

    def rnd(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        if isinstance(x, (list, tuple)):
            return type(x)(rnd(y) for y in x)
        return x

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in two:
                args = (rnd(args[0]), rnd(args[1]), *args[2:])
            elif func in every:
                args = tuple(rnd(a) for a in args)
            elif func in last_two:
                args = (args[0], rnd(args[1]), rnd(args[2]), *args[3:])
            return func(*args, **kwargs)

    return Mode()


def perceive_precision() -> dict:
    """`PF3plat.perceive` on the serving request (b=1, v=5, 256 x 256,
    configs/re10k_test.yaml's model, random weights from the seed) three
    ways: under bf16 autocast (the port's default on the card), with
    `frozen_matmul_precision="highest"` (float32), and float32 modules with
    bf16-rounded matmul and convolution operands (the JAX package's rule,
    `bf16_operands`). Per mode: the ms of 3 calls after a warm-up (CUDA
    events), and the depth, feature and match differences from "highest"."""
    import contextlib as ctxlib

    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat

    torch.manual_seed(SEED)
    model = PF3plat(model_config(config="re10k_test.yaml"), device="cuda")
    base = model.cfg
    rng = np.random.default_rng(SEED)
    b, v, h, w = 1, SERVE_VIEWS, 256, 256
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32), device="cuda")
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, v, 3, 3)).astype(np.float32),
        device="cuda")
    modes = {"autocast": ("bfloat16", ctxlib.nullcontext), "highest": ("highest", ctxlib.nullcontext),
             "jax_rule": ("highest", bf16_operands)}
    outs, ms = {}, {}
    for name, (precision, scope) in modes.items():
        model.cfg = dataclasses.replace(base, frozen_matmul_precision=precision)
        with scope():
            model.perceive(images, intr)  # warm-up
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                frozen, corr = model.perceive(images, intr)
            end.record()
            torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / 3
        outs[name] = (frozen, corr)
    model.cfg = base

    def rel(a, c):
        return dict(max_rel=float((a - c).abs().max() / c.abs().max()),
                    mean_rel=float((a - c).abs().mean() / c.abs().mean()))

    ref_f, ref_c = outs["highest"]
    diffs = {}
    for name in ("autocast", "jax_rule"):
        f, c = outs[name]
        both = c.valid & ref_c.valid
        diffs[name] = dict(
            depth=rel(f.depth, ref_f.depth), features=rel(f.features, ref_f.features),
            matches_valid=int(c.valid.sum()), matches_valid_highest=int(ref_c.valid.sum()),
            matches_valid_agree=float((c.valid == ref_c.valid).float().mean()),
            kpts_equal=float((c.kpts0 == ref_c.kpts0).all(-1).float().mean()),
            scores_max_abs=float((c.scores - ref_c.scores)[both].abs().max()) if bool(both.any())
            else None)
    ratio = {k: diffs["autocast"][k]["mean_rel"] / max(diffs["jax_rule"][k]["mean_rel"], 1e-30)
             for k in ("depth", "features")}
    emit(dict(phase="perceive_precision", batch=[b, v, h, w], perceive_ms=ms,
              jax_rule_cost=ms["jax_rule"] / ms["autocast"] - 1.0, diffs_from_highest=diffs,
              autocast_over_jax_rule=ratio))
    for name, (f, _) in outs.items():
        if not (bool(torch.isfinite(f.depth).all()) and bool(torch.isfinite(f.features).all())):
            raise AssertionError(f"perceive_precision: non-finite outputs under {name}")
    del model, outs
    torch.cuda.empty_cache()
    return dict(ms=ms, diffs=diffs, ratio=ratio)


def trace_window(log_dir: Path, window: str) -> dict:
    """Device-busy ms against wall ms of one traced window, and its ten
    operations with the most device time."""
    from pf3plat_tpu_torch.utils import profiling

    busy = profiling.device_busy(log_dir, window=window)
    top = profiling.device_op_breakdown(log_dir, top=10, window=window)
    return dict(busy_ms=busy["busy_us"] / 1e3, wall_ms=busy["wall_us"] / 1e3,
                idle_share=busy["idle_share"], device_events=busy["device_events"],
                launch_lead_min_us=busy["launch_lead_min_us"],
                negative_leads=busy["negative_leads"],
                negative_lead_ms=busy["negative_lead_us"] / 1e3,
                top_ops=[dict(name=r["name"][:100], ms=r["total_us"] / 1e3, count=r["count"],
                              launched_by=r["launched_by"]) for r in top])


def trace_child(out_path: Path) -> int:
    """The traced windows, run in a fresh process (`--trace-child`): two warm
    steps of `main`'s loop (steps 2 and 3 of a 3-step run of
    configs/re10k.yaml at b=3 on the main_train data) and one serving
    request of the `serve` phase's model (after a warm-up request). Writes
    {window: trace_window(...)} to `out_path`."""
    import shutil

    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    seconds = {}
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    model = PF3plat(model_config(config="re10k_test.yaml"), device="cuda")
    rng = np.random.default_rng(SEED)
    b, v, h, w = 1, SERVE_VIEWS, 256, 256
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32), device="cuda")
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, v, 3, 3)).astype(np.float32),
        device="cuda")
    near, far = torch.ones((b, v), device="cuda"), torch.full((b, v), 100.0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    stack = contextlib.ExitStack()

    def open_window(index, model_, state, batch, kw):
        if index == 1:  # steps 2 and 3: the loop's warm steps
            stack.enter_context(profiling.trace(TRACE_DIR / "main_train", window="main_train"))

    def close_window(index):
        if index == 2:
            stack.close()

    ckpt, out = REPO / "build" / "trace_ckpt", REPO / "build" / "trace_out"
    for d in (ckpt, out):
        shutil.rmtree(d, ignore_errors=True)
    roots = [MAIN_DATA / "pfchunk", MAIN_DATA / "torch"]
    seconds["serve_model"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # untimed: no synchronisation or events of this script inside the window
    with instrument_main(open_window, close_window, timed=False) as rec:
        run_main(main_argv(roots, 3, ckpt, out, "train.sanity_validation=false",
                           "train.val_check_interval=1000", "checkpointing.every_n_steps=1000"))
    seconds["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        model(images, intr, near, far, 0, generator=gen)  # warm-up
        with profiling.trace(TRACE_DIR / "serve", window="serve"):
            model(images, intr, near, far, 0, generator=gen)
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = {"main_train": trace_window(TRACE_DIR / "main_train", "main_train"),
              "serve": trace_window(TRACE_DIR / "serve", "serve")}
    seconds["analysis"] = time.perf_counter() - t0
    result.update(seconds=seconds, data_wait_ms=rec["data_wait_ms"])
    out_path.write_text(json.dumps(result))
    return 0


def trace_phase() -> None:
    """Phase `trace`: the traced windows in a child process (a fresh
    process: `torch.profiler` stamps device activity by a clock that drifts
    from the host's over a long process's life, and drops what it places
    before its session's start; `late_probe` shows that in this process).
    Fails if the child fails or a window holds no device event."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import compact
    from pf3plat_tpu_torch.utils import profiling

    out_path = REPO / "build" / "trace_child.json"
    out_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--trace-child",
                           str(out_path)], capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0 or not out_path.exists():
        raise AssertionError(f"trace: child exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    result = json.loads(out_path.read_text())
    empty = [k for k in ("main_train", "serve") if result[k]["device_events"] == 0]
    if empty:
        raise AssertionError(f"trace: no device events in the window(s) {empty}")

    # the same kind of session in this long-lived process: one B1 call and
    # one matmul (3 kernels and 1 memset on the card)
    n = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cand = dict(valid=torch.rand(n, device="cuda", generator=gen) < 0.5,
                tile=torch.randint(0, 1000, (n,), device="cuda", dtype=torch.int32,
                                   generator=gen),
                dkey=torch.randint(0, 1000, (n,), device="cuda", dtype=torch.int32,
                                   generator=gen),
                pid=torch.arange(n, device="cuda", dtype=torch.int32),
                feats=torch.randn((9, n), device="cuda", generator=gen))
    a = torch.randn((2048, 2048), device="cuda", generator=gen)
    torch.cuda.synchronize()
    probe_dir = TRACE_DIR / "late_probe"
    with profiling.trace(probe_dir, window="late_probe"):
        a @ a
        compact.compact_candidates_cuda(cand, n // 2, 4096)
    probe = profiling.device_busy(probe_dir, window="late_probe")
    emit(dict(phase="trace", child_s=child_s, traces=str(TRACE_DIR.relative_to(REPO)),
              main_train=result["main_train"], serve=result["serve"],
              main_train_data_wait_ms=result["data_wait_ms"], child_seconds=result["seconds"],
              late_probe=dict(device_events=probe["device_events"], expected=4,
                              busy_ms=probe["busy_us"] / 1e3, wall_ms=probe["wall_us"] / 1e3,
                              launch_lead_min_us=probe["launch_lead_min_us"],
                              negative_leads=probe["negative_leads"])))


KERNEL_META = {
    "compact_pairs": ("pf3plat_tpu_torch/csrc/compact_pairs.cu",
                      "pf3plat_tpu/ops/rasterizer/compact.py:87"),
    "composite_fwd": ("pf3plat_tpu_torch/csrc/composite_fwd.cu",
                      "pf3plat_tpu/ops/rasterizer/streamed.py:365"),
    "composite_bwd": ("pf3plat_tpu_torch/csrc/composite_bwd.cu",
                      "pf3plat_tpu/ops/rasterizer/streamed.py:588"),
    "dup_reduce": ("pf3plat_tpu_torch/csrc/dup_reduce.cu",
                   "pf3plat_tpu/ops/rasterizer/compact.py:448"),
    "composite_bwd_blocks": ("pf3plat_tpu_torch/csrc/composite_bwd_blocks.cu",
                             "pf3plat_tpu/ops/rasterizer/streamed.py:777"),
    "table_fwd": ("pf3plat_tpu_torch/csrc/table_fwd.cu",
                  "pf3plat_tpu/ops/rasterizer/pallas_impl.py:98"),
    "table_bwd": ("pf3plat_tpu_torch/csrc/table_bwd.cu",
                  "pf3plat_tpu/ops/rasterizer/pallas_impl.py:187"),
    "attention_fwd": ("pf3plat_tpu_torch/csrc/attention_fwd.cu",
                      "pf3plat_tpu/models/layers.py:73"),
    "attention_bwd": ("pf3plat_tpu_torch/csrc/attention_bwd.cu",
                      "pf3plat_tpu/models/layers.py:73"),
}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "pf3plat_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    if argv[:1] == ["--trace-child"]:
        return trace_child(Path(argv[1]))
    LOG.unlink(missing_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, kernels
    from pf3plat_tpu_torch.parallel import MeshCfg, make_mesh

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build = kernels.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in build["ptxas"].items()}
    # B1's library holds two kernels: its registers are the one-pass kernel's
    regs = {k: ptxas_registers(v, "compact_kernel" if k == "compact_pairs" else "")
            for k, v in build["ptxas"].items()}
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, kernel_build_s=build["seconds"], ptxas=ptxas))
    emit(env_inventory())
    if "--main" in argv:
        # the training entry point alone: the train phase's launches per
        # step (one streamed step of record), main_train, trace
        _, launches, _, _ = train("streamed")
        main_train({k: n // 2 for k, n in launches.items()})
        torch.cuda.empty_cache()
        main_test(None)
        torch.cuda.empty_cache()
        trace_phase()
        print(smi, flush=True)
        return 0

    if "--attention-ablations" in argv:
        attention_ablations()
        print(smi, flush=True)
        return 0
    if "--bwd-ablations" in argv:
        bwd_ablations()
        print(smi, flush=True)
        return 0
    if "--fwd-ablations" in argv:
        fwd_ablations()
        print(smi, flush=True)
        return 0

    config = PRODUCTION_CONFIG
    shape = (256, 256)
    scene = bench_scene("cuda")
    screen = project(scene, shape, config)
    check_b1(screen, shape, config, "bench", regs)
    check_b2(screen, shape, scene["background"], config, "bench", regs)
    check_backward(screen, shape, scene["background"], config, "bench")
    check_tables(screen, shape, scene["background"], config, "bench", regs)
    check_b5(screen, shape, scene["background"], RasterizeConfig(), "bench")
    del screen
    b1_sweep()
    bwd_sweep()
    attn_pose = check_attention("pose", *ATTN_POSE_SHAPE)
    vit_shape = vit_attention_shape(model_config(), ATTN_POSE_SHAPE[0], shape)
    attn_vit = check_attention("vit", *vit_shape)
    check_attention("depth", *ATTN_DEPTH_SHAPE)
    serve_shapes = {(SERVE_VIEWS, *ATTN_POSE_SHAPE[1:]),
                    vit_attention_shape(model_config(), SERVE_VIEWS, shape)}
    for tag, attn_shape in zip(("pose_serve", "vit_serve"), sorted(serve_shapes)):
        check_attention(tag, *attn_shape, backward=False)
    sweep_attention()

    if "--kernels" in argv:
        return 0

    for impl in ("streamed", "pallas"):
        render_fwd_bwd(scene, config, impl)
    # a tile whose pixel count is no multiple of 32 (idle lanes in B2, B3,
    # B6 and B7)
    for impl in ("streamed", "pallas"):
        render_fwd_bwd(scene, dataclasses.replace(config, tile_size=12), impl, "tile12")
    mesh_render(scene, make_mesh(MeshCfg(data_axis=1, tile_axis=4), device="cuda"))
    del scene

    # Serving: the same request (same seeds, so the same gaussians) through
    # both decoders.
    captured, serve_launches, image = serve("streamed", timed_shapes=serve_shapes)
    serve_per_request = {k: n // 3 for k, n in serve_launches.items()}
    torch.cuda.empty_cache()
    scene = render_scene(captured)
    screen = project(scene, shape, config)
    b1 = check_b1(screen, shape, config, "serve", regs)
    check_b2(screen, shape, scene["background"], config, "serve", regs)
    reference_check(scene, config)
    check_tables(screen, shape, scene["background"], config, "serve", regs, backward=False)
    del scene, screen
    depth_phase(captured, config)
    del captured
    torch.cuda.empty_cache()
    perceive_precision()
    _, launches_p, image_p = serve("pallas")
    serve_launches.update({k: launches_p[k] for k in FWD_KERNELS["pallas"]})
    diff = (image - image_p).abs()
    overflowed = b1["written"] < b1["total"]
    emit(dict(phase="serve_backends", max_abs_diff=float(diff.max()),
              mean_abs_diff=float(diff.mean()), budget_overflowed=overflowed,
              gated=not overflowed, tol=TOL_BACKENDS))
    if not overflowed and not float(diff.max()) <= TOL_BACKENDS:
        raise AssertionError(f"serve: streamed vs pallas image differ by {float(diff.max())} "
                             f"> {TOL_BACKENDS} though the pair budget did not overflow")
    torch.cuda.empty_cache()

    # Training: each backend's steps, then every kernel on the streamed
    # warm-up step's own render inputs.
    _, launches_p, trace_p, _ = train("pallas")
    captured, launches, _, attn_shapes = train("streamed")
    # launches per step of the streamed path (train's 2 timed steps)
    train_per_step = {k: n // 2 for k, n in launches.items()}
    launches.update({k: launches_p[k] for k in TRAIN_KERNELS["pallas"]})
    # the attention kernels were timed at shapes the training step really uses
    if not {ATTN_POSE_SHAPE, ATTN_DEPTH_SHAPE, vit_shape} <= attn_shapes:
        raise AssertionError(f"train: attention shapes {sorted(attn_shapes)} lack "
                             f"{ATTN_POSE_SHAPE}, {ATTN_DEPTH_SHAPE} or {vit_shape}")
    # The tables hold every candidate, the production streamed budget drops
    # some with random weights; with the exact expansion (budget factor 0)
    # the streamed backend composites the same pairs as the tables, so the
    # two training paths must agree step by step.
    _, _, trace_s, _ = train("streamed", 1, raster=RasterizeConfig())
    worst = max(abs(a[k] - c[k]) / abs(c[k]) for a, c in zip(trace_p, trace_s)
                for k in ("loss", "grad_norm"))
    emit(dict(phase="train_backends", pallas=trace_p[:2], streamed_exact=trace_s,
              max_rel_diff=worst, tol=TOL_TRAIN_BACKENDS))
    if not worst <= TOL_TRAIN_BACKENDS:
        raise AssertionError(f"train: pallas vs streamed (exact expansion) loss / grad_norm "
                             f"differ by {worst} > {TOL_TRAIN_BACKENDS}")
    # The sharded step on a (data=2, tile=2) mesh of the one card: without
    # compaction (B2 and B5 once per shard) it must reproduce the unsharded
    # exact-expansion step; with the production config it takes the
    # shard-local pipeline (B1-B4 once per shard).
    mesh = make_mesh(MeshCfg(data_axis=2, tile_axis=2), device="cuda")
    _, launches_m, trace_m, _ = train("streamed", 1, raster=RasterizeConfig(), mesh=mesh)
    worst = max(abs(a[k] - c[k]) / abs(c[k]) for a, c in zip(trace_m, trace_s)
                for k in ("loss", "grad_norm"))
    # The unsharded step once more, for its own run-to-run spread beside the
    # gate (information: the encoder's backward is not bit-reproducible, and
    # Adam's first step turns that into gradient-norm differences).
    _, _, trace_s2, _ = train("streamed", 1, raster=RasterizeConfig())
    rerun = max(abs(a[k] - c[k]) / abs(c[k]) for a, c in zip(trace_s2, trace_s)
                for k in ("loss", "grad_norm"))
    emit(dict(phase="train_mesh_vs_unsharded", sharded=trace_m, unsharded=trace_s,
              max_rel_diff=worst, tol=TOL_TRAIN_MESH, unsharded_rerun=trace_s2,
              unsharded_rerun_max_rel_diff=rerun))
    if not worst <= TOL_TRAIN_MESH:
        raise AssertionError(f"train_mesh: sharded (B5 path) vs unsharded loss / grad_norm "
                             f"differ by {worst} > {TOL_TRAIN_MESH}")
    launches["composite_bwd_blocks"] = launches_m["composite_bwd_blocks"]
    train("streamed", 1, mesh=mesh)
    scene = render_scene(captured)
    screen = project(scene, shape, config)
    rows = {
        "compact_pairs": check_b1(screen, shape, config, "train", regs),
        "composite_fwd": check_b2(screen, shape, scene["background"], config, "train", regs),
    }
    rows["composite_bwd"], rows["dup_reduce"] = check_backward(
        screen, shape, scene["background"], config, "train")
    rows["table_fwd"], rows["table_bwd"] = check_tables(
        screen, shape, scene["background"], config, "train", regs)
    rows["composite_bwd_blocks"] = check_b5(screen, shape, scene["background"],
                                            RasterizeConfig(), "train")
    del scene, screen, captured
    torch.cuda.empty_cache()
    train_frozen()

    # The training entry point at full width, its resume, the serving entry
    # point restored from it, then the traced windows (main's loop, a
    # serving request) in a child process.
    main_per_step = main_train(train_per_step)
    torch.cuda.empty_cache()
    main_test_per_request = main_test(serve_per_request)
    torch.cuda.empty_cache()
    trace_phase()
    # the attention kernels at the pose-stack shape (forward and backward of
    # a training step); the ViT shape's rows are the attn_*_vit lines
    rows["attention_fwd"], rows["attention_bwd"] = attn_pose

    # launches: each backend's training path over its timed steps, B5 over
    # the sharded step (the forward kernels also ran on the serving path:
    # `launches_serve`); times at the training step's shapes
    line = []
    for name, (src, replaces) in KERNEL_META.items():
        r = rows[name]
        line.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches[name], launches_serve=serve_launches.get(name, 0),
                         launches_main_per_step=main_per_step[name],
                         launches_main_test_per_request=main_test_per_request[name],
                         max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"],
                         # the SFU's exponentials are operations of the card too
                         bound_by=r["bound_by"].replace("exponentials", "operations"),
                         library_ms=r["library_ms"]))
        if "exp_ms" in r:
            line[-1].update(bound_unit=r["bound_by"], exp_ms=r["exp_ms"],
                            ctas_per_sm=r["ctas_per_sm"])
    line[-2].update(ms_vit=attn_vit[0]["ms"], library_ms_vit=attn_vit[0]["library_ms"],
                    bound_ms_vit=attn_vit[0]["bound_ms"])
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        sys.exit(1)
