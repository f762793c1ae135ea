#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (pf3plat_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only (quick)
    python3 chip_smoke.py --main     # build, one training step of record,
                                     # then phases main_train and main_test
                                     # only
    python3 chip_smoke.py --procs    # build, then phase procs_mesh only
    python3 chip_smoke.py --memory   # build, then phase memory_policy only
    python3 chip_smoke.py --precision  # build, then phase precision only
    python3 chip_smoke.py --pose     # build, then phases pose_path and
                                     # index_pairs only
    python3 chip_smoke.py --adam     # build, then phase adam only

The port's declared precision policy (`precision.apply_policy`, as every
entry point sets it) holds for the whole run: the timing phases run under
it. Kernel gates, parity comparisons and gates whose two sides differ in
shape (sharded against unsharded) run under `precision.exact()`.

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  - GPU name and power limit (nvidia-smi), build of every
               kernel library (`pf3plat_tpu_torch/kernels.py`) with each
               one's registers and spills;
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
     adam_*  - the Adam kernels (csrc/adam.cu) at PF3plat's (`pf3plat`,
               re10k.yaml's encoder) and NoPoSplat's (`nopo`) trained leaves:
               one update through `Optimizer.apply` against `opt_update` and
               `p.add_` fed the kernel's norm, parameters and moments bit for
               bit, the norm within 1e-6 of the plain one and equal on two
               runs, host syncs an update; ms of the whole update, of each
               kernel, of the plain version and of torch.optim.Adam
               (fused=True) as yardstick, beside the bound (32 B an element);
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
     precision - the port's precision rules on the serving request and
               the training step of record: (a) every attention outside the
               flash rule at its shape (swin windows, the U-Nets' cross-view
               attention, pose and LightGlue blocks, CrossBlock),
               `library_attention` (bf16 SDPA) against its twin's
               arithmetic under exact(), forward and backward, ms of both
               (TOL_ATTN); (b) each product the JAX package pins to
               "highest" bit-equal to its exact() product under perception's
               autocast and the policy; a request with
               PF3PLAT_FLASH_ATTENTION=0 launches no attention kernel; (c)
               the b=3 step with TF32 on and off: loss, gradient norm, ms,
               one traced step each with the convolutions' device time; the
               declared TF32 must be what TOL_TF32_STEP decides; (d)
               perceive_precision: `PF3plat.perceive` in four modes (plain
               bf16 autocast = the parent tree's rule, the port's default
               with the decision heads at the JAX rule, float32 with
               bf16-rounded operands = the JAX rule, "highest"): ms, depth,
               feature and match differences from "highest", and the shares
               of keypoints, detection-valid and match-valid flags that
               agree with the JAX rule's and "highest"'s; the default no
               worse than plain autocast on keypoints; (e) two identical
               steps' spread with bf16 and with float32 SDPA, and the
               operations `torch.use_deterministic_algorithms` names in a
               step and a request;
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
               norm against the unsharded step: step 1 from the same
               parameters with its gradients, step 2 from the unsharded
               step 1's state; the unsharded step then runs once more, two
               steps in turn, for its own spread) and once with the production
               config (shard-local: B1-B4 four times a step); then b1..b7 on
               the warm-up step's own render inputs (9 cameras of 131,072
               gaussians);
     train_frozen - `make_train_step` (the step on precomputed frozen
               inputs from `perceive`) on the same batch: one timed step
               after a warm-up, B1-B4 once, loss and gradient norm equal to
               `make_model_train_step`'s from the same parameters and
               generator (1e-4 relative);
     pose_path - the pose path with real correspondences at full width
               (configs/re10k.yaml's model, 512 matches a pair, 128
               hypotheses, 256 x 256) on a scene of exact matches
               (tests/torch_pose_scene.py: a non-planar surface, cameras
               that turn and move; perception's depth and matches replaced
               by the scene's, its features its own; the pose head's last
               layer random), on the serving request (b=1, v=5, 10 pairs,
               through `PF3plat.forward`) and the train batch (b=3, v=3):
               (a) under exact(), each stage on the card against the port
               on the CPU from the card's own inputs: RANSAC's winning
               hypothesis equal and fits within TOL_POSE_STAGE (near-ties
               printed), sync and so3_project within TOL_POSE_STAGE,
               pose_loss and its gradients within TOL_POSE_LOSS, the
               evaluator's pose errors; (b) the encoder under the declared
               policy against exact(): poses within TOL_POSE_POLICY, each
               stage alone under the policy printed; (c) the coarse and
               synchronised poses' errors against the scene's truth, the
               card's no worse than the CPU's on the same points; (d)
               `make_train_step` with the pose term live: pose loss > 0,
               finite gradient norms, the pose term's own gradient norm, B1-B4
               once and attention as `attention_per_step` without the ViT,
               ms beside a zero-match step and train_frozen's; (e) host
               syncs of the serving encoder and of the pose loss under
               torch.cuda.set_sync_debug_mode("warn"), by line;
     memory_policy - the encoder's memory and precision knobs: (a) the
               train phase's step at b=3 under remat off, selective and
               coarse (a warm-up, then one timed step each: ms, stage split,
               peak bytes of the step and of each stage, loss and gradient
               norm within 1e-4 of remat off's (the two steps once more
               under exact() for this gate), selective's peak below
               off's, attention launches as derived from the code for each
               mode: 24 ViT forwards + 18 encoder forwards and backwards, and
               18 forwards more under remat); (b) the selective step at
               unet_dtype = costvolume_dtype = bfloat16 (ms, peak, loss
               within 2e-2 of the float32 step's), and one traced step of
               each with its heaviest device operations; (c) `main` on
               configs/re10k.yaml at its own batch of 14 (the default remat,
               2 steps over 28 synthetic training scenes in
               build/memory_data): ms, data_wait_ms, stage split, peak
               bytes, launches (B1-B4 once a step), and the bytes an example
               adds over (a)'s b=3;
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
               first on each root, then `index_pairs`: the CLI over the
               orbit chunks (cameras that turn, some view pairs overlapping
               inside [0.6, 0.8]) on the card and on the CPU, the two
               indexes equal. Gates: the restore line; 8 finite scores;
               benchmark.json's count 8 - 5; torch.cuda memory numbers;
               every artifact; request 0's PSNR equal to a direct forward on
               its batch and generator (1e-5 relative); launches per request
               = the serve phase's plus one B1 and one B2 for each extra
               render (depth, 2 x 5 video chunks). Per request: ms, launches;
               the benchmark median, peak bytes, the first batch's wait;
     procs_mesh - two ranks on the one card (`--procs-child`, gloo: NCCL
               refuses two ranks on one card): mesh_render's three cases on a
               (1, 2) world mesh, each rank running only its own shard
               (launches read around each render), image and gradients
               bit-equal to the one-process (1, 2) mesh render; then `main` on
               configs/re10k.yaml at full width, b=2 (one example a rank: a
               (2, 1) world mesh), 2 steps: both ranks' parameters bit-equal
               after each step, step 1's loss and gradient norm within 1e-4 of
               this process stepping on the ranks' two rows through the same
               mesh, one checkpoint and one log written (rank 0). Per rank:
               render ms, step ms, peak bytes, launches;
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
# unsharded step without compaction (the same pairs in the same chunks), and
# the step's gradients (Adam's first moment) relative to their largest: step
# 1 from the same initial parameters, step 2 from the unsharded step 1's
# state. Two steps in turn are not compared: Adam's first update is +-lr
# whatever the gradient's size, and the encoder's backward is not
# bit-reproducible, so two unsharded runs of two steps in turn differ by
# ~1e-4 in the second step's gradient norm (`--mesh-spread`).
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

    from pf3plat_tpu_torch import kernels

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

    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.ops.rasterizer import compact, streamed

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

    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.ops.rasterizer import streamed

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
    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.ops.rasterizer import pallas_impl

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
    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.ops.rasterizer import pallas_impl

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


MESH_DIFF = ("means", "covariances", "sh", "opacities", "background")


def mesh_render_cases():
    """mesh_render's three pipelines: (name, impl, config, the kernels it
    launches once per shard a process runs, kernels it must not launch)."""
    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig

    return (("streamed_blocks", "streamed", RasterizeConfig(),
             ("composite_fwd", "composite_bwd_blocks"), ("composite_bwd",)),
            ("streamed_shard_local", "streamed", PRODUCTION_CONFIG,
             ("compact_pairs", "composite_fwd", "composite_bwd", "dup_reduce"), ()),
            ("pallas", "pallas", PRODUCTION_CONFIG, ("table_fwd", "table_bwd"), ()))


def render_on_mesh(scene, impl, config, mesh):
    """The bench scene through `render(..., mesh=mesh)`, forward and
    backward of the mean squared error to a fixed target (numpy seed 1),
    with the launch counters zeroed just before and read just after ->
    (image, gradients of MESH_DIFF, launches)."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.ops.rasterizer import render

    tgt = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (2, 256, 256, 3)).astype(
        np.float32), device="cuda")
    leaves = {k: scene[k].clone().requires_grad_(k in MESH_DIFF) for k in scene}
    kernels.reset_launches()
    img = render(**leaves, far=leaves["near"] * 100, image_shape=(256, 256), impl=impl,
                 config=config, device="cuda", mesh=mesh)
    ((img - tgt) ** 2).mean().backward()
    torch.cuda.synchronize()
    return img.detach(), {k: leaves[k].grad for k in MESH_DIFF}, dict(kernels.LAUNCHES)


def mesh_render(scene, mesh):
    """The bench scene through `render(..., mesh=mesh)`, forward and
    backward, three ways, each against the same render without a mesh:
    `streamed` without compaction (B2 per shard, B5 + merge backward) and
    `pallas` (B6 / B7 per shard) at B3's tolerance, per field of the
    gradient relative to its largest value; `streamed` with the production
    config (shard-local pipeline) at TOL_SHARD_LOCAL_* where no shard's
    budget overflowed, else finiteness only, with written / total per shard
    reported."""
    from pf3plat_tpu_torch.ops.rasterizer import compact
    from pf3plat_tpu_torch.ops.rasterizer.shard_local import shard_pairs_budget

    diff = MESH_DIFF
    shape = (256, 256)
    cases = [(name, impl, config, {**{k: mesh.size for k in per_shard},
                                   **{k: 0 for k in never}})
             for name, impl, config, per_shard, never in mesh_render_cases()]
    for name, impl, config, want in cases:
        img, grads, launches = render_on_mesh(scene, impl, config, mesh)
        ref_img, ref_grads, _ = render_on_mesh(scene, impl, config, None)
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
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch import kernels

    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    model = PF3plat(model_config(impl, config="re10k_test.yaml"), device="cuda")
    build_s = time.perf_counter() - t0
    images, intr, near, far = serving_inputs()
    b, v, h, w = images.shape[:4]
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


def attention_per_step(cfg) -> dict:
    """Attention-kernel launches of one training step of the model `cfg`
    (`PF3platCfg`), counted from the model's code: the frozen ViT's `depth`
    self-attentions run forward only (perception takes no gradient); the
    encoder's SelfBlocks over 2048 tokens or more (`depth_self_attn_*` on the
    49 x 49 backbone grid, `pose_transformers_*` and `pose_self_attn_*` on
    64 x 64 tokens + 1) run forward and backward, n_attn_layers each; the
    CrossBlocks, the swin windows and the U-Nets' attention stay on SDPA.
    Under remat each of those SelfBlocks runs its forward once more in the
    backward."""
    trainable = 3 * cfg.encoder.n_attn_layers
    return {"attention_fwd": cfg.unidepth.vit.depth + trainable * (2 if cfg.encoder.remat else 1),
            "attention_bwd": trainable}


def train_batch():
    """The training batch of record from numpy seed SEED, on the card:
    b=3, 2 context views + 1 target spliced by the union trick (the target
    stack is the context stack), 256x256 (re10k.yaml)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    b, v, h, w = 3, 3, 256, 256
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32), device="cuda")
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, v, 3, 3)).astype(np.float32),
        device="cuda")
    return dict(context=dict(image=images, intrinsics=intr, near=torch.ones((b, v), device="cuda"),
                             far=torch.full((b, v), 100.0, device="cuda")),
                target=dict(image=images))


def snapshot(state, gen) -> dict:
    """A copy of a train state and of its generator's state, on the host (the
    next step updates the parameters in place; the copy stays out of the
    card's peak memory)."""
    host = lambda ts: [t.detach().to("cpu", copy=True) for t in ts]  # noqa: E731
    opt = state.opt_state
    return dict(params=host(state.params),
                opt_state=opt._replace(mu=host(opt.mu), nu=host(opt.nu)),
                step=state.step, gen=gen.get_state())


def restore(state, gen, snap: dict):
    """`state` at `snap`: its parameters copied in, the snapshot's moments
    and step; `gen` at the snapshot's generator state."""
    import torch

    from pf3plat_tpu_torch.training.train import TrainState

    if [p.shape for p in state.params] != [p.shape for p in snap["params"]]:
        raise AssertionError("restore: the snapshot is of other parameters")
    with torch.no_grad():
        for p, q in zip(state.params, snap["params"]):
            p.copy_(q)
    gen.set_state(snap["gen"])
    opt = snap["opt_state"]
    dev = lambda ts: [t.to(p.device) for t, p in zip(ts, state.params)]  # noqa: E731
    return TrainState(state.params, opt._replace(mu=dev(opt.mu), nu=dev(opt.nu)), snap["step"])


def first_moment_rel(a: dict, b: dict) -> float:
    """The largest difference of two snapshots' first moments (after one
    step: the clipped gradients times 1 - b1), relative to b's largest."""
    diff = max(float((x - y).abs().max()) for x, y in zip(a["opt_state"].mu, b["opt_state"].mu))
    return diff / max(float(y.abs().max()) for y in b["opt_state"].mu)


class StageTimer:
    """A train step's `timer` callback: a CUDA event at the end of each
    stage, and the peak device memory of each stage (the allocator's host
    accounting, its peak reset as each stage ends)."""

    STAGES = ("perceive", "encoder", "decoder", "loss", "backward", "optimizer")

    def __init__(self):
        self.events, self.peaks = {}, {}

    def _mark(self, stage):
        import torch

        self.events[stage] = torch.cuda.Event(enable_timing=True)
        self.events[stage].record()
        self.peaks[stage] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def start(self):
        self._mark("start")

    def __call__(self, stage):
        self._mark(stage)

    def stage_ms(self) -> dict:
        """{"<stage>_ms": ms} from the previous stage's end (or the start)."""
        out, prev = {}, "start"
        for stage in self.STAGES:
            if stage in self.events:
                out[f"{stage}_ms"] = self.events[prev].elapsed_time(self.events[stage])
                prev = stage
        return out

    def stage_peak_bytes(self) -> dict:
        return {k: v for k, v in self.peaks.items() if k != "start"}


def train(impl: str = "streamed", n_steps: int = 2, raster=None, mesh=None,
          shared: dict | None = None):
    """The training step of record on the card through
    `DecoderCfg(impl=impl)` (production rasterizer config unless `raster` is
    given; through `mesh` if given, phase `train_mesh`): a warm-up step (its
    render inputs are kept for the kernel checks), then `n_steps` timed
    steps -> (captured render inputs, launches, the warm-up's and the steps'
    losses and gradient norms, the attention shapes seen). With `shared`:
    the first call puts its state after the warm-up there (`step1`); a later
    call records its own warm-up's first moment against it
    (`first_moment_rel`) and takes the timed steps from that state."""
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch import kernels
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
    if mesh is None:  # a mesh runs the encoder once a data shard
        per_step_launches.update(attention_per_step(model.cfg))
    per_step_launches["adam"] = 2  # the norm pass and the update, once a step
    batch = train_batch()
    b, v, h, w = batch["context"]["image"].shape[:4]
    step_fn = make_model_train_step(model, LossCfg(), OptimizerCfg(), mesh=mesh)
    if mesh is not None:
        step_fn = shard_train_step(step_fn, mesh)
        batch = shard_batch(mesh, batch)
    state = init_train_state(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    with capture_decode() as captured, capture_attention() as attn_shapes:
        state, warm_aux = step_fn(state, batch, generator=gen)  # warm-up
    if shared is not None:
        if "step1" not in shared:
            shared["step1"] = snapshot(state, gen)
        else:
            shared["first_moment_rel"] = first_moment_rel(snapshot(state, gen), shared["step1"])
            state = restore(state, gen, shared["step1"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    per_step, peak = [], 0
    for _ in range(n_steps):
        timer = StageTimer()
        before = dict(kernels.LAUNCHES)
        wall0 = time.perf_counter()
        timer.start()
        state, aux = step_fn(state, batch, generator=gen, timer=timer)
        torch.cuda.synchronize()
        row = dict(total_ms=(time.perf_counter() - wall0) * 1e3)
        wrong = {k: kernels.LAUNCHES[k] - before[k] for k, want in per_step_launches.items()
                 if kernels.LAUNCHES[k] - before[k] != want}
        missing = [k for k in MODEL_TRAIN_KERNELS if kernels.LAUNCHES[k] == before[k]]
        if wrong or missing:
            raise AssertionError(f"train {impl}: launches in a step {wrong} (want "
                                 f"{per_step_launches}); not launched: {missing}")
        row.update(timer.stage_ms())
        row.update({k: float(x) for k, x in aux.items()})
        per_step.append(row)
        peak = max(peak, *timer.peaks.values())
    launches = dict(kernels.LAUNCHES)
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
    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.ops.rasterizer import render

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


def write_main_data(root: Path, scenes: int = 2, splits=("train", "test")) -> list[Path]:
    """Two dataset roots of synthetic RE10K-shaped scenes from numpy seed 0,
    one of `.pfchunk` files (the port's `write_pfchunk`) and one of `.torch`
    chunks, each with `splits` of 2 chunks x `scenes` scenes x 80 frames of
    360 x 640 JPEGs (quality 90): a smooth texture panned across the frames
    with camera rows to match (normalised fx 0.86, fy 1.53, the camera
    moving 0.02 a frame along x). The training scenes are drawn first (keys
    `<root>_<chunk>_<scene>`), then the test scenes (keys
    `test_<root>_<chunk>_<scene>`). With the test split, also the orbit
    root beside them (`write_orbit_data`), not among the returned roots."""
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
        if split not in splits:
            continue
        for kind, r in zip(("pfchunk", "torch"), roots):
            (r / split).mkdir(parents=True)
            for c in range(2):
                chunk = []
                for s in range(scenes):
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
                    chunk.append({"key": f"{prefix}{kind}_{c}_{s}", "cameras": cams,
                                  "images": frames})
                if kind == "pfchunk":
                    write_pfchunk(r / split / f"{c:06}.pfchunk", chunk)
                else:
                    torch.save([{"key": sc["key"], "cameras": torch.from_numpy(sc["cameras"]),
                                 "images": [torch.frombuffer(bytearray(b), dtype=torch.uint8)
                                            for b in sc["images"]]} for sc in chunk],
                               r / split / f"{c:06}.torch")
    if "test" in splits:
        write_orbit_data(root / "orbit")
    return roots


ORBIT_DATA = MAIN_DATA / "orbit"
# degrees the orbit scenes' camera turns a frame (about y)
ORBIT_YAW_DEG = 0.5
INDEX_PAIRS = REPO / "build" / "index_pairs"


def write_orbit_data(root: Path) -> Path:
    """A dataset root of test chunks for the index generator's pair search:
    `.pfchunk` files, 2 chunks x 2 scenes x 80 frames of small JPEGs, from
    numpy seed SEED, the camera turning ~ORBIT_YAW_DEG a frame about y while
    it moves 0.02 a frame along x (main_data's intrinsics, a ~60 degree
    field of view). Views 40 or more frames apart then overlap inside the
    generator's [0.6, 0.8]; main_data's chunks, which only translate, keep
    every overlap >= 0.875."""
    import io
    import shutil

    import numpy as np
    from PIL import Image

    from pf3plat_tpu_torch.native import write_pfchunk

    shutil.rmtree(root, ignore_errors=True)
    (root / "test").mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    buf = io.BytesIO()
    Image.fromarray(rng.uniform(0, 255, (36, 64, 3)).astype(np.uint8)).save(buf, format="JPEG")
    for c in range(2):
        chunk = []
        for s in range(2):
            yaw = np.deg2rad(ORBIT_YAW_DEG * rng.uniform(0.8, 1.2))
            cams = np.zeros((MAIN_FRAMES, 18), np.float32)
            cams[:, :4] = [0.86, 1.53, 0.5, 0.5]
            for f in range(MAIN_FRAMES):
                c2w = np.eye(4)
                a = yaw * f
                c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
                c2w[0, 3] = 0.02 * f
                cams[f, 6:] = np.linalg.inv(c2w)[:3].reshape(-1)
            chunk.append({"key": f"orbit_{c}_{s}", "cameras": cams,
                          "images": [buf.getvalue()] * MAIN_FRAMES})
        write_pfchunk(root / "test" / f"{c:06}.pfchunk", chunk)
    return root


def index_pairs() -> dict:
    """The index generator's CLI (`evaluation/index_generator.py`) over the
    orbit chunks on the card and with device="cpu": the two JSON files must
    be equal, and some scene must find a pair inside [0.6, 0.8]
    (tests/test_torch_eval.py holds the CPU run against JAX)."""
    from pf3plat_tpu_torch.evaluation import index_generator

    if not (ORBIT_DATA / "test").is_dir():
        write_orbit_data(ORBIT_DATA)
    INDEX_PAIRS.mkdir(parents=True, exist_ok=True)
    got, secs = {}, {}
    for dev in ("cuda", "cpu"):
        path = INDEX_PAIRS / f"index_{dev}.json"
        t0 = time.perf_counter()
        index_generator.main([str(ORBIT_DATA), "--out", str(path)],
                             device=None if dev == "cuda" else "cpu")
        secs[dev] = time.perf_counter() - t0
        got[dev] = json.loads(path.read_text())
    valid = {k: x for k, x in got["cuda"].items() if x is not None}
    overlaps = sorted(x["overlap"] for x in valid.values())
    emit(dict(phase="index_pairs", scenes=len(got["cuda"]), valid=len(valid), overlaps=overlaps,
              card_equals_cpu=got["cuda"] == got["cpu"], s=secs,
              cpu_differs={k: [got["cuda"][k], got["cpu"][k]] for k in got["cuda"]
                           if got["cuda"][k] != got["cpu"].get(k)}))
    if got["cuda"] != got["cpu"]:
        raise AssertionError("index_pairs: the card's index differs from the CPU's")
    if not valid or not all(0.6 <= x <= 0.8 for x in overlaps):
        raise AssertionError(f"index_pairs: overlaps {overlaps} (want some, inside [0.6, 0.8])")
    return got["cuda"]


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
def instrument_main(on_call=None, after_call=None):
    """Record what `main` does inside the block: each train-step call
    (launches of every kernel, host ms, the stage split by CUDA events, peak
    memory and the loss) and each wait for the next
    batch (`data_wait_ms`). `on_call(index, model, state, batch, kwargs)`
    runs before a step, `after_call(index)` after it. Patches
    `training.train.make_model_train_step` and `main.batch_iterator`, which
    `main.run_train` looks up when it runs."""
    import torch

    import pf3plat_tpu_torch.main as port_main
    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.training import train as train_mod

    rec = {"steps": [], "data_wait_ms": []}
    make_step, batch_iterator = train_mod.make_model_train_step, port_main.batch_iterator

    def recording_make_step(model, *args, **kwargs):
        step = make_step(model, *args, **kwargs)

        def instrumented(state, batch, **kw):
            index = len(rec["steps"])
            if on_call is not None:
                on_call(index, model, state, batch, kw)
            before = dict(kernels.LAUNCHES)
            timer = StageTimer()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wall0 = time.perf_counter()
            timer.start()
            state, aux = step(state, batch, timer=timer, **kw)
            torch.cuda.synchronize()
            row = dict(step=state.step, ms=(time.perf_counter() - wall0) * 1e3,
                       batch=int(batch["context"]["image"].shape[0]),
                       views=int(batch["context"]["image"].shape[1]),
                       launches={k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES},
                       max_memory_allocated_bytes=max(timer.peaks.values()),
                       stage_peak_bytes=timer.stage_peak_bytes())
            row.update(timer.stage_ms())
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
    from pf3plat_tpu_torch import kernels

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
    from pf3plat_tpu_torch import kernels
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
    # the generator's pair search where overlaps fall inside its range
    index_pairs()
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


# The Adam kernels' norm against the plain one's (float32 sums taken in
# another order), relative.
TOL_ADAM_NORM = 1e-6


def adam_leaves(which: str) -> list:
    """The trained parameters of PF3plat (`configs/re10k.yaml`'s model) or
    of NoPoSplat at its published widths, on the card."""
    import torch

    torch.manual_seed(SEED)
    if which == "pf3plat":
        from pf3plat_tpu_torch.models.pf3plat import PF3plat

        return list(PF3plat(model_config(), device="cuda").trainable_parameters())
    from pf3plat_tpu_torch.models.noposplat import NoPoSplat, NoPoSplatCfg

    return NoPoSplat(NoPoSplatCfg(), device="cuda").trainable_parameters()


def check_adam(which: str) -> dict:
    """One update of `which`'s leaves through the Adam kernels against the
    plain version fed the kernel's norm (bit for bit), then the times."""
    import torch

    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.training import train

    params = [p.detach() for p in adam_leaves(which)]
    elements = sum(p.numel() for p in params)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(p.shape, device="cuda", generator=gen) for p in params]
    opt = train.make_optimizer(train.OptimizerCfg())
    state = opt.init(params)
    ref = [p.clone() for p in params]
    plan = train._AdamPlan(params, state.mu, state.nu)
    plan.set_grads(params, grads)
    norms = [train.adam_norm_cuda(plan) for _ in range(2)]
    plain_norm = float(train.global_norm(grads))
    norm_rel = abs(float(norms[0][2]) - plain_norm) / plain_norm
    norm_repeats = torch.equal(norms[0].view(torch.int32), norms[1].view(torch.int32))
    state, norm = opt.apply(params, grads, state)
    plain_state = opt.init(ref)
    global_norm = train.global_norm
    train.global_norm = lambda _: norm
    try:
        updates, plain_state = train.opt_update(opt.cfg, opt.schedule, grads, plain_state)
    finally:
        train.global_norm = global_norm
    for p, u in zip(ref, updates):
        p.add_(u)
    del updates
    differ = {name: sum(not torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, want))
              for name, got, want in (("params", params, ref), ("mu", state.mu, plain_state.mu),
                                      ("nu", state.nu, plain_state.nu))}
    del ref, plain_state
    if any(differ.values()) or not norm_repeats or not norm_rel <= TOL_ADAM_NORM:
        raise AssertionError(f"adam {which}: leaves differing from the plain version "
                             f"{differ}; norm {float(norm)} against {plain_norm} "
                             f"({norm_rel} > {TOL_ADAM_NORM}?), two runs equal: {norm_repeats}")
    # the port's own syncs (torch's first warning of the debug mode has none)
    syncs = {k: n for k, n in count_syncs(lambda: opt.apply(params, grads, state)).items()
             if k.startswith("pf3plat_tpu_torch/")}
    before = kernels.LAUNCHES["adam"]
    opt.apply(params, grads, state)
    launches = kernels.LAUNCHES["adam"] - before
    ms = cuda_ms(lambda: opt.apply(params, grads, state), 10)
    norm_ms = cuda_ms(lambda: train.adam_norm_cuda(plan), 10)
    step = train.adam_step(opt.cfg, opt.schedule, state, float(norms[0][0]), False)[0]
    update_ms = cuda_ms(lambda: train.adam_update_cuda(plan, step, opt.cfg), 10)

    def plain():
        g = train.global_norm(grads)  # the second norm _finish_step took
        updates, _ = opt.update(grads, state)
        for p, u in zip(params, updates):
            p.add_(u)
        return g

    plain_ms = cuda_ms(plain, 2, warmup=1)
    lib = [p.clone().requires_grad_() for p in params]
    for p, g in zip(lib, grads):
        p.grad = g
    library = torch.optim.Adam(lib, lr=1e-4, fused=True)
    library_ms = cuda_ms(library.step, 10)
    del lib, library
    bound_ms = elements * 32 / peaks()["bw"] * 1e3
    row = dict(phase=f"adam_{which}", leaves=len(params), elements=elements,
               leaves_without_alignment=sum(p.data_ptr() % 16 != 0 for p in params),
               items=plan.n_items, bit_equal_to_plain=True, norm_rel_diff=norm_rel,
               norm_two_runs_bit_equal=norm_repeats, launches_per_update=launches,
               host_syncs_per_update=sum(syncs.values()), host_syncs=syncs, ms=ms,
               norm_ms=norm_ms, update_ms=update_ms, bound_ms=bound_ms, bound_by="bytes",
               roofline_pct=100 * bound_ms / ms, update_roofline_pct=(
                   100 * elements * 28 / peaks()["bw"] * 1e3 / update_ms),
               norm_roofline_pct=100 * elements * 4 / peaks()["bw"] * 1e3 / norm_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library="torch.optim.Adam(fused=True), a yardstick the port never calls")
    emit(row)
    del params, grads, state, plan
    torch.cuda.empty_cache()
    return row


def adam_phase() -> dict:
    return {which: check_adam(which) for which in ("pf3plat", "nopo")}


def train_frozen() -> float:
    """`make_train_step` (the step on precomputed frozen inputs) at full
    width: the training step of record's batch (b=3, v=3, 256 x 256,
    configs/re10k.yaml's model, random weights from the seed), frozen inputs
    from `model.perceive`; a warm-up step, then one timed step from the
    initial parameters, whose loss and gradient norm must equal
    `make_model_train_step`'s step from the same parameters, batch and
    generator to TOL_TRAIN_FROZEN. B1-B4 launch once in the step. Returns
    the step's ms (random weights keep no match: the pose term is 0)."""
    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch import kernels
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
    return ms


# Phase pose_path: the encoder's pose path on a scene with exact matches
# (tests/torch_pose_scene.py), in place of LightGlue's matches, of which
# random weights keep none.
POSE_SCENE = REPO / "tests" / "torch_pose_scene.py"
POSE_IMAGE = (256, 256)
POSE_TRACES = REPO / "build" / "traces" / "pose_path"
# The card against the port on the CPU under exact(), on the card's own
# inputs to each stage: the RANSAC fits' rotations and translations, the
# synchronised poses and so3_project, absolute.
TOL_POSE_STAGE = 1e-4
# pose_loss's value (relative) and its gradients with respect to the refined
# poses, the points and the depths (relative to each one's largest entry).
TOL_POSE_LOSS = 1e-4
# The card's poses under the declared policy against exact() on the card:
# the CPU tests' pose tolerance (tests/test_torch_model.py).
TOL_POSE_POLICY = 2e-3
# The card's recovery of the scene's motion (rotation and translation
# direction, degrees) may exceed the CPU's on the same inputs by this much.
TOL_POSE_RECOVERY_DEG = 1e-2
# The evaluator's pose errors (degrees) of the card against the CPU on the
# same refined poses.
TOL_POSE_EVAL_DEG = 1e-2
# Inlier sums of the two best hypotheses this close (relative) are printed
# as a near-tie: there the argmax may follow the summation order.
POSE_NEAR_TIE = 1e-4
# std of the random weights in the pose head's zero-initialised last layer
# (as tests/test_torch_pose_path.py): the refinement moves the poses.
POSE_HEAD_STD = 1e-2


def load_pose_scene():
    """The shared scene module, tests/torch_pose_scene.py (numpy only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_pose_scene", POSE_SCENE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pose_inputs(model, b: int, v: int, seed: int):
    """The scene of b rows of v views at POSE_IMAGE with the model's 512
    matches a pair, on the card: (numpy scene, (images, intrinsics, near,
    far), FrozenInputs with the scene's depth and the features perception
    computes from its images, Correspondences, RANSAC noise drawn with numpy
    from `seed`)."""
    import torch

    from pf3plat_tpu_torch.models.encoder import Correspondences, FrozenInputs

    cfg = model.cfg
    scene = load_pose_scene().pose_scene(b, v, *POSE_IMAGE, cfg.max_matches, seed=seed,
                                         ransac_samples=cfg.encoder.ransac_samples)

    def cuda(k):
        return torch.as_tensor(scene[k], device="cuda")

    inputs = tuple(cuda(k) for k in ("images", "intrinsics", "near", "far"))
    perceived, _ = model.perceive(*inputs[:2])
    frozen = FrozenInputs(cuda("depth"), perceived.features)
    corr = Correspondences(*(cuda(k) for k in ("kpts0", "kpts1", "scores", "valid")))
    return scene, inputs, frozen, corr, cuda("ransac_noise")


def to_cpu(enc):
    """An EncoderOutput's pose-path fields on the CPU (no gaussians)."""
    from pf3plat_tpu_torch.models.encoder import Correspondences

    fields = ("pairwise_poses", "sync_poses", "refined_poses", "depths", "xyz",
              "pair_confidences")
    return enc._replace(gaussians=None, correspondences=Correspondences(
        *(x.detach().cpu() for x in enc.correspondences)),
        **{f: getattr(enc, f).detach().cpu() for f in fields})


def max_diff(a, b) -> float:
    return float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())


def pose_stages(tag: str, model, scene, inputs, frozen, corr, noise):
    """(a) The pose stages on the card against the port on the CPU under
    exact(), each on the card's own inputs: per pair the RANSAC inputs,
    inlier sums (winning hypothesis, near-ties) and fit; the sync and
    so3_project; pose_loss and its gradients; the evaluator's pose errors.
    Returns (the report, the encoder's output under exact(), the card's
    pose-loss gradients, the failed gates)."""
    import torch

    from pf3plat_tpu_torch.geometry import camera_sync, procrustes
    from pf3plat_tpu_torch.geometry.transforms import make_rt, so3_project
    from pf3plat_tpu_torch.models import encoder as E
    from pf3plat_tpu_torch.precision import exact
    from pf3plat_tpu_torch.training.losses import pose_loss
    from pf3plat_tpu_torch.training.metrics import pose_errors

    cfg = model.cfg.encoder
    v = inputs[0].shape[1]
    pair_i, pair_j = E.view_pairs(v)
    failed = []
    cpu = lambda x: x.detach().cpu()  # noqa: E731
    with exact(), torch.no_grad():
        enc = model.encoder(*inputs, frozen, corr, 0, ransac_noise=noise)
        pairs = []
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            card_in = E.ransac_inputs(cfg, enc.xyz, corr, p, i, j)
            cpu_in = [cpu(x) for x in card_in]
            sums = {}
            fits = {}
            for side, (x_i, x_j, wts, thr), nz in (("card", card_in, noise[:, p]),
                                                   ("cpu", cpu_in, cpu(noise[:, p]))):
                sums[side] = cpu(procrustes.ransac_inliers(x_i, x_j, wts, nz,
                                                           threshold=thr).sum(-1))
                fits[side] = procrustes.align_ransac(x_i, x_j, wts, nz, threshold=thr)
            top2 = torch.topk(sums["cpu"], 2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]) / top2[:, 0]
            row = dict(pair=[i, j], best_card=sums["card"].argmax(-1).tolist(),
                       best_cpu=sums["cpu"].argmax(-1).tolist(),
                       thr_diff=max_diff(card_in[3], cpu_in[3]),
                       inlier_sum_diff=max_diff(sums["card"], sums["cpu"]),
                       r_diff=max_diff(fits["card"].r, fits["cpu"].r),
                       t_diff=max_diff(fits["card"].t, fits["cpu"].t),
                       encoder_diff=max_diff(make_rt(fits["card"].r, fits["card"].t),
                                             enc.pairwise_poses[:, p]),
                       best_gap=gap.tolist())
            if (gap < POSE_NEAR_TIE).any():
                row["near_tie"] = True
            pairs.append(row)
            if row["best_card"] != row["best_cpu"]:
                failed.append(f"{tag} pair {(i, j)}: winning hypothesis {row['best_card']} on "
                              f"the card, {row['best_cpu']} on the CPU")
            if max(row["r_diff"], row["t_diff"]) > TOL_POSE_STAGE:
                failed.append(f"{tag} pair {(i, j)}: fit R {row['r_diff']} t {row['t_diff']} "
                              f"> {TOL_POSE_STAGE}")

        sync = {side: E.synchronize_poses(*rc, v) for side, rc in (
            ("card", (enc.pairwise_poses, enc.pair_confidences)),
            ("cpu", (cpu(enc.pairwise_poses), cpu(enc.pair_confidences))))}
        raw = camera_sync.camera_synchronization(enc.pairwise_poses, enc.pair_confidences,
                                                 pair_i, pair_j, v, so3_projection=False)
        so3 = {"card": so3_project(raw[..., :3, :3]), "cpu": so3_project(cpu(raw[..., :3, :3]))}
        stages = dict(sync_diff=max_diff(sync["card"], sync["cpu"]),
                      sync_encoder_diff=max_diff(sync["card"], enc.sync_poses),
                      so3_diff=max_diff(so3["card"], so3["cpu"]),
                      so3_det_min=float(torch.linalg.det(so3["card"]).min()))
        for k in ("sync_diff", "so3_diff"):
            if stages[k] > TOL_POSE_STAGE:
                failed.append(f"{tag}: {k} {stages[k]} > {TOL_POSE_STAGE}")

        # the evaluator's pose errors (first-to-last pair) on the refined poses
        truth = torch.as_tensor(scene["c2w"])
        ev = {"card": pose_errors(torch.linalg.inv(enc.refined_poses), truth.cuda()),
              "cpu": pose_errors(torch.linalg.inv(cpu(enc.refined_poses)), truth)}
        stages["evaluator"] = {side: {k: cpu(x).tolist() for k, x in e.items()}
                               for side, e in ev.items()}
        ev_diff = max(max_diff(ev["card"][k], ev["cpu"][k])
                      for k in ("rot_deg", "trans_angle_deg"))
        stages["evaluator_deg_diff"] = ev_diff
        if ev_diff > TOL_POSE_EVAL_DEG:
            failed.append(f"{tag}: evaluator pose errors differ by {ev_diff} degrees")

    with exact():
        v_card, g_card = pose_loss_grads(pose_loss, enc, inputs[1])
        v_cpu, g_cpu = pose_loss_grads(pose_loss, to_cpu(enc), cpu(inputs[1]))
        loss = dict(value_card=float(v_card), value_cpu=float(v_cpu),
                    value_rel_diff=abs(float(v_card) - float(v_cpu)) / abs(float(v_cpu)))
        for name, gc, gp in zip(("refined_poses", "xyz", "depths"), g_card, g_cpu):
            loss[f"grad_{name}_rel_diff"] = max_diff(gc, gp) / float(gp.abs().max())
            loss[f"grad_{name}_max"] = float(gp.abs().max())
    for k, x in loss.items():
        if k.endswith("rel_diff") and not x <= TOL_POSE_LOSS:
            failed.append(f"{tag}: pose_loss {k} {x} > {TOL_POSE_LOSS}")
    if not (loss["value_card"] > 0 and math.isfinite(loss["value_card"])):
        failed.append(f"{tag}: pose_loss {loss['value_card']} is not positive and finite")
    return dict(ransac=pairs, **stages, pose_loss=loss), enc, g_card, failed


def pose_loss_grads(loss_fn, enc, intrinsics):
    """`loss_fn` (`pose_loss` or its body) on `enc` and its gradients with
    respect to the refined poses, the points and the depths."""
    import torch

    from pf3plat_tpu_torch.training.losses import LossCfg

    leaves = [x.detach().clone().requires_grad_(True)
              for x in (enc.refined_poses, enc.xyz, enc.depths)]
    value = loss_fn(enc._replace(refined_poses=leaves[0], xyz=leaves[1], depths=leaves[2]),
                    intrinsics, LossCfg())
    return value.detach(), torch.autograd.grad(value, leaves)


@contextlib.contextmanager
def without_exact(*modules, enabled: bool = True):
    """Inside, each of `modules` finds `contextlib.nullcontext` under its
    name `exact`: its exact() scopes are gone, as the pose path ran before
    they were added."""
    saved = [m.exact for m in modules]
    try:
        if enabled:
            for m in modules:
                m.exact = contextlib.nullcontext
        yield
    finally:
        for m, x in zip(modules, saved):
            m.exact = x


def count_syncs(fn) -> dict:
    """{"file:line": host syncs} of `fn()` under
    torch.cuda.set_sync_debug_mode("warn"): each warning is put on the
    innermost frame of the port's package in its stack."""
    import traceback
    import warnings

    import torch

    counts: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack() if "pf3plat_tpu_torch" in f.filename]
        where = (f"{Path(frames[-1].filename).relative_to(REPO)}:{frames[-1].lineno}"
                 if frames else f"{filename}:{lineno}")
        counts[where] = counts.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def pose_path(zero_match_step_ms: float | None = None) -> None:
    """Phase pose_path: the pose path (RANSAC, camera sync, the refinement,
    the pose loss) on the card with real correspondences, at full width
    (configs/re10k.yaml's model, 512 matches a pair, 128 hypotheses, 256 x
    256), on the serving request (b=1, v=5, 10 pairs) and the train step's
    batch (b=3, v=3). Perception's depth and matches are the scene's
    (tests/torch_pose_scene.py), its features perception's own; the pose
    head's last layer random (POSE_HEAD_STD). (a) pose_stages on both
    inputs; (b) the encoder under the declared policy against exact(), and
    the sync's squarings alone under the policy; (c) the coarse and
    synchronised poses' errors against the scene's truth, card against the
    CPU on the same points; (d) `make_train_step` with the pose term live:
    pose loss, gradient norm, the pose loss's own gradient norm, launches,
    ms beside a zero-match step (and train_frozen's step if given); (e) the
    host syncs of the serving encoder and of the pose loss. Fails after
    printing everything when a gate failed."""
    import shutil

    import numpy as np
    import torch

    from pf3plat_tpu_torch.models import encoder as E
    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.precision import exact
    from pf3plat_tpu_torch.training import losses, metrics
    from pf3plat_tpu_torch.utils import profiling
    from pf3plat_tpu_torch.training.losses import LossCfg, pose_loss
    from pf3plat_tpu_torch.training.train import (
        OptimizerCfg, TrainState, make_optimizer, make_train_step)

    ps = load_pose_scene()
    torch.manual_seed(SEED)
    model = PF3plat(model_config(), device="cuda")
    ps.live_pose_head(model.encoder, SEED, POSE_HEAD_STD)
    cfg = model.cfg.encoder
    failed = []
    report = {}
    encs = {}
    for tag, (b, v) in (("serve", (1, SERVE_VIEWS)), ("train", (3, 3))):
        scene, inputs, frozen, corr, noise = pose_inputs(model, b, v, SEED)
        row, enc_exact, grads_exact, bad = pose_stages(tag, model, scene, inputs, frozen,
                                                       corr, noise)
        truth_c2w = torch.as_tensor(scene["c2w"], device="cuda")
        failed += bad
        row["matches_valid_per_pair"] = corr.valid.sum(-1).min().item()
        if row["matches_valid_per_pair"] == 0:
            failed.append(f"{tag}: a pair without valid matches")

        # (b) the declared policy against exact(), on the card; the serving
        # input through the entry point (PF3plat.forward, perception
        # replaced by the scene's)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            if tag == "serve":
                model.perceive = lambda images, intr: (frozen, corr)
                try:
                    enc, out = model(*inputs, 0, ransac_noise=noise)
                finally:
                    del model.perceive
            else:
                enc = model.encoder(*inputs, frozen, corr, 0, ransac_noise=noise)
        torch.cuda.synchronize()
        policy = dict(ms=(time.perf_counter() - t0) * 1e3, launches=dict(kernels.LAUNCHES))
        want = FWD_KERNELS["streamed"] + MODEL_FWD_KERNELS if tag == "serve" else ()
        if any(policy["launches"][k] < 1 for k in want):
            failed.append(f"{tag}: the request launched {policy['launches']}")
        if tag == "serve" and not bool(torch.isfinite(out.color).all()):
            failed.append("serve: non-finite colours")
        for f in ("pairwise_poses", "sync_poses", "refined_poses"):
            policy[f"{f}_diff"] = max_diff(getattr(enc, f), getattr(enc_exact, f))
            if policy[f"{f}_diff"] > TOL_POSE_POLICY:
                failed.append(f"{tag}: {f} under the policy {policy[f + '_diff']} from "
                              f"exact() > {TOL_POSE_POLICY}")
        policy["xyz_rel_diff"] = max_diff(enc.xyz, enc_exact.xyz) / float(enc_exact.xyz.abs().max())
        # each stage alone under the policy, from the exact run's inputs,
        # with its exact() scope and without it
        for scoped in (True, False):
            key = "" if scoped else "_without_exact"
            with torch.no_grad(), without_exact(E, metrics, enabled=not scoped):
                rel_p, _ = E.coarse_poses(cfg, enc_exact.xyz, corr, noise)
                policy["coarse_alone_diff" + key] = max_diff(rel_p, enc_exact.pairwise_poses)
                policy["sync_alone_diff" + key] = max_diff(
                    E.synchronize_poses(enc_exact.pairwise_poses, enc_exact.pair_confidences,
                                        v), enc_exact.sync_poses)
                ev = metrics.pose_errors(torch.linalg.inv(enc_exact.refined_poses), truth_c2w)
                policy["evaluator_deg_diff" + key] = max(
                    max_diff(ev[k], torch.as_tensor(row["evaluator"]["card"][k]))
                    for k in ("rot_deg", "trans_angle_deg"))
            loss_fn = losses.pose_loss if scoped else losses._pose_loss
            value, grads = pose_loss_grads(loss_fn, enc_exact, inputs[1])
            policy["pose_loss_rel_diff" + key] = abs(
                float(value) - row["pose_loss"]["value_card"]) / row["pose_loss"]["value_card"]
            policy["pose_loss_grad_rel_diff" + key] = max(
                max_diff(g, ref) / float(ref.abs().max()) for g, ref in zip(grads, grads_exact))
        for k, tol in (("evaluator_deg_diff", TOL_POSE_EVAL_DEG),
                       ("pose_loss_rel_diff", TOL_POSE_LOSS),
                       ("pose_loss_grad_rel_diff", TOL_POSE_LOSS)):
            if not policy[k] <= tol:
                failed.append(f"{tag}: {k} under the policy {policy[k]} > {tol}")
        row["policy"] = policy

        # (c) recovery of the scene's motion: the card's (policy) coarse and
        # synchronised poses against the CPU's from the same points
        with exact(), torch.no_grad():
            rel_cpu, conf_cpu = E.coarse_poses(cfg, enc.xyz.cpu(), to_cpu(enc).correspondences,
                                               noise.cpu())
            sync_cpu = E.synchronize_poses(rel_cpu, conf_cpu, v)
        truth = {"pairwise_poses": scene["rel"], "sync_poses": np.linalg.inv(scene["c2w"]),
                 "refined_poses": np.linalg.inv(scene["c2w"])}
        recovery = {}
        for f, cpu_poses in (("pairwise_poses", rel_cpu), ("sync_poses", sync_cpu),
                             ("refined_poses", None)):
            card = ps.pose_errors(getattr(enc, f).cpu().numpy(), truth[f])
            recovery[f] = dict(card=card)
            if cpu_poses is None:  # information: the random pose head moves it
                continue
            recovery[f]["cpu"] = ps.pose_errors(cpu_poses.numpy(), truth[f])
            worse = {k: card[k] - recovery[f]["cpu"][k] for k in card}
            if max(worse.values()) > TOL_POSE_RECOVERY_DEG:
                failed.append(f"{tag}: {f} recover the motion worse on the card: {worse}")
        row["recovery"] = recovery
        encs[tag] = (scene, inputs, frozen, corr, noise)
        emit(dict(phase="pose_path", part=f"{tag} (a) stages, (b) policy, (c) recovery",
                  batch=[b, v, *POSE_IMAGE], matches=model.cfg.max_matches,
                  hypotheses=cfg.ransac_samples, **row))
        report[tag] = row

    # (d) make_train_step with the pose term live on the train input
    scene, inputs, frozen, corr, noise = encs["train"]
    images, intr, near, far = inputs
    b, v, h, w = images.shape[:4]
    params = list(model.encoder.parameters())
    initial = [p.detach().clone() for p in params]
    opt = make_optimizer(OptimizerCfg())

    def fresh() -> TrainState:
        with torch.no_grad():
            for p, x in zip(params, initial):
                p.copy_(x)
        return TrainState(params, opt.init(params), 0)

    def batch(c):
        return dict(context=dict(image=images, intrinsics=intr, near=near, far=far),
                    target=dict(image=images), frozen=frozen, corr=c)

    no_match = corr._replace(valid=torch.zeros_like(corr.valid))
    want = {k: 1 for k in TRAIN_KERNELS["streamed"]}
    attention = attention_per_step(model.cfg)
    attention["attention_fwd"] -= model.cfg.unidepth.vit.depth  # no perception in the step
    want.update(attention)
    variants = {"pose_live": (LossCfg(), corr),
                "pose_only": (LossCfg(mse_weight=0.0, ssim_weight=0.0, lpips_weight=0.0), corr),
                "zero_match": (LossCfg(), no_match)}
    step_fns = {name: make_train_step(model.encoder, model.cfg.decoder, loss_cfg, opt, (h, w),
                                      lpips_apply=model.lpips_apply)
                for name, (loss_cfg, _) in variants.items()}
    step_fns["pose_live"](fresh(), batch(corr), ransac_noise=noise)  # warm-up
    steps = {}
    # in turns, each from the same parameters: the step's spread shows
    for name in ("pose_live", "zero_match", "pose_only", "pose_live", "zero_match"):
        state = fresh()
        timer = StageTimer()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        timer.start()
        _, aux = step_fns[name](state, batch(variants[name][1]), ransac_noise=noise,
                                timer=timer)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        if name in steps:
            steps[name]["ms"].append(ms)
            steps[name]["stages"].append(timer.stage_ms())
            continue
        steps[name] = dict(ms=[ms], stages=[timer.stage_ms()], launches=launches,
                           **{k: float(x) for k, x in aux.items()})
        wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
        if wrong:
            failed.append(f"train step {name}: launches {wrong}, want {want}")
    live = steps["pose_live"]
    if not (live["pose"] > 0 and math.isfinite(live["pose"])):
        failed.append(f"train step: pose loss {live['pose']} is not positive and finite")
    if not all(math.isfinite(s["grad_norm"]) for s in steps.values()):
        failed.append("train step: a non-finite gradient norm")
    if steps["zero_match"]["pose"] != 0.0:
        failed.append(f"zero-match step: pose loss {steps['zero_match']['pose']}")
    # one traced step of each: where the live pose term's time goes
    traced, ops = {}, {}
    for name in ("pose_live", "zero_match"):
        trace_dir = POSE_TRACES / name
        shutil.rmtree(trace_dir, ignore_errors=True)
        state = fresh()
        with profiling.trace(trace_dir, f"pose_{name}"):
            step_fns[name](state, batch(variants[name][1]), ransac_noise=noise)
        traced[name] = trace_window(trace_dir, f"pose_{name}")
        ops[name] = {(r["launched_by"], r["name"][:80]): r
                     for r in profiling.device_op_breakdown(trace_dir, window=f"pose_{name}")}
    keys = set(ops["pose_live"]) | set(ops["zero_match"])

    def device_ms(name, key):
        return ops[name][key]["total_us"] / 1e3 if key in ops[name] else 0.0

    def device_count(name, key):
        return ops[name][key]["count"] if key in ops[name] else 0

    grew = sorted(keys, key=lambda k: device_ms("zero_match", k) - device_ms("pose_live", k))
    fresh()
    emit(dict(phase="pose_path", part="(d) make_train_step", batch=[b, v, h, w],
              steps=steps, pose_grad_norm_share=(steps["pose_only"]["grad_norm"]
                                                 / live["grad_norm"]),
              train_frozen_zero_match_ms=zero_match_step_ms, launches_want=want,
              traced=traced,
              ops_grown_most=[dict(launched_by=k[0], name=k[1],
                                   ms=[device_ms("pose_live", k), device_ms("zero_match", k)],
                                   count=[device_count("pose_live", k),
                                          device_count("zero_match", k)])
                              for k in grew[:8]]))

    # (e) host syncs of the serving request's encoder (the policy) and of the
    # train input's pose loss, forward and backward
    scene, inputs, frozen, corr, noise = encs["serve"]

    def encoder_call():
        with torch.no_grad():
            model.encoder(*inputs, frozen, corr, 0, ransac_noise=noise)

    syncs = {"serve_encoder": count_syncs(encoder_call)}
    scene, inputs, frozen, corr, noise = encs["train"]
    with torch.no_grad():
        enc = model.encoder(*inputs, frozen, corr, 0, ransac_noise=noise)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (enc.refined_poses, enc.xyz, enc.depths)]

    def loss_call():
        val = pose_loss(enc._replace(refined_poses=leaves[0], xyz=leaves[1], depths=leaves[2]),
                        inputs[1], LossCfg())
        val.backward()

    syncs["train_pose_loss"] = count_syncs(loss_call)
    pose_files = ("geometry/", "models/encoder.py", "training/losses.py")
    emit(dict(phase="pose_path", part="(e) host syncs",
              totals={k: sum(c.values()) for k, c in syncs.items()},
              pose_stage={k: sum(n for where, n in c.items()
                                 if any(f in where for f in pose_files))
                          for k, c in syncs.items()},
              by_line=syncs))
    del model, encs, enc
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("pose_path: " + "; ".join(failed))


# Phase memory_policy: the encoder's remat modes and compute dtypes on the
# training step of record, then `main` at configs/re10k.yaml's own batch.
REMAT_MODES = {"off": dict(remat=False), "selective": dict(remat=True, remat_mode="selective"),
               "coarse": dict(remat=True, remat_mode="coarse")}
BF16_KNOBS = dict(unet_dtype="bfloat16", costvolume_dtype="bfloat16")
# Loss and gradient norm of the remat modes' steps against the step without
# remat, relative: the recompute replays the same forward, but the encoder's
# backward is not bit-reproducible on the card (the sharded step's gate).
TOL_REMAT = TOL_TRAIN_MESH
# Loss of the selective step at unet_dtype = costvolume_dtype = bfloat16
# against the float32 step's, relative: the depth predictor's outputs move by
# a few bfloat16 steps of their largest value (up to 8 held on the CPU,
# tests/test_torch_remat.py), and the loss averages over the pixels they feed.
TOL_BF16_LOSS = 2e-2
# `main` at the batch of record: 2 roots x 2 chunks x MEMORY_SCENES training
# scenes, 28, so two batches of 14 draw no scene twice.
MEMORY_DATA = REPO / "build" / "memory_data"
MEMORY_OUT = REPO / "build" / "memory_out"
MEMORY_SCENES = 7
MEMORY_REDUCED = ["max_steps 300001 -> 2"]


def policy_step(knobs: dict, trace_dir: Path | None = None, exact_steps: bool = False,
                shared: dict | None = None) -> dict:
    """The training step of record (the train phase's model, batch and
    seeds, `streamed` decoder) with the encoder knobs `knobs`: a warm-up
    step, then one timed step -> its ms, stage split, peak bytes (whole step
    and per stage), loss, gradient norm and launches, and the warm-up's loss
    and gradient norm. Fails unless the attention kernels ran as often as
    `attention_per_step` derives for the knobs and B1-B4 once. With
    `trace_dir`, one more step is traced there and its ten heaviest device
    operations are returned. With `exact_steps`, the same two steps run once
    more from the same parameters and generator under `exact()`: their
    losses and gradient norms as `exact`. With `shared` too, the first call
    puts its exact step 1's state there and later calls take their exact
    step 2 from it (two steps in turn differ by Adam's first update on
    noise-level gradients: `TOL_TRAIN_MESH`)."""
    import gc
    import shutil

    import torch

    from pf3plat_tpu_torch.precision import exact

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch import kernels
    from pf3plat_tpu_torch.training.losses import LossCfg
    from pf3plat_tpu_torch.training.train import (
        OptimizerCfg, init_train_state, make_model_train_step)
    from pf3plat_tpu_torch.utils import profiling

    cfg = model_config()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **knobs))
    torch.manual_seed(SEED)
    model = PF3plat(cfg, device="cuda")
    batch = train_batch()
    step_fn = make_model_train_step(model, LossCfg(), OptimizerCfg())
    init = {k: v.clone() for k, v in model.encoder.state_dict().items()} if exact_steps else None
    state = init_train_state(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state, warm = step_fn(state, batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    timer = StageTimer()
    wall0 = time.perf_counter()
    timer.start()
    state, aux = step_fn(state, batch, generator=gen, timer=timer)
    torch.cuda.synchronize()
    row = dict(knobs=knobs, remat_policy=cfg.encoder.remat_policy,
               total_ms=(time.perf_counter() - wall0) * 1e3, **timer.stage_ms(),
               max_memory_allocated_bytes=max(timer.peaks.values()),
               stage_peak_bytes=timer.stage_peak_bytes(),
               loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]),
               warmup=dict(loss=float(warm["loss"]), grad_norm=float(warm["grad_norm"])),
               launches=dict(kernels.LAUNCHES))
    want = {**{k: 1 for k in TRAIN_KERNELS["streamed"]}, **attention_per_step(cfg)}
    wrong = {k: (row["launches"][k], n) for k, n in want.items() if row["launches"][k] != n}
    if wrong:
        raise AssertionError(f"memory_policy {knobs}: launches in a step (got, derived) {wrong}")
    if not all(math.isfinite(x) for x in (row["loss"], row["grad_norm"],
                                          *row["warmup"].values())):
        raise AssertionError(f"memory_policy {knobs}: non-finite {row}")
    if trace_dir is not None:
        shutil.rmtree(trace_dir, ignore_errors=True)
        with profiling.trace(trace_dir, "memory_policy_step"):
            step_fn(state, batch, generator=gen)
        row["trace"] = trace_window(trace_dir, "memory_policy_step")
    if exact_steps:
        model.encoder.load_state_dict(init)
        state = init_train_state(model)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with exact():
            state, first = step_fn(state, batch, generator=gen)
            if shared is not None:
                if "step1" not in shared:
                    shared["step1"] = snapshot(state, gen)
                else:
                    state = restore(state, gen, shared["step1"])
            state, second = step_fn(state, batch, generator=gen)
        row["exact"] = dict(warmup={k: float(first[k]) for k in ("loss", "grad_norm")},
                            **{k: float(second[k]) for k in ("loss", "grad_norm")})
    del model, state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main_batch_of_record() -> dict:
    """`main` on configs/re10k.yaml at its own batch of 14 (no batch
    override; default remat, selective), 2 steps over MEMORY_DATA, as `python
    -m pf3plat_tpu_torch.main` runs it. Per step: ms, data_wait_ms, the
    stage split, peak bytes (whole step and per stage), launches. Gates: 2
    finite steps of 14 examples; B1-B4 once a step and the attention
    kernels as `attention_per_step` derives. On a failure (an out-of-memory
    error, say) the steps so far and the allocator's peak are printed
    first."""
    import gc
    import shutil

    import torch

    from pf3plat_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    roots = write_main_data(MEMORY_DATA, scenes=MEMORY_SCENES, splits=("train",))
    data_s = time.perf_counter() - t0
    shutil.rmtree(MEMORY_OUT, ignore_errors=True)
    argv = [str(REPO / "configs" / "re10k.yaml"),
            "dataset.roots=" + json.dumps([str(r) for r in roots]), "max_steps=2",
            f'checkpointing.directory="{MEMORY_OUT / "ckpt"}"', f'output_dir="{MEMORY_OUT}"',
            f'test.output_path="{MEMORY_OUT}/test/x"']
    cfg = load_config(argv[0], argv[1:])
    if (cfg.data_loader.batch_size, cfg.encoder.remat_policy) != (14, "selective"):
        raise AssertionError(f"configs/re10k.yaml: batch {cfg.data_loader.batch_size}, remat "
                             f"{cfg.encoder.remat_policy}, not the batch of record 14, selective")
    want = {**{k: 1 for k in TRAIN_KERNELS["streamed"]}, **attention_per_step(model_config())}
    t0 = time.perf_counter()
    rec = None
    try:
        with instrument_main() as rec:
            out = run_main(argv)
    except Exception as e:
        emit(dict(phase="main_batch_of_record", failed=repr(e)[:600],
                  steps=[] if rec is None else rec["steps"],
                  max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                  max_memory_reserved_bytes=torch.cuda.max_memory_reserved()))
        raise
    run_s = time.perf_counter() - t0
    steps = rec["steps"]
    for i, row in enumerate(steps):  # batch k was waited for before step k
        row["data_wait_ms"] = rec["data_wait_ms"][i]
    bad = [(r["step"], r["batch"], r["loss"]) for r in steps
           if r["batch"] != 14 or not math.isfinite(r["loss"])]
    wrong = [(r["step"], k, r["launches"][k], n) for r in steps for k, n in want.items()
             if r["launches"][k] != n]
    if len(steps) != 2 or bad or wrong or "failed" in out:
        raise AssertionError(f"main at the batch of record: {len(steps)} steps, (step, batch, "
                             f"loss) off {bad}, launches (step, kernel, got, derived) {wrong}\n"
                             + out[-2000:])
    row = dict(phase="main_batch_of_record", config="configs/re10k.yaml", reduced=MEMORY_REDUCED,
               batch=[14, steps[0]["views"], 256, 256], data_s=data_s,
               data=[f"{r.name}: 2 chunks x {MEMORY_SCENES} scenes x {MAIN_FRAMES} frames of "
                     f"{MAIN_IMAGE[0]}x{MAIN_IMAGE[1]} JPEG q{MAIN_JPEG_QUALITY}" for r in roots],
               run_s=run_s, steps=[{k: v for k, v in r.items() if k != "launches"} for r in steps],
               launches_per_step=steps[0]["launches"], derived_launches=want,
               max_memory_allocated_bytes=max(r["max_memory_allocated_bytes"] for r in steps),
               memory_total_bytes=torch.cuda.get_device_properties(0).total_memory)
    emit(row)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def memory_policy() -> None:
    """Phase memory_policy. (a) The training step of record at b=3 under
    remat off, selective and coarse: loss and gradient norm within TOL_REMAT
    of the step without remat (warm-up and timed step, run once more under
    `exact()` for this gate: step 1 from the same parameters, step 2 from
    the step 1 state without remat), selective's peak
    below off's, attention launches as derived for each mode. (b) The
    selective step at unet_dtype = costvolume_dtype = bfloat16: its loss
    within TOL_BF16_LOSS of the float32 step's and not equal to it; one
    traced step of each, float32 and bfloat16, with their heaviest device
    operations. (c) `main` at the batch of record (`main_batch_of_record`);
    its peak against (a)'s at b=3 gives the bytes an example adds."""
    shared = {}  # "off" (first) puts its exact step 1's state here
    rows = {mode: policy_step(knobs, TRACE_DIR / "memory_f32" if mode == "selective" else None,
                              exact_steps=True, shared=shared)
            for mode, knobs in REMAT_MODES.items()}
    del shared
    off = rows["off"]

    def rel(a, b):
        return abs(a - b) / abs(b)

    # The modes compute one function in other structures (the backward
    # replays the forward), and cuDNN's TF32 algorithm choice follows the
    # memory state: the gate compares the modes' steps under exact(); the
    # timed steps under the policy are printed beside it.
    worst = max(rel(r["exact"][k], off["exact"][k]) for r in rows.values()
                for k in ("loss", "grad_norm"))
    worst = max(worst, max(rel(r["exact"]["warmup"][k], off["exact"]["warmup"][k])
                           for r in rows.values() for k in ("loss", "grad_norm")))
    policy_worst = max(max(rel(r[k], off[k]), rel(r["warmup"][k], off["warmup"][k]))
                       for r in rows.values() for k in ("loss", "grad_norm"))
    below = rows["selective"]["max_memory_allocated_bytes"] < off["max_memory_allocated_bytes"]
    emit(dict(phase="memory_remat", batch=[3, 3, 256, 256],
              modes={m: {k: v for k, v in r.items() if k != "trace"} for m, r in rows.items()},
              max_rel_diff=worst, policy_max_rel_diff=policy_worst,
              tol=TOL_REMAT, selective_peak_below_off=below))
    if not worst <= TOL_REMAT:
        raise AssertionError(f"memory_policy: remat modes' loss / grad_norm differ by {worst} "
                             f"> {TOL_REMAT}")
    if not below:
        raise AssertionError("memory_policy: selective remat's peak is not below remat=false's")

    f32 = rows["selective"]
    bf16 = policy_step({**REMAT_MODES["selective"], **BF16_KNOBS}, TRACE_DIR / "memory_bf16")
    loss_rel = rel(bf16["loss"], f32["loss"])
    emit(dict(phase="memory_bf16", knobs=bf16["knobs"], step=bf16, float32_step_ms=f32["total_ms"],
              float32_peak_bytes=f32["max_memory_allocated_bytes"],
              float32_loss=f32["loss"], loss_rel_diff=loss_rel, tol=TOL_BF16_LOSS,
              grad_norm_rel_diff=rel(bf16["grad_norm"], f32["grad_norm"]),
              float32_trace=f32["trace"]))
    if not 0 < loss_rel <= TOL_BF16_LOSS:
        raise AssertionError(f"memory_policy: bfloat16 step's loss differs from float32's by "
                             f"{loss_rel}, not in (0, {TOL_BF16_LOSS}]")

    rec = main_batch_of_record()
    peak3, peak14 = f32["max_memory_allocated_bytes"], rec["max_memory_allocated_bytes"]
    emit(dict(phase="memory_per_example", peak_b3_bytes=peak3, peak_b14_main_bytes=peak14,
              bytes_per_example=(peak14 - peak3) / 11))


@contextlib.contextmanager
def bf16_operands():
    """A torch function mode that rounds the operands of every matmul,
    convolution and library attention to bf16 and computes in float32: the
    JAX package's `default_matmul_precision("bfloat16")` (one bf16 pass,
    float32 sums and outputs). Biases stay float32. The products the JAX
    package pins to "highest" (`precision.exact_einsum`) are left exact."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    from pf3plat_tpu_torch import precision

    two = {F.linear, torch.conv1d, torch.conv2d, F.conv1d, F.conv2d, F.conv_transpose2d}
    every = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.bmm,
             torch.einsum, F.scaled_dot_product_attention}
    last_two = {torch.addmm, torch.baddbmm}
    pinned = [0]  # > 0 inside a pinned product

    def rnd(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        if isinstance(x, (list, tuple)):
            return type(x)(rnd(y) for y in x)
        return x

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if pinned[0]:
                pass
            elif func in two:
                args = (rnd(args[0]), rnd(args[1]), *args[2:])
            elif func in every:
                args = tuple(rnd(a) for a in args)
            elif func in last_two:
                args = (args[0], rnd(args[1]), rnd(args[2]), *args[3:])
            return func(*args, **kwargs)

    cls = precision._ExactEinsum
    forward = cls.forward

    def pinned_forward(ctx, *args):
        pinned[0] += 1
        try:
            return forward(ctx, *args)
        finally:
            pinned[0] -= 1

    cls.forward = staticmethod(pinned_forward)
    try:
        with Mode():
            yield
    finally:
        cls.forward = staticmethod(forward)


@contextlib.contextmanager
def heads_under_autocast():
    """Perception's decision heads under plain bf16 autocast (bf16 outputs),
    the parent tree's rule, in place of `precision.decision_head`'s JAX
    rule."""
    from pf3plat_tpu_torch import precision

    rule = precision.decision_head
    precision.decision_head = lambda layer, x: layer(x)
    try:
        yield
    finally:
        precision.decision_head = rule


def serving_inputs():
    """The serving request's inputs (b=1, v=5, 256 x 256) from numpy seed
    SEED, on the card: images, intrinsics, near, far."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    b, v, h, w = 1, SERVE_VIEWS, 256, 256
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32), device="cuda")
    intr = torch.as_tensor(np.broadcast_to(
        np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (b, v, 3, 3)).astype(np.float32),
        device="cuda")
    return images, intr, torch.ones((b, v), device="cuda"), torch.full((b, v), 100.0, device="cuda")


# Perception's modes in phase perceive_precision / precision (d): the frozen
# precision and the scope it runs in. "autocast": bf16 autocast with the
# heads under autocast too (the parent tree's rule); "default": the port's
# rule (autocast, the decision heads at the JAX rule); "jax_rule": float32
# modules with bf16-rounded operands (the JAX package's); "highest": exact
# float32.
PERCEIVE_MODES = ("autocast", "default", "jax_rule", "highest")


def perceive_precision() -> dict:
    """`PF3plat.perceive` on the serving request (b=1, v=5, 256 x 256,
    configs/re10k_test.yaml's model, random weights from the seed) in the
    four PERCEIVE_MODES, the autocast modes under the declared policy, the
    other two under `exact()`. Per mode: the ms of 3 calls after a warm-up
    (CUDA events), the depth, feature and match differences from "highest"
    (line `perceive_precision`), and SuperPoint's and LightGlue's discrete
    outputs of one more call against the JAX rule's and "highest"'s: the
    share of keypoints at the same pixel and rank (`kpts_equal`), of
    keypoints whose pixel the other mode also keeps in that image
    (`kpts_shared`), of detection-valid flags and of match-valid flags that
    agree (line `precision`, part d). Gate: the port's default agrees with
    the JAX rule on keypoints, by both measures, at least as well as plain
    autocast does."""
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.precision import exact

    torch.manual_seed(SEED)
    model = PF3plat(model_config(config="re10k_test.yaml"), device="cuda")
    base = model.cfg
    images, intr, _, _ = serving_inputs()
    b, v, h, w = images.shape[:4]

    def under_exact(scope):
        @contextlib.contextmanager
        def both():
            with exact(), scope():
                yield
        return both

    modes = {"autocast": ("bfloat16", heads_under_autocast),
             "default": ("bfloat16", contextlib.nullcontext),
             "jax_rule": ("highest", under_exact(bf16_operands)),
             "highest": ("highest", exact)}
    outs, ms, discrete = {}, {}, {}
    for name, (frozen_precision, scope) in modes.items():
        model.cfg = dataclasses.replace(base, frozen_matmul_precision=frozen_precision)
        with scope():
            model.perceive(images, intr)  # warm-up
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                frozen, corr = model.perceive(images, intr)
            end.record()
            torch.cuda.synchronize()
            seen = {"kpts": [], "matches": []}
            hooks = [model.superpoint.register_forward_hook(
                         lambda mod, args, out: seen["kpts"].append(out)),
                     model.lightglue.register_forward_hook(
                         lambda mod, args, out: seen["matches"].append(out))]
            try:
                model.perceive(images, intr)
            finally:
                for hook in hooks:
                    hook.remove()
        ms[name] = start.elapsed_time(end) / 3
        outs[name] = (frozen, corr)
        discrete[name] = dict(
            xy=torch.cat([k.xy.reshape(-1, *k.xy.shape[-2:]) for k in seen["kpts"]]),
            valid=torch.cat([k.valid.reshape(-1) for k in seen["kpts"]]),
            match_valid=torch.cat([m.valid.reshape(-1) for m in seen["matches"]]))
    model.cfg = base

    def rel(a, c):
        return dict(max_rel=float((a - c).abs().max() / c.abs().max()),
                    mean_rel=float((a - c).abs().mean() / c.abs().mean()))

    ref_f, ref_c = outs["highest"]
    diffs = {}
    for name in ("autocast", "default", "jax_rule"):
        f, c = outs[name]
        both = c.valid & ref_c.valid
        diffs[name] = dict(
            depth=rel(f.depth, ref_f.depth), features=rel(f.features, ref_f.features),
            matches_valid=int(c.valid.sum()), matches_valid_highest=int(ref_c.valid.sum()),
            matches_valid_agree=float((c.valid == ref_c.valid).float().mean()),
            kpts_equal=float((c.kpts0 == ref_c.kpts0).all(-1).float().mean()),
            scores_max_abs=float((c.scores - ref_c.scores)[both].abs().max()) if bool(both.any())
            else None)
    ratio = {mode: {k: diffs[mode][k]["mean_rel"] / max(diffs["jax_rule"][k]["mean_rel"], 1e-30)
                    for k in ("depth", "features")} for mode in ("autocast", "default")}
    emit(dict(phase="perceive_precision", batch=[b, v, h, w], perceive_ms=ms,
              jax_rule_cost=ms["jax_rule"] / ms["autocast"] - 1.0, diffs_from_highest=diffs,
              over_jax_rule=ratio))
    for name, (f, _) in outs.items():
        if not (bool(torch.isfinite(f.depth).all()) and bool(torch.isfinite(f.features).all())):
            raise AssertionError(f"perceive_precision: non-finite outputs under {name}")

    def pixels(xy):
        return xy[..., 1].long() * w + xy[..., 0].long()

    def agreement(got, ref):
        a, r = pixels(got["xy"]), pixels(ref["xy"])
        shared = torch.stack([torch.isin(x, y) for x, y in zip(a, r)])
        return dict(kpts_equal=float((got["xy"] == ref["xy"]).all(-1).float().mean()),
                    kpts_shared=float(shared.float().mean()),
                    detection_valid_agree=float((got["valid"] == ref["valid"]).float().mean()),
                    match_valid_agree=float(
                        (got["match_valid"] == ref["match_valid"]).float().mean()))

    table = {mode: {ref: agreement(discrete[mode], discrete[ref])
                    for ref in ("jax_rule", "highest") if ref != mode}
             for mode in PERCEIVE_MODES}
    counts = {mode: dict(keypoints=int(d["valid"].numel()), detections=int(d["valid"].sum()),
                         matches=int(d["match_valid"].sum())) for mode, d in discrete.items()}
    gate = all(table["default"]["jax_rule"][k] >= table["autocast"]["jax_rule"][k]
               for k in ("kpts_equal", "kpts_shared"))
    emit(dict(phase="precision", part="d", batch=[b, v, h, w], agreement=table, counts=counts,
              default_at_least_autocast=gate))
    if not gate:
        raise AssertionError(f"precision (d): the default agrees with the JAX rule on keypoints "
                             f"less than plain autocast does: {table}")
    del model, outs
    torch.cuda.empty_cache()
    return dict(ms=ms, diffs=diffs, ratio=ratio, agreement=table)


# Phase precision: the port's precision rules on the card.
# (c) TF32 may move one step of record's loss and gradient norm (from the
# same parameters) by this much, relative, for the declared policy to allow
# it; above it the policy is TF32 off.
TOL_TF32_STEP = 1e-3
PINNED_SPECS = {"bmd,bnd->bmn": "lightglue similarity",
                "...shd,...shv->...hdv": "linear attention kv",
                "...lhd,...hd->...lh": "linear attention normaliser",
                "bnc,bmc->bnm": "cost volume fusion logits"}


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS and cuDNN TF32 set to `on` inside, the previous flags after."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _caller_site(frame) -> str:
    """The module class (or `window_attention`) that called into attention."""
    import torch

    for _ in range(6):
        if frame is None:
            break
        owner = frame.f_locals.get("self")
        if isinstance(owner, torch.nn.Module):
            return type(owner).__name__
        if frame.f_code.co_name == "window_attention":
            return "window_attention"
        frame = frame.f_back
    return "?"


@contextlib.contextmanager
def capture_precision_sites():
    """Record, inside the block, the first call of each distinct
    `layers.library_attention` signature (its inputs, the calling module,
    autocast on or off) and of each `precision.exact_einsum` spec and shape
    (inputs, output, autocast)."""
    import torch

    from pf3plat_tpu_torch import precision
    from pf3plat_tpu_torch.models import layers

    seen = {"attention": {}, "pinned": {}}
    library = layers.library_attention
    cls = precision._ExactEinsum
    forward = cls.forward

    def recording(q, k, v, mask=None, bias=None, q_scale=None):
        autocast = torch.is_autocast_enabled("cuda")
        key = (tuple(q.shape), tuple(k.shape), mask is not None, bias is not None, q_scale,
               autocast)
        if key not in seen["attention"]:
            keep = (lambda x: None if x is None else x.detach().clone())
            seen["attention"][key] = dict(
                site=_caller_site(sys._getframe(1)), q=keep(q).float(), k=keep(k).float(),
                v=keep(v).float(), mask=keep(mask), bias=keep(bias), q_scale=q_scale,
                autocast=autocast)
        return library(q, k, v, mask=mask, bias=bias, q_scale=q_scale)

    def pinned(ctx, spec, a, b):
        out = forward(ctx, spec, a, b)
        key = (spec, tuple(a.shape), tuple(b.shape))
        if key not in seen["pinned"]:
            seen["pinned"][key] = dict(spec=spec, a=a.detach().clone(), b=b.detach().clone(),
                                       out=out.detach().clone(),
                                       autocast=torch.is_autocast_enabled("cuda"))
        return out

    layers.library_attention = recording
    cls.forward = staticmethod(pinned)
    try:
        yield seen
    finally:
        layers.library_attention = library
        cls.forward = staticmethod(forward)


def mxu_vjp(s: dict, g):
    """The backward of `mxu_einsum` attention as the JAX package computes
    it on its chip and FlashAttention-2 computes it (`attention_bwd_plain`'s
    arithmetic): XLA's default precision rounds the operands of the
    transposed products to bf16, so P and dS are rounded to bf16 before
    their products, the sums are float32, and each gradient comes back in
    its operand's dtype (bf16) -> (dq, dk, dv) of `library_attention`'s
    float32 inputs for the upstream gradient g."""
    import torch

    from pf3plat_tpu_torch.models import layers

    def bf(x):
        return x.to(torch.bfloat16).float()

    q_scale = s["q_scale"]
    q = bf(s["q"] * q_scale) if q_scale is not None else bf(s["q"])
    k, v, gb = bf(s["k"]), bf(s["v"]), bf(g)
    scale = 1.0 if q_scale is not None else s["q"].shape[-1]**-0.5
    sim = torch.matmul(q, k.transpose(-1, -2)) * scale
    add = layers._additive_mask(s["mask"], s["bias"], sim)
    if add is not None:  # added in bf16, as `library_attention` adds it
        sim = sim + bf(add)
    p = torch.softmax(sim, dim=-1)
    del sim
    out = bf(torch.matmul(bf(p), v))
    delta = (gb * out).sum(-1, keepdim=True)
    ds = bf(p * (torch.matmul(gb, v.transpose(-1, -2)) - delta))
    dv = torch.matmul(bf(p).transpose(-1, -2), gb)
    del p
    dq = bf(torch.matmul(ds, k) * scale) * (1.0 if q_scale is None else q_scale)
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    return dq, bf(dk), bf(dv)


def attention_sites(sites: dict) -> list:
    """Part (a): each captured library attention at its shape, the card's
    `library_attention` (outside autocast, under the policy) against its
    twin's arithmetic under `exact()`. The forward against `mxu_attention`
    (the CPU path): within TOL_ATTN of the largest magnitude. The backward,
    with a fixed upstream gradient, against the exact float32 gradient
    (`float32_sdpa` under `exact()`): within TOL_ATTN of its largest
    magnitude, or at most TOL_ATTN further from it than the reference's own
    arithmetic (`mxu_vjp`) is; bf16-rounded dS over thousands of keys puts
    both several percent of the largest dq off exact. The direct
    differences from `mxu_vjp` and from autograd through `mxu_attention`
    are printed beside them. Sites in frozen perception (LightGlue) take no
    gradient: forward only. -> rows with the errors and the ms of a forward
    and backward (forward only in perception) of the library and the twin."""
    import torch

    from pf3plat_tpu_torch.models import layers
    from pf3plat_tpu_torch.precision import exact

    rows = []
    for i, s in enumerate(sites.values()):
        kw = dict(mask=s["mask"], bias=s["bias"], q_scale=s["q_scale"])
        backward = not s["autocast"]
        gen = torch.Generator(device="cuda").manual_seed(SEED + i)
        g = torch.randn(s["q"].shape[:-1] + s["v"].shape[-1:], device="cuda", generator=gen)

        def run(fn):
            q, k, v = (s[x].clone().requires_grad_(backward) for x in ("q", "k", "v"))
            out = fn(q, k, v, **kw)
            if not backward:
                return (out.detach(),)
            return (out.detach(), *torch.autograd.grad(out, (q, k, v), g))

        def rel(got, want):
            return {name: float((a.float() - b).abs().max() / b.abs().max())
                    for name, a, b in zip(("dq", "dk", "dv"), got, want)}

        got = run(layers.library_attention)
        bwd = None
        with exact():
            twin = run(layers.mxu_attention)
            twin_ms = cuda_ms(lambda: run(layers.mxu_attention), 3, warmup=1)
            out_err = float((got[0] - twin[0]).abs().max() / twin[0].abs().max())
            if backward:
                vjp = mxu_vjp(s, g)
                exact_grads = run(float32_sdpa)[1:]
                bwd = dict(library_vs_exact=rel(got[1:], exact_grads),
                           reference_vs_exact=rel(vjp, exact_grads),
                           library_vs_reference=rel(got[1:], vjp),
                           library_vs_autograd_twin=rel(got[1:], twin[1:]))
                del vjp, exact_grads
        lib_ms = cuda_ms(lambda: run(layers.library_attention), 3, warmup=1)
        ok = out_err <= TOL_ATTN and (bwd is None or all(
            err <= TOL_ATTN + bwd["reference_vs_exact"][name]
            for name, err in bwd["library_vs_exact"].items()))
        rows.append(dict(site=s["site"], q=list(s["q"].shape), k=list(s["k"].shape),
                         masked=s["mask"] is not None, bias=s["bias"] is not None,
                         q_scale=s["q_scale"], under_perception_autocast=s["autocast"],
                         out_dtype=str(got[0].dtype).replace("torch.", ""),
                         out_rel_err=out_err, backward=bwd, within_gate=ok,
                         library_ms=lib_ms, twin_ms=twin_ms))
        del got, twin
        torch.cuda.empty_cache()
    return rows


def pinned_sites(calls: dict) -> list:
    """Part (b): each pinned product as it ran (under perception's autocast
    or the encoder's policy) against `torch.einsum` of the same operands
    under `exact()`, bit for bit; beside it how far the same product is from
    exact when not pinned (autocast as it was, the declared policy)."""
    import torch

    from pf3plat_tpu_torch.precision import exact

    rows = []
    for c in calls.values():
        with exact():
            want = torch.einsum(c["spec"], c["a"].float(), c["b"].float())
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=c["autocast"]):
            free = torch.einsum(c["spec"], c["a"], c["b"])
        rows.append(dict(site=PINNED_SPECS.get(c["spec"], c["spec"]), spec=c["spec"],
                         a=list(c["a"].shape), b=list(c["b"].shape), autocast=c["autocast"],
                         dtype=str(c["out"].dtype).replace("torch.", ""),
                         bit_equal=bool(torch.equal(c["out"], want)),
                         unpinned_max_rel=float((free.float() - want).abs().max()
                                                / want.abs().max())))
    return rows


def conv_gemms(trace_dir: Path, window: str) -> dict:
    """The device operations that `aten::cudnn_convolution` launched in a
    traced window: ms and launches of all, of the complex-f32 GEMMs (FFT
    convolutions: `cf32` / `cgemm` in the kernel name) and the five
    heaviest."""
    from pf3plat_tpu_torch.utils import profiling

    rows = [r for r in profiling.device_op_breakdown(trace_dir, window=window)
            if r["launched_by"] == "aten::cudnn_convolution"]
    cplx = [r for r in rows if "cf32" in r["name"].lower() or "cgemm" in r["name"].lower()]
    return dict(ms=sum(r["total_us"] for r in rows) / 1e3, launches=sum(r["count"] for r in rows),
                complex_gemm_ms=sum(r["total_us"] for r in cplx) / 1e3,
                complex_gemm_launches=sum(r["count"] for r in cplx),
                top=[dict(name=r["name"][:100], ms=r["total_us"] / 1e3, count=r["count"])
                     for r in rows[:5]])


def float32_sdpa(q, k, v, mask=None, bias=None, q_scale=None):
    """Attention outside the flash rule as the parent tree ran it on the
    card outside autocast: float32 operands into SDPA."""
    import torch.nn.functional as F

    from pf3plat_tpu_torch.models import layers

    if q_scale is not None:
        q = q * q_scale
    add = layers._additive_mask(mask, bias, q)
    return F.scaled_dot_product_attention(q.float(), k.float(), v.float(),
                                          attn_mask=None if add is None else add.float(),
                                          scale=None if q_scale is None else 1.0)


def step_spread_and_determinism() -> dict:
    """Part (e): the training step of record (b=3, the train phase's model
    and batch), warmed up, then twice from the same parameters and generator
    with bf16 SDPA outside the flash rule (the port) and twice with float32
    SDPA (the parent tree): the relative spread of the two steps' loss and
    gradient norm for each. Then one step under
    `torch.use_deterministic_algorithms(True, warn_only=True)`: the
    operations torch names as nondeterministic."""
    import gc
    import warnings

    import torch

    from pf3plat_tpu_torch.models import layers
    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.training.losses import LossCfg
    from pf3plat_tpu_torch.training.train import (
        OptimizerCfg, init_train_state, make_model_train_step)

    torch.manual_seed(SEED)
    model = PF3plat(model_config(), device="cuda")
    batch = train_batch()
    step_fn = make_model_train_step(model, LossCfg(), OptimizerCfg())
    init = {k: v.clone() for k, v in model.encoder.state_dict().items()}

    def step():
        model.encoder.load_state_dict(init)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        _, aux = step_fn(init_train_state(model), batch, generator=gen)
        return dict(loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]))

    def spread(a, b):
        return {k: abs(a[k] - b[k]) / abs(b[k]) for k in a}

    step()  # warm-up
    runs = {"bf16_sdpa": [step(), step()]}
    library = layers.library_attention
    layers.library_attention = float32_sdpa
    try:
        step()
        runs["float32_sdpa"] = [step(), step()]
    finally:
        layers.library_attention = library
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step()
        finally:
            torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).splitlines()[0][:240] for w in caught
                    if "determinis" in str(w.message).lower()})
    row = dict(runs=runs, spread={k: spread(*r) for k, r in runs.items()},
               nondeterministic_ops=named)
    del model, step_fn, batch, init
    gc.collect()
    torch.cuda.empty_cache()
    return row


def precision_phase() -> None:
    """Phase precision. On the serving request (configs/re10k_test.yaml's
    model, b=1, v=5, 256 x 256, random weights from the seed), under the
    declared policy: (a) every attention outside the flash rule at its
    shape, `library_attention` against its twin's arithmetic under
    `exact()`, forward and backward (gate TOL_ATTN of the largest
    magnitude); (b) every pinned product bit-equal to its `exact()` product;
    one request with PF3PLAT_FLASH_ATTENTION=0 (no attention kernel
    launch), one under deterministic algorithms (the operations named).
    (c) The training step of record at b=3 with TF32 on and off: loss,
    gradient norm, step ms and one traced step each with the convolutions'
    device time; the declared `precision.TF32` must be what TOL_TF32_STEP
    decides. (d) `perceive_precision`. (e) `step_spread_and_determinism`."""
    import gc
    import os
    import warnings

    import torch

    from pf3plat_tpu_torch import precision
    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch import kernels

    torch.manual_seed(SEED)
    model = PF3plat(model_config(config="re10k_test.yaml"), device="cuda")
    inputs = serving_inputs()

    def request():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with torch.no_grad():
            enc, out = model(*inputs, 0, generator=gen)
        if not bool(torch.isfinite(out.color).all()):
            raise AssertionError("precision: non-finite colour")
        return enc, out

    request()  # warm-up
    with capture_precision_sites() as seen:
        request()
    attn = attention_sites(seen["attention"])
    emit(dict(phase="precision", part="a", sites=attn, tol=TOL_ATTN,
              max_out_rel_err=max(r["out_rel_err"] for r in attn)))
    if not all(r["within_gate"] and r["out_dtype"] == "float32" for r in attn):
        raise AssertionError(f"precision (a): library attention outside its gate, or not "
                             f"float32: {attn}")
    pinned = pinned_sites(seen["pinned"])
    missing = set(PINNED_SPECS) - {r["spec"] for r in pinned}
    emit(dict(phase="precision", part="b", sites=pinned, missing=sorted(missing)))
    del seen
    if missing or not all(r["bit_equal"] and r["dtype"] == "float32" for r in pinned):
        raise AssertionError(f"precision (b): pinned products missing {missing} or not exact "
                             f"float32: {pinned}")

    os.environ["PF3PLAT_FLASH_ATTENTION"] = "0"
    try:
        kernels.reset_launches()
        request()
        flash_off = {k: kernels.LAUNCHES[k] for k in MODEL_TRAIN_KERNELS}
    finally:
        del os.environ["PF3PLAT_FLASH_ATTENTION"]
    kernels.reset_launches()
    request()
    flash_on = {k: kernels.LAUNCHES[k] for k in MODEL_TRAIN_KERNELS}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            request()
        finally:
            torch.use_deterministic_algorithms(False)
    serve_named = sorted({str(w.message).splitlines()[0][:240] for w in caught
                          if "determinis" in str(w.message).lower()})
    emit(dict(phase="precision", part="flash_switch", launches_flash_off=flash_off,
              launches_flash_on=flash_on))
    if any(flash_off.values()) or not flash_on["attention_fwd"]:
        raise AssertionError(f"precision: PF3PLAT_FLASH_ATTENTION=0 launched {flash_off}; "
                             f"without it {flash_on}")
    del model, inputs
    gc.collect()
    torch.cuda.empty_cache()

    steps = {}
    for on in (True, False):
        name = "tf32_on" if on else "tf32_off"
        with tf32(on):
            row = policy_step({}, TRACE_DIR / f"precision_{name}")
        row["convolutions"] = conv_gemms(TRACE_DIR / f"precision_{name}", "memory_policy_step")
        steps[name] = row

    def rel(a, b):
        return abs(a - b) / abs(b)

    # One step from the same parameters and generator (the warm-up step);
    # the next step also carries the first's rounding through Adam, whose
    # first update moves every element by +-lr whatever its gradient's size.
    on, off = steps["tf32_on"], steps["tf32_off"]
    moved = max(rel(on["warmup"][k], off["warmup"][k]) for k in ("loss", "grad_norm"))
    second = max(rel(on[k], off[k]) for k in ("loss", "grad_norm"))
    decided = moved <= TOL_TF32_STEP
    emit(dict(phase="precision", part="c", batch=[3, 3, 256, 256], declared_tf32=precision.TF32,
              measured_rel_diff=moved, second_step_rel_diff=second, tol=TOL_TF32_STEP,
              tf32_allowed_by_measurement=decided,
              steps={k: {f: r[f] for f in ("total_ms", "perceive_ms", "encoder_ms",
                                            "backward_ms", "loss", "grad_norm", "warmup",
                                            "max_memory_allocated_bytes", "convolutions")}
                     for k, r in steps.items()},
              traces={k: {f: r["trace"][f] for f in ("busy_ms", "wall_ms", "idle_share")}
                      for k, r in steps.items()}))
    if precision.TF32 != decided:
        raise AssertionError(f"precision (c): TF32 moves the step by {moved} (tolerance "
                             f"{TOL_TF32_STEP}), so the policy should be TF32="
                             f"{decided}, but precision.TF32 is {precision.TF32}")

    perceive_precision()
    spread = step_spread_and_determinism()
    emit(dict(phase="precision", part="e", **spread, serve_nondeterministic_ops=serve_named))


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


# Phase procs_mesh: two processes (ranks) on the one card, gloo between them
# (NCCL refuses two ranks on one card); their outputs under build/.
PROCS_DIR = REPO / "build" / "procs_mesh"
# The two-process main step against one process stepping on the same rows:
# relative, on the loss and gradient norm; the step's own spread on the
# card (the encoder's backward is not bit-reproducible, PERF.md section 6).
TOL_PROCS_STEP = 1e-4
# timed render fwd+bwd runs per mesh, after one warm-up run
PROCS_RENDER_RUNS = 5


def time_mesh_render(scene, impl, config, mesh) -> float:
    """Host ms of one `render_on_mesh` (ending in a synchronisation; the
    gloo exchanges block the host), the median of PROCS_RENDER_RUNS after a
    warm-up."""
    import statistics

    render_on_mesh(scene, impl, config, mesh)
    runs = []
    for _ in range(PROCS_RENDER_RUNS):
        t0 = time.perf_counter()
        render_on_mesh(scene, impl, config, mesh)
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def params_sha256(params) -> str:
    import hashlib

    import torch

    flat = torch.cat([p.detach().reshape(-1).view(torch.uint8) for p in params])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def procs_child(rank: int, port: str, out: Path) -> int:
    """One rank of phase procs_mesh (`--procs-child <rank> <port> <dir>`):
    `initialize_multihost` on gloo, then (1) mesh_render's three cases on a
    (1, 2) world mesh: image and gradients saved, launches read around each
    render, ms and peak bytes; (2) `main` on configs/re10k.yaml at full
    width, b=2 (one example a rank: a (2, 1) world mesh), 2 steps: per step
    ms, peak bytes, launches, the rank-local loss, the gradient norm and a
    hash of the encoder's parameters (before step 1 and after each step),
    and the rank's first batch. Writes rank<r>.json into `out`."""
    import torch

    from pf3plat_tpu_torch.parallel import MeshCfg, initialize_multihost, make_mesh
    from pf3plat_tpu_torch.precision import apply_policy, exact

    apply_policy(torch.device("cuda"))
    initialize_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    result = {"rank": rank, "renders": {}}
    mesh = make_mesh(MeshCfg(data_axis=1, tile_axis=2), device="cuda")
    scene = bench_scene("cuda")
    for name, impl, config, _, _ in mesh_render_cases():
        torch.cuda.reset_peak_memory_stats()
        with exact():  # held bit for bit to the parent's render, also under exact()
            img, grads, launches = render_on_mesh(scene, impl, config, mesh)
        torch.save({"image": img.cpu(), **{k: g.cpu() for k, g in grads.items()}},
                   out / f"{name}_{rank}.pt")
        ms = time_mesh_render(scene, impl, config, mesh)
        result["renders"][name] = dict(
            launches=launches, ms=ms, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
            local_shards=list(mesh.local_shards))
    del scene, img, grads
    torch.cuda.empty_cache()

    hashes = []
    model_box = {}

    def before(index, model, state, batch, kw):
        if index == 0:
            model_box["params"] = state.params
            hashes.append(params_sha256(state.params))
            torch.save({part: {k: v.cpu() for k, v in batch[part].items()}
                        for part in ("context", "target")}, out / f"batch_{rank}.pt")

    def after(index):
        hashes.append(params_sha256(model_box["params"]))

    argv = main_argv([MAIN_DATA / "pfchunk", MAIN_DATA / "torch"], 2, out / "ckpt", out / "run",
                     *PROCS_MAIN_EXTRA)
    with instrument_main(before, after) as rec:
        text = run_main(argv)
    result.update(main_steps=rec["steps"], param_sha256=hashes,
                  logged="step 1: loss=" in text)
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    torch.distributed.destroy_process_group()
    return 0


# main's overrides in phase procs_mesh: one example a rank; targets strictly
# between the context views (every example v=3, so the ranks' rows stack
# into the one-process batch); no validation renders. The pair budget is
# the config's (0.48), and the shard-local budget is sized by the whole
# mesh's batch, as in production.
PROCS_MAIN_EXTRA = ("data_loader.batch_size=2", "view_sampler.min_distance_to_context_views=1",
                    "train.sanity_validation=false", "train.val_check_interval=100")


def procs_mesh() -> dict:
    """Two ranks on the one card (`--procs-child`, gloo), against this
    process: mesh_render's three cases on a (1, 2) world mesh bit-equal to
    the one-process (1, 2) mesh render, each rank launching only its own
    shard's kernels (once a case, not twice); `main` on a (2, 1) world mesh
    with both ranks' parameters bit-equal after each step, step 1's loss and
    gradient norm within TOL_PROCS_STEP of this process stepping on each
    rank's row as the rank does and averaging the gradients (loss: the mean
    of the ranks', as main logs it), its checkpoint and log written once.
    Prints per rank ms and peak bytes, and this process's ms for the two
    rows; returns per kernel the launches a rank made (the three renders,
    and a main step)."""
    import gc
    import shutil
    import socket

    import torch

    from pf3plat_tpu_torch import main as port_main
    from pf3plat_tpu_torch.parallel import Mesh, MeshCfg, make_mesh
    from pf3plat_tpu_torch.precision import exact
    from pf3plat_tpu_torch.training import train as train_mod
    from pf3plat_tpu_torch.training.train import init_train_state
    from pf3plat_tpu_torch.utils.config import load_config

    if not (MAIN_DATA / "torch" / "train").is_dir():
        write_main_data(MAIN_DATA)
    shutil.rmtree(PROCS_DIR, ignore_errors=True)
    PROCS_DIR.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    t0 = time.perf_counter()
    logs = [(PROCS_DIR / f"rank{r}.out").open("w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--procs-child",
                               str(r), port, str(PROCS_DIR)], stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        codes = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:  # a rank left waiting for a failed one is stopped
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    children_s = time.perf_counter() - t0
    if any(codes):
        tails = {r: (PROCS_DIR / f"rank{r}.out").read_text()[-3000:] for r in range(2)}
        raise AssertionError(f"procs_mesh: ranks exited with {codes}:\n{tails}")
    ranks = [json.loads((PROCS_DIR / f"rank{r}.json").read_text()) for r in range(2)]

    # (1) the renders against the one-process (1, 2) mesh, bit for bit
    scene = bench_scene("cuda")
    mesh = make_mesh(MeshCfg(data_axis=1, tile_axis=2), device="cuda")
    rows = []
    for name, impl, config, per_shard, never in mesh_render_cases():
        want = {**{k: 1 for k in per_shard}, **{k: 0 for k in never}}
        with exact():
            img, grads, _ = render_on_mesh(scene, impl, config, mesh)
            ref = {"image": img.cpu(), **{k: g.cpu() for k, g in grads.items()}}
            img2, _, _ = render_on_mesh(scene, impl, config, mesh)
        ms = time_mesh_render(scene, impl, config, mesh)
        unequal, wrong = [], []
        for r, got in enumerate(ranks):
            saved = torch.load(PROCS_DIR / f"{name}_{r}.pt", weights_only=True)
            unequal += [(r, k) for k in ref if not torch.equal(saved[k], ref[k])]
            launches = got["renders"][name]["launches"]
            wrong += [(r, k, launches[k], n) for k, n in want.items() if launches[k] != n]
        row = dict(phase="procs_mesh", case=name, world_mesh={"data": 1, "tile": 2},
                   ranks=2, backend="gloo", launches_per_rank=want, wrong_launches=wrong,
                   bit_equal_to_one_process_mesh=not unequal, unequal=unequal,
                   one_process_repeat_bit_equal=bool(torch.equal(img, img2)),
                   ms_per_rank=[got["renders"][name]["ms"] for got in ranks],
                   one_process_mesh_ms=ms,
                   max_memory_allocated_bytes_per_rank=[
                       got["renders"][name]["max_memory_allocated_bytes"] for got in ranks])
        emit(row)
        rows.append(row)
        if unequal or wrong:
            raise AssertionError(f"procs_mesh {name}: {unequal} differ from the one-process "
                                 f"mesh render; launches (rank, kernel, got, want) {wrong}")
    del scene, img, img2, grads, ref
    gc.collect()
    torch.cuda.empty_cache()

    # (2) main: the ranks agree, and step 1 equals one process on their rows
    steps = [got["main_steps"] for got in ranks]
    hashes = [got["param_sha256"] for got in ranks]
    if len(steps[0]) != 2 or len(steps[1]) != 2 or hashes[0] != hashes[1] or len(hashes[0]) != 3:
        raise AssertionError(f"procs_mesh main: steps {[len(x) for x in steps]}, parameters "
                             f"per step {hashes}")
    argv = main_argv([MAIN_DATA / "pfchunk", MAIN_DATA / "torch"], 2, PROCS_DIR / "ckpt",
                     PROCS_DIR / "run", *PROCS_MAIN_EXTRA)
    cfg = load_config(argv[0], argv[1:])
    batches = [torch.load(PROCS_DIR / f"batch_{r}.pt", weights_only=True) for r in range(2)]
    batch = {part: {k: torch.cat([b[part][k] for b in batches]).cuda() for k in batches[0][part]}
             for part in ("context", "target")}
    torch.manual_seed(cfg.seed)
    model = port_main.build_model(cfg, "cuda")
    init = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    same_init = params_sha256(list(model.encoder.parameters())) == hashes[0][0]
    # Step 1 in this process on the two rows: each row alone, as its rank
    # takes it (b=1 through the rank's view of the (2, 1) world mesh, its
    # row of the global RANSAC draw), the gradients averaged: the
    # data-parallel step's own arithmetic without the exchange. A batch of 2
    # rounds differently under bf16 autocast (PERF.md section 7). The rows'
    # steps, after one untimed warm-up, give the one-process time.
    dev = torch.device("cuda", torch.cuda.current_device())
    grads, losses, row_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for r in (0, 0, 1):
        model.encoder.load_state_dict(init)
        view = Mesh({"data": 2, "tile": 1}, (dev,), owners=(0, 1), rank=r, tile_ranks=(r,),
                    data_ranks=(0, 1))
        gen = port_main.step_generator(cfg.seed, 0, "cuda")
        noise = model.ransac_noise(2, batch["context"]["image"].shape[1], gen)[r:r + 1]
        row = {part: {k: v[r:r + 1] for k, v in batch[part].items()} for part in batch}
        step_fn = train_mod.make_model_train_step(model, cfg.loss, cfg.optimizer, mesh=view)
        kept = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, aux = step_fn(init_train_state(model), row, ransac_noise=noise,
                         grad_sync=lambda g: kept.append([x.clone() for x in g]))
        loss = float(aux["loss"])
        row_ms.append((time.perf_counter() - t1) * 1e3)
        grads.append(kept[0])
        losses.append(loss)
    grads, losses, row_ms = grads[1:], losses[1:], row_ms[1:]  # the warm-up's dropped
    one_peak = torch.cuda.max_memory_allocated()
    mean_grads = [(a + b) / 2 for a, b in zip(*grads)]
    one = dict(loss=sum(losses) / 2, grad_norm=float(train_mod.global_norm(mean_grads)))
    two = dict(loss=(steps[0][0]["loss"] + steps[1][0]["loss"]) / 2,
               grad_norm=steps[0][0]["grad_norm"])
    rel = {k: abs(two[k] - one[k]) / abs(one[k]) for k in two}
    del grads, mean_grads, model, aux, step_fn, batch, init
    gc.collect()
    torch.cuda.empty_cache()
    ckpts = sorted(p.name for p in (PROCS_DIR / "ckpt" / "state").iterdir())
    log_rows = [json.loads(r) for r in (PROCS_DIR / "run" / "scalars.jsonl").read_text()
                .splitlines()]
    logged_loss_rel = abs(log_rows[0]["loss"] - two["loss"]) / abs(two["loss"])
    emit(dict(phase="procs_mesh", case="main", config="configs/re10k.yaml",
              world_mesh={"data": 2, "tile": 1}, ranks=2, backend="gloo", batch_per_rank=1,
              steps_per_rank=[[{k: v for k, v in r.items() if k != "launches"} for r in st]
                              for st in steps],
              launches_per_step_per_rank=[[r["launches"] for r in st] for st in steps],
              params_bit_equal_after_each_step=hashes[0] == hashes[1],
              one_process_same_init=same_init, step1_two_processes=two,
              step1_one_process_rows=one, step1_rel_diff=rel, tol=TOL_PROCS_STEP,
              one_process_row_step_ms=row_ms, one_process_rows_ms=sum(row_ms),
              one_process_max_memory_allocated_bytes=one_peak,
              checkpoints=ckpts, log_rows=len(log_rows), logged_loss_rel_diff=logged_loss_rel,
              log_printed_by=[got["logged"] for got in ranks], children_s=children_s))
    if not same_init or not all(v <= TOL_PROCS_STEP for v in rel.values()):
        raise AssertionError(f"procs_mesh main: step 1 over two processes {two} against one "
                             f"process {one}: {rel} > {TOL_PROCS_STEP} (same init: "
                             f"{same_init})")
    if ckpts != ["2"] or len(log_rows) != 2 or logged_loss_rel > 1e-6 or \
            [got["logged"] for got in ranks] != [True, False]:
        raise AssertionError(f"procs_mesh main: checkpoints {ckpts}, {len(log_rows)} log rows, "
                             f"logged loss off by {logged_loss_rel}, printed by "
                             f"{[got['logged'] for got in ranks]}")
    per_rank = {k: sum(got["renders"][name]["launches"][k] for name in got["renders"])
                for got in ranks[:1] for k in KERNEL_META}
    return dict(render=per_rank, main_step=steps[0][0]["launches"])


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
    if argv[:1] == ["--procs-child"]:
        return procs_child(int(argv[1]), argv[2], Path(argv[3]))
    LOG.unlink(missing_ok=True)

    from pf3plat_tpu_torch import kernels, precision
    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig
    from pf3plat_tpu_torch.parallel import MeshCfg, make_mesh
    from pf3plat_tpu_torch.precision import exact

    # The declared policy, as every entry point sets it: the timing phases
    # run under it; kernel gates and parity comparisons under exact().
    precision.apply_policy(torch.device("cuda"))

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
              cuda=torch.version.cuda, kernel_build_s=build["seconds"], ptxas=ptxas,
              policy=dict(tf32=precision.TF32,
                          cuda_matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)))
    emit(env_inventory())
    if "--main" in argv:
        # the training entry point alone: the train phase's launches per
        # step (one streamed step of record), main_train, main_test
        _, launches, _, _ = train("streamed")
        main_train({k: n // 2 for k, n in launches.items()})
        torch.cuda.empty_cache()
        main_test(None)
        print(smi, flush=True)
        return 0

    if "--procs" in argv:
        # the multi-process phase alone
        procs_mesh()
        print(smi, flush=True)
        return 0

    if "--memory" in argv:
        # the memory and precision policy alone
        memory_policy()
        print(smi, flush=True)
        return 0

    if "--precision" in argv:
        # the precision rules alone
        precision_phase()
        print(smi, flush=True)
        return 0

    if "--pose" in argv:
        # the pose path alone, then the index generator's pair search
        pose_path()
        index_pairs()
        print(smi, flush=True)
        return 0

    if "--adam" in argv:
        adam_phase()
        print(smi, flush=True)
        return 0

    config = PRODUCTION_CONFIG
    shape = (256, 256)
    scene = bench_scene("cuda")
    with exact():
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
    adam_phase()

    if "--kernels" in argv:
        return 0

    with exact():
        for impl in ("streamed", "pallas"):
            render_fwd_bwd(scene, config, impl)
        # a tile whose pixel count is no multiple of 32 (idle lanes in B2,
        # B3, B6 and B7)
        for impl in ("streamed", "pallas"):
            render_fwd_bwd(scene, dataclasses.replace(config, tile_size=12), impl, "tile12")
        mesh_render(scene, make_mesh(MeshCfg(data_axis=1, tile_axis=4), device="cuda"))
    del scene

    # Serving: the same request (same seeds, so the same gaussians) through
    # both decoders.
    captured, serve_launches, image = serve("streamed", timed_shapes=serve_shapes)
    serve_per_request = {k: n // 3 for k, n in serve_launches.items()}
    torch.cuda.empty_cache()
    with exact():
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
    precision_phase()
    torch.cuda.empty_cache()
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
    # exact-expansion step, step 1 from the same parameters and step 2 from
    # the unsharded step 1's state; with the production config it takes the
    # shard-local pipeline (B1-B4 once per shard). The two sides differ in
    # shape, so the comparison runs under exact().
    mesh = make_mesh(MeshCfg(data_axis=2, tile_axis=2), device="cuda")
    shared = {}
    with exact():
        _, _, trace_s, _ = train("streamed", 1, raster=RasterizeConfig(), shared=shared)
        _, launches_m, trace_m, _ = train("streamed", 1, raster=RasterizeConfig(), mesh=mesh,
                                          shared=shared)
        # The unsharded step once more, two steps in turn, for its own
        # run-to-run spread beside the gate (information: the encoder's
        # backward is not bit-reproducible, and Adam's first step turns
        # that into gradient-norm differences at step 2).
        _, _, trace_s2, _ = train("streamed", 1, raster=RasterizeConfig())
    worst = max(abs(a[k] - c[k]) / abs(c[k]) for a, c in zip(trace_m, trace_s)
                for k in ("loss", "grad_norm"))
    moment = shared["first_moment_rel"]
    rerun = max(abs(a[k] - c[k]) / abs(c[k]) for a, c in zip(trace_s2, trace_s)
                for k in ("loss", "grad_norm"))
    del shared
    emit(dict(phase="train_mesh_vs_unsharded", sharded=trace_m, unsharded=trace_s,
              max_rel_diff=worst, first_moment_max_rel_diff=moment, tol=TOL_TRAIN_MESH,
              step2_from="the unsharded step 1's state", unsharded_rerun_in_turn=trace_s2,
              unsharded_rerun_max_rel_diff=rerun))
    if not (worst <= TOL_TRAIN_MESH and moment <= TOL_TRAIN_MESH):
        raise AssertionError(f"train_mesh: sharded (B5 path) vs unsharded loss / grad_norm "
                             f"differ by {worst}, gradients by {moment} > {TOL_TRAIN_MESH}")
    launches["composite_bwd_blocks"] = launches_m["composite_bwd_blocks"]
    train("streamed", 1, mesh=mesh)
    with exact():
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
    zero_match_ms = train_frozen()
    torch.cuda.empty_cache()
    pose_path(zero_match_ms)
    torch.cuda.empty_cache()
    memory_policy()

    # The training entry point at full width, its resume, the serving entry
    # point restored from it, then the same entry point over two processes.
    main_per_step = main_train(train_per_step)
    torch.cuda.empty_cache()
    main_test_per_request = main_test(serve_per_request)
    torch.cuda.empty_cache()
    procs_per_rank = procs_mesh()
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
                         launches_procs_render_per_rank=procs_per_rank["render"][name],
                         launches_procs_main_step_per_rank=procs_per_rank["main_step"][name],
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
