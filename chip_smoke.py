#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (pf3plat_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only (quick)

Phases, each printing one JSON line; any failure exits non-zero:

  1. device  - GPU name and power limit (nvidia-smi), kernel build time;
  2. b1/b2   - the hand-written kernels (compact_pairs = B1,
               composite_fwd = B2) against their plain PyTorch versions on
               bench.py's scene (2 views, 131,072 gaussians);
  3. serve   - the full-width RE10K serving request (b=1, v=5, 256x256,
               ViT-L UniDepth, 1024 keypoints, 9 LightGlue layers, 128 depth
               candidates, SH degree 4, production rasterizer config), random
               weights from a seed: a warm-up, then 3 timed requests with the
               launch counters zeroed just before and read just after;
  4. b1/b2 on the serving request's own projected gaussians (the shapes of
     the main path), and a reference check: the served view rendered on the
     CPU through the plain versions agrees with the card;
  5. the kernels line, the nvidia-smi line, and the final
     {"ok": true, "device": ...} line.

It imports nothing of JAX. Without CUDA, or outside a checkout of the
repository, it fails before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
TOL_B2 = 1e-5
# Published H100 peaks (NVIDIA data sheet; SXM part, PCIe part).
PEAKS = {"sxm": dict(bw=3.35e12, fp32=67e12), "pcie": dict(bw=2.0e12, fp32=51e12)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def check_b1(screen, image_shape, config, tag: str) -> dict:
    """Kernel B1 vs its plain version, bit for bit; times and bound."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import compact

    b, n = screen.depth.shape
    cand = compact.build_candidates(screen, image_shape, config)
    budget = compact.pairs_budget(config, b, n)
    window = config.compact_window
    got = compact.compact_candidates_cuda(cand, budget, window)
    ref = compact.compact_candidates_plain(cand, budget, window)
    torch.cuda.synchronize()
    for key in ("tile", "dkey", "ids", "counts"):
        if not torch.equal(got[key], ref[key]):
            raise AssertionError(f"B1 {tag}: {key} differs from the plain version")
    if not torch.equal(got["feats"].view(torch.int32), ref["feats"].view(torch.int32)):
        raise AssertionError(f"B1 {tag}: features differ from the plain version")
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
    row = dict(phase=f"b1_{tag}", max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes",
               candidates=n_cand, written=written, total=total, budget=budget)
    emit(row)
    return row


def check_b2(screen, image_shape, background, config, tag: str) -> dict:
    """Kernel B2 vs its plain version on the same sorted inputs."""
    import torch

    from pf3plat_tpu_torch.ops.rasterizer import streamed

    args, _ = streamed.prepare_streamed(screen, image_shape, background, config)
    got = streamed.composite_fwd_cuda(**args)
    ref = streamed.composite_fwd_plain(**args)
    errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
    if not all(math.isfinite(e) and e <= TOL_B2 for e in errs):
        raise AssertionError(f"B2 {tag}: max abs err (img, tfin, tchk) {errs} > {TOL_B2}")
    rows = args["base"].shape[0]
    pairs = int(args["counts"].sum())
    evaluations = 256 * pairs
    ms = cuda_ms(lambda: streamed.composite_fwd_cuda(**args), 20)
    plain_ms = cuda_ms(lambda: streamed.composite_fwd_plain(**args), 3, warmup=1)
    n_chunks = config.tile_capacity // config.chunk + 1
    moved = pairs * 36 + rows * (4 * 4 + 12) + rows * 256 * 4 * (3 + 1 + n_chunks)
    ops = evaluations * 23  # ~20 FP32 ops + 3 SFU ops (exp, log1p, exp) per evaluation
    pk = peaks()
    t_bytes, t_ops = moved / pk["bw"] * 1e3, ops / pk["fp32"] * 1e3
    row = dict(phase=f"b2_{tag}", max_abs_err=max(errs), err_img=errs[0], err_tfin=errs[1],
               err_tchk=errs[2], ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_bytes, t_ops), bound_by="operations" if t_ops >= t_bytes else "bytes",
               tile_rows=rows, pairs_in_segments=pairs, evaluations=evaluations)
    emit(row)
    return row


def serve_config():
    from pf3plat_tpu_torch.models.backbones.unidepth import UniDepthCfg
    from pf3plat_tpu_torch.models.decoder import DecoderCfg
    from pf3plat_tpu_torch.models.encoder import EncoderCfg
    from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
    from pf3plat_tpu_torch.models.pf3plat import PF3platCfg

    # configs/re10k_test.yaml through main.build_model: EncoderCfg() with
    # 128 depth candidates and SH degree 4, DecoderCfg() (streamed,
    # production rasterizer config), UniDepthCfg() = ViT-L/14.
    return PF3platCfg(
        encoder=EncoderCfg(num_depth_candidates=128,
                           gaussian_adapter=GaussianAdapterCfg(sh_degree=4)),
        decoder=DecoderCfg(), unidepth=UniDepthCfg(),
        max_keypoints=1024, max_matches=512, lightglue_layers=9,
    )


def serve(n_requests: int = 3):
    import numpy as np
    import torch

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.ops.rasterizer import kernels

    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    model = PF3plat(serve_config(), device="cuda")
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
        return model(images, intr, near, far, 0, generator=gen, timer=timer)

    warm = request()  # warm-up: allocator, cuBLAS/cuDNN plans, kernel load
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
    for name, count in launches.items():
        if count < n_requests:
            raise AssertionError(f"serve: kernel {name} launched {count} times in "
                                 f"{n_requests} requests")
    emit(dict(phase="serve", model_build_s=build_s, requests=per_request,
              max_memory_allocated_bytes=peak, launches=launches,
              matches_valid=int(enc.correspondences.valid.sum()),
              color_mean=float(out.color.mean())))
    return warm, launches


def serving_scene(warm):
    """The decoder's render inputs for the served request (decode + render)."""
    import torch

    enc, _ = warm
    g = enc.gaussians
    v = enc.refined_poses.shape[1]
    c2w = torch.linalg.inv(enc.refined_poses)[0]
    intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device="cuda").expand(v, 3, 3)
    rep = lambda x: x.repeat_interleave(v, dim=0)  # noqa: E731
    return dict(extrinsics=c2w, intrinsics=intr, near=torch.ones(v, device="cuda"),
                means=rep(g.means), covariances=rep(g.covariances), sh=rep(g.harmonics),
                opacities=rep(g.opacities), background=torch.zeros((v, 3), device="cuda"))


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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "pf3plat_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pf3plat_tpu_torch.models.decoder import PRODUCTION_CONFIG
    from pf3plat_tpu_torch.ops.rasterizer import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    build = kernels.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in build["ptxas"].items()}
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, kernel_build_s=build["seconds"], ptxas=ptxas))

    config = PRODUCTION_CONFIG
    scene = bench_scene("cuda")
    screen = project(scene, (256, 256), config)
    check_b1(screen, (256, 256), config, "bench")
    check_b2(screen, (256, 256), scene["background"], config, "bench")
    del scene, screen

    if "--kernels" in argv:
        return 0

    warm, launches = serve()
    scene = serving_scene(warm)
    screen = project(scene, (256, 256), config)
    rows = {
        "compact_pairs": check_b1(screen, (256, 256), config, "serve"),
        "composite_fwd": check_b2(screen, (256, 256), scene["background"], config, "serve"),
    }
    reference_check(scene, config)

    meta = {
        "compact_pairs": ("pf3plat_tpu_torch/csrc/compact_pairs.cu",
                          "pf3plat_tpu/ops/rasterizer/compact.py:87"),
        "composite_fwd": ("pf3plat_tpu_torch/csrc/composite_fwd.cu",
                          "pf3plat_tpu/ops/rasterizer/streamed.py:365"),
    }
    line = []
    for name, (src, replaces) in meta.items():
        r = rows[name]
        line.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                         launches=launches[name], max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"]))
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
