"""VGGT on the port (`models/vggt.py`) against the plain float32 reference
(`tests/vggt_reference.py`) on seeded weights at a tiny size: width 64, 2
frame/global pairs of 4 heads, a 2-block patch embedding, 3 frames at 28 x
42 (2 x 3 patches and 5 special tokens a frame). The benchmark's copy of
the reference is held to it bit for bit; DINOv2 with registers against the
reference's, and at its defaults (UniDepth's) bit for bit against the
benchmark's copy of it; the entry point builds VGGT and refuses to train
it; the spans and counters under a profiler.

The aggregator's LayerScale is drawn at 1.0 here, not the published 0.01:
at 0.01 the global blocks add about a hundredth to the residual stream, and
a global attention confined to each frame moves the depth maps by ~1e-6,
about what rounding moves them; at 1.0 it moves every compared output by
4 to 30 times its tolerance.

Tolerances: the port's attention on the CPU rounds q, k, v and the
probabilities to bf16 (`layers.mxu_attention`, what the card's bf16 SDPA
does), the reference keeps float32, and everything else is float32 on both
sides. That rounding moves the hooked tokens by <= 1.5e-3, the pose passes
by <= 3e-3, the points by <= 1.1e-5 and depth and the confidences by <=
1.1e-6 (relative, three input seeds); each tolerance is several times that,
and each compared output moves beyond its tolerance when the test confines
the global attention to each frame or leaves out the q/k LayerNorm."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch

import vggt_reference as ref_module
from pf3bench.loops.vggt_serve import frame_only
from pf3plat_tpu_torch.models import vggt as vggt_module
from pf3plat_tpu_torch.models.backbones import dinov2 as port_dinov2
from pf3plat_tpu_torch.models.vggt import VGGT, VGGTCfg, token_positions
from pf3plat_tpu_torch.utils import profiling
from test_torch_helpers import one_thread  # noqa: F401

TINY = dict(img_size=56, embed_dim=64, patch_embed_depth=2, depth=2, num_heads=4,
            hooks=(0, 1, 1, 1), camera_num_heads=4, dpt_features=16,
            dpt_out_channels=(8, 16, 32, 32), frames_chunk_size=2, init_values=1.0)
S, H, W = 3, 28, 42
P = 5 + (H // 14) * (W // 14)  # a frame's tokens
# relative gaps (each output's norm), bf16 attention reads well below them
TOL = {"tokens": 1e-2, "poses": 2e-2, "depth": 2e-5, "depth_conf": 2e-5, "points": 2e-4,
       "points_conf": 2e-5}


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    ref = ref_module.VGGT(ref_module.VGGTCfg(**TINY))
    port = VGGT(VGGTCfg(**TINY), device="cpu")
    port.load_state_dict(ref.state_dict())
    return port, ref


def _images(seed: int) -> torch.Tensor:
    return torch.rand(1, S, H, W, 3, generator=torch.Generator().manual_seed(seed))


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _gaps(got, want) -> dict:
    return {"tokens": max(_rel(a, b) for a, b in zip(got.tokens, want["tokens"])),
            "poses": max(_rel(a, b) for a, b in zip(got.pose_enc_list, want["poses"])),
            "depth": _rel(got.depth, want["depth"]),
            "depth_conf": _rel(got.depth_conf, want["depth_conf"]),
            "points": _rel(got.world_points, want["points"]),
            "points_conf": _rel(got.world_points_conf, want["points_conf"])}


@contextlib.contextmanager
def no_qk_norm(model: VGGT):
    attns = [blk.attn for blocks in (model.aggregator.frame_blocks,
                                     model.aggregator.global_blocks) for blk in blocks]
    kept = [(a.q_norm, a.k_norm) for a in attns]
    for a in attns:
        a.q_norm = a.k_norm = None
    try:
        yield
    finally:
        for a, (q, k) in zip(attns, kept):
            a.q_norm, a.k_norm = q, k


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_outputs_match_the_reference(models, seed):
    port, ref = models
    images = _images(seed)
    with torch.no_grad():
        got, want = port(images), ref(images)
    assert len(got.pose_enc_list) == 4 and got.depth.shape == (1, S, H, W, 1)
    assert got.world_points.shape == (1, S, H, W, 3) and got.tokens[0].shape == (1, S, P, 128)
    gaps = _gaps(got, want)
    assert all(gaps[k] < TOL[k] for k in TOL), gaps
    passes = [_rel(a, b) for a, b in zip(got.pose_enc_list, want["poses"])]
    assert max(passes) < TOL["poses"], passes


@pytest.mark.parametrize("fault", ["frame_only", "no_qk_norm"])
def test_every_comparison_fails_on_a_planted_fault(models, fault):
    port, ref = models
    images = _images(1)
    planted = frame_only(port, S) if fault == "frame_only" else no_qk_norm(port)
    with torch.no_grad():
        with planted:
            got = port(images)
        want = ref(images)
    gaps = _gaps(got, want)
    assert all(gaps[k] > TOL[k] for k in TOL), gaps
    passes = [_rel(a, b) for a, b in zip(got.pose_enc_list, want["poses"])]
    assert min(passes) > TOL["poses"], passes


def test_patch_embedding_with_registers_matches_the_reference(models):
    """DINOv2 with 4 registers and the position table resized with
    antialiasing (4 x 4 to 2 x 3 here): its patch tokens against the
    reference's (bf16 attention reads 1.0e-3); without antialiasing they
    differ by more than the tolerance."""
    port, ref = models
    frames = _images(4)[0]
    with torch.no_grad():
        got = port.aggregator.patch_embed(frames)[0][0]
        want = ref.aggregator.patch_embed(frames.permute(0, 3, 1, 2))
        assert _rel(got.flatten(1, 2), want) < 5e-3
        cfg = port.aggregator.patch_embed.cfg
        plain = port_dinov2.DINOv2(
            port_dinov2.ViTCfg(**{**cfg.__dict__, "interpolate_antialias": False}),
            out_layers=port.aggregator.patch_embed.out_layers)
        plain.load_state_dict(port.aggregator.patch_embed.state_dict())
        assert _rel(plain(frames)[0][0].flatten(1, 2), want) > 5e-3


def test_dinov2_at_its_defaults_is_unidepths(monkeypatch):
    """No registers, no antialiasing: the port's DINOv2 gives UniDepth's
    backbone bit for bit, against the benchmark's copy of it (its check of
    UniDepth) with the same float32 attention on both sides."""
    from pf3bench.reference.models import layers as bench_layers
    from pf3bench.reference.models.backbones import dinov2 as bench_dinov2

    monkeypatch.setattr(port_dinov2, "attention", bench_layers.attention)
    torch.manual_seed(5)
    cfg = port_dinov2.ViTCfg.tiny_test()
    port = port_dinov2.DINOv2(cfg, out_layers=(1, 3))
    bench = bench_dinov2.DINOv2(bench_dinov2.ViTCfg.tiny_test(), out_layers=(1, 3))
    bench.load_state_dict(port.state_dict())
    assert port.register_tokens is None
    image = torch.rand(2, 42, 56, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        for got, want in zip(port(image), bench(image)):
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rope_positions():
    """The special tokens at (0, 0), each patch at (row + 1, column + 1),
    as the reference places them."""
    pos = token_positions(2, 3, 5, "cpu")
    assert pos[:5].tolist() == [[0, 0]] * 5
    assert pos[5:].tolist() == [[y + 1, x + 1] for y in range(2) for x in range(3)]
    assert torch.equal(pos, ref_module.positions(2, 3, 5, "cpu"))


def test_benchmark_reference_copy_is_bit_identical(models):
    from pf3bench.reference.models import vggt as bench_ref

    _, ref = models
    copy = bench_ref.VGGT(bench_ref.VGGTCfg(**TINY))
    copy.load_state_dict(ref.state_dict())
    images = _images(7)
    with torch.no_grad():
        a, b = copy(images), ref(images)
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(*((v if isinstance(v, list) else [v]) for v in (a[k], b[k]))):
            assert torch.equal(x, y), k


def test_entry_point_builds_vggt_and_refuses_to_train_it(tmp_path):
    from pf3plat_tpu_torch import main as tmain
    from pf3plat_tpu_torch.utils.config import load_config

    tiny = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    cfg = load_config(None, ['model.architecture="vggt"', f"vggt={json.dumps(tiny)}"])
    model = tmain.build_model(cfg, "cpu")
    assert type(model) is VGGT and model.cfg == VGGTCfg(**TINY)
    assert load_config(None, []).vggt == VGGTCfg()
    with pytest.raises(ValueError, match="served through its forward"):
        tmain.train_step_for(cfg, model)
    for mode in ("train", "test"):
        with pytest.raises(ValueError, match="served through its forward"):
            tmain.main([f'mode="{mode}"', 'model.architecture="vggt"',
                        f'dataset.roots=["{tmp_path}"]'], device="cpu")


def test_spans_and_counters(models, tmp_path, one_thread):
    """One forward under a profiler: `pf3.forward` holds the four stages
    under `pf3.vggt.`, the timer sees them in order, and the counters give
    the frames, each global call's tokens and the camera passes."""
    port, _ = models
    seen = []
    with profiling.trace(tmp_path, window="w"):
        with torch.no_grad():
            port(_images(8), timer=seen.append)
    (path,) = tmp_path.glob("*.pt.trace.json")
    trace = json.loads(path.read_text())
    names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    stages = ["patch", "aggregator", "camera", "dpt"]
    assert seen == stages
    assert {"pf3.forward", *(vggt_module.VGGT_SPAN + s for s in stages)} <= names
    counters = trace[profiling.COUNTERS]
    assert counters == {"forwards": 1, "vggt.frames": S, "vggt.camera_passes": 4,
                        "vggt.global_tokens": TINY["depth"] * S * P}
