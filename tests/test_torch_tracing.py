"""The port's spans and counters (`utils/profiling.py`: `span`, `stage`,
`count`) on the CPU: nothing recorded and no `record_function` called
while no profiler session records; under `torch.profiler`, a tiny forward
and a tiny train step emit the stage tree as nested ranges, the `timer`
callback sees the same names in the same order, and the counters land in
the trace's metadata under `pf3plat_counters`."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pf3plat_tpu_torch import main as tmain
from pf3plat_tpu_torch.models.backbones.unidepth import UniDepthCfg
from pf3plat_tpu_torch.models.decoder import DecoderCfg
from pf3plat_tpu_torch.models.encoder import EncoderCfg
from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
from pf3plat_tpu_torch.models.pf3plat import PF3plat, PF3platCfg
from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig
from pf3plat_tpu_torch.ops.rasterizer.api import render
from pf3plat_tpu_torch.ops.rasterizer.compact import compact_pairs
from pf3plat_tpu_torch.ops.rasterizer.project import make_camera, project_gaussians
from pf3plat_tpu_torch.training import train
from pf3plat_tpu_torch.training.losses import LossCfg
from pf3plat_tpu_torch.utils import profiling
from pf3plat_tpu_torch.utils.config import load_config

from test_data import make_chunk
from test_torch_helpers import make_scene_np, one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
B, V, H, W = 1, 3, 32, 32
ENC = dict(
    d_feature=32, d_backbone=128, num_depth_candidates=16, multiview_trans_attn_split=2,
    n_attn_layers=2, d_pose=32, pose_heads=4, ransac_samples=32,
    costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
    costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
    depth_unet_channel_mult=(1, 1, 1),
)
TOP = dict(max_keypoints=64, max_matches=32, lightglue_layers=2)

# (range, the range that encloses it) of one forward, as listed in
# `utils/profiling.py`'s span tree
FORWARD_TREE = {
    ("pf3.forward", None),
    ("pf3.perceive", "pf3.forward"),
    ("pf3.perceive.unidepth", "pf3.perceive"),
    ("pf3.perceive.superpoint", "pf3.perceive"),
    ("pf3.perceive.lightglue", "pf3.perceive"),
    ("pf3.encoder", "pf3.forward"),
    ("pf3.encoder.pose", "pf3.encoder"),
    ("pf3.encoder.ransac", "pf3.encoder.pose"),
    ("pf3.encoder.sync", "pf3.encoder.pose"),
    ("pf3.encoder.refine", "pf3.encoder"),
    ("pf3.encoder.costvolume", "pf3.encoder"),
    ("pf3.encoder.adapter", "pf3.encoder"),
    ("pf3.decoder", "pf3.forward"),
    ("pf3.decoder.project", "pf3.decoder"),
    ("pf3.decoder.compact", "pf3.decoder"),
    ("pf3.decoder.sort", "pf3.decoder"),
    ("pf3.decoder.composite", "pf3.decoder"),
}
STEP_TREE = (FORWARD_TREE - {("pf3.forward", None)}) | {
    ("pf3.train_step", None),
    ("pf3.forward", "pf3.train_step"),
    ("pf3.loss", "pf3.train_step"),
    ("pf3.backward", "pf3.train_step"),
    ("pf3.optimizer", "pf3.train_step"),
}


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    cfg = PF3platCfg(
        encoder=EncoderCfg(**ENC, gaussian_adapter=GaussianAdapterCfg(sh_degree=1)),
        decoder=DecoderCfg(raster=RasterizeConfig(pairs_budget_factor=0.6,
                                                  compact_min_pairs=0)),
        unidepth=UniDepthCfg.tiny_test(), frozen_matmul_precision="highest", **TOP)
    return PF3plat(cfg, device="cpu")


def _inputs():
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = np.stack([np.sin(7 * xx + 3 * yy), np.cos(5 * yy - 2 * xx), np.sin(4 * xx * yy)], -1)
    images = np.stack([
        np.clip(0.5 + 0.4 * np.roll(base, 2 * k, axis=1) + 0.05 * rng.standard_normal(base.shape),
                0, 1) for k in range(V)])[None].astype(np.float32)
    intr = np.broadcast_to(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]),
                           (B, V, 3, 3)).astype(np.float32)
    return (t(images), t(intr), torch.ones((B, V)), torch.full((B, V), 100.0))


def _batch():
    images, intr, near, far = _inputs()
    return dict(context=dict(image=images, intrinsics=intr, near=near, far=far),
                target=dict(image=images))


def _forward(model, timer=None):
    with torch.no_grad():
        return model(*_inputs(), 0, generator=torch.Generator().manual_seed(1), timer=timer)


def _model_step(model, timer=None):
    step = train.make_model_train_step(model, LossCfg(), train.OptimizerCfg())
    return step(train.init_train_state(model), _batch(),
                generator=torch.Generator().manual_seed(1), timer=timer)


def _frozen_step(model, timer=None):
    """`make_train_step` on the model's own perception outputs."""
    images, intr, near, far = _inputs()
    frozen, corr = model.perceive(images, intr)
    step = train.make_train_step(model.encoder, model.cfg.decoder, LossCfg(),
                                 train.make_optimizer(train.OptimizerCfg()), (H, W),
                                 lpips_apply=model.lpips_apply)
    batch = dict(_batch(), frozen=frozen, corr=corr)
    return step(train.init_train_state(model), batch, generator=torch.Generator().manual_seed(1),
                timer=timer)


def _traced(tmp_path, fn):
    """Run `fn()` under `profiling.trace`; the trace file's JSON."""
    with profiling.trace(tmp_path, window="w"):
        fn()
    (path,) = tmp_path.glob("*.pt.trace.json")
    return json.loads(path.read_text())


def _tree(trace: dict) -> set:
    """(range, innermost pf3.* range enclosing it on its thread) of every
    pf3.* range of the trace."""
    ranges = sorted(
        ((float(e["ts"]), -(float(e["ts"]) + float(e["dur"])), e["name"], e.get("tid"))
         for e in trace["traceEvents"] if e.get("ph") == "X"
         and e.get("cat") == "user_annotation" and e["name"].startswith("pf3.")))
    edges, stacks = set(), {}
    for start, neg_end, name, tid in ranges:
        stack = stacks.setdefault(tid, [])
        while stack and stack[-1][1] < start:
            stack.pop()
        edges.add((name, stack[-1][0] if stack else None))
        stack.append((name, -neg_end))
    return edges


def test_off_span_is_the_shared_null_and_count_records_nothing(model, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling._TRACER.reset()
    assert not profiling.tracing()
    assert profiling.span("pf3.forward") is profiling.NULL
    assert profiling.stage("perceive") is profiling.NULL
    profiling.count("forwards", 1)
    enc, out = _forward(model)
    assert out.color.shape == (B, V, H, W, 3)
    assert profiling._TRACER.totals == {}


@pytest.mark.parametrize("kind,names", [
    ("forward", ["perceive", "encoder", "decoder"]),
    ("model_step", ["perceive", "encoder", "decoder", "loss", "backward", "optimizer"]),
    ("frozen_step", ["encoder", "decoder", "loss", "backward", "optimizer"]),
])
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_timer_names_in_order(model, tmp_path, kind, names, traced):
    """The `timer` callback sees the stage names it saw before the stages
    became spans, once each and in order, with or without a session;
    traced, each call falls inside its stage's range."""
    fn = {"forward": _forward, "model_step": _model_step, "frozen_step": _frozen_step}[kind]
    seen, inside = [], []

    def timer(name):
        seen.append(name)
        inside.append(profiling.tracing())

    if traced:
        _traced(tmp_path, lambda: fn(model, timer))
    else:
        fn(model, timer)
    assert seen == names
    assert inside == [traced] * len(names)


def test_forward_span_tree(model, tmp_path):
    assert _tree(_traced(tmp_path, lambda: _forward(model))) == FORWARD_TREE


def test_model_train_step_span_tree(model, tmp_path):
    assert _tree(_traced(tmp_path, lambda: _model_step(model))) == STEP_TREE


def test_counters_in_the_metadata(model, tmp_path):
    """One forward: its matches, LightGlue's calls (one a view pair, each
    on the stacked sides) and B1's pairs, folded once the forward's range
    closed; a second session counts from zero."""
    got = []

    def run():
        _, out = _forward(model)
        got.append(out)

    for k in range(2):
        counters = _traced(tmp_path / str(k), run)[profiling.COUNTERS]
        assert counters["forwards"] == 1
        assert counters["matches.slots"] == B * V * (V - 1) // 2 * TOP["max_matches"]
        assert counters["lightglue.calls"] == B * V * (V - 1) // 2
        assert counters["lightglue.stacked_calls"] == counters["lightglue.calls"]
        assert 0 <= counters["matches.valid"] <= counters["matches.slots"]
        assert counters["raster.pairs_budget"] > 0
        assert 0 < counters["raster.pairs_written"] <= counters["raster.pairs_wanted"]
        if k:
            assert counters == first
        first = counters


@pytest.mark.parametrize("factor,overflows", [(1.0, False), (512 / (2 * 400 * 4), True)],
                         ids=["fits", "overflows"])
def test_raster_pairs_are_b1s_counts(tmp_path, factor, overflows):
    """`raster.pairs_wanted` / `_written` / `_budget` are B1's `total`,
    `written` and `budget` of the render, on a scene that fits its budget
    and on one that overflows it."""
    shape = (48, 64)
    cfg = RasterizeConfig(pairs_budget_factor=factor, compact_window=512, compact_min_pairs=0,
                          tight_cull=False)
    scene = {k: t(v) for k, v in make_scene_np(np.random.default_rng(22), n=400, b=2).items()}
    counters = _traced(tmp_path, lambda: render(
        scene["extrinsics"], scene["intrinsics"], scene["near"], scene["far"], shape,
        scene["background"], scene["means"], scene["covariances"], scene["sh"],
        scene["opacities"], config=cfg, device="cpu"))[profiling.COUNTERS]
    screen = project_gaussians(make_camera(scene["extrinsics"], scene["intrinsics"], shape),
                               scene["means"], scene["covariances"], scene["opacities"],
                               scene["sh"], 4, cfg)
    b1 = compact_pairs(screen, shape, cfg)
    assert counters == {"raster.pairs_wanted": int(b1["total"]),
                        "raster.pairs_written": int(b1["written"]),
                        "raster.pairs_budget": b1["budget"]}
    assert (counters["raster.pairs_wanted"] > counters["raster.pairs_written"]) == overflows


def test_data_spans_wait_and_collate_between_yields(tmp_path):
    """`batch_iterator` waits on the pipeline in `pf3.data.wait` ranges and
    stacks a batch in `pf3.data.collate` ranges, each inside a call of
    `next` on the iterator: none stays open across a `yield`."""
    (tmp_path / "data" / "train").mkdir(parents=True)
    make_chunk(tmp_path / "data" / "train" / "000000.torch", n_scenes=2, n_frames=20, seed=3)
    cfg = load_config(CONFIG_DIR / "smoke.yaml", [
        f'dataset.roots=["{tmp_path / "data"}"]', "data_loader.num_workers=1",
        "view_sampler.min_distance_to_context_views=1"])

    def run():
        it = tmain.batch_iterator(cfg, "train", 0, 1, lambda: 0, batch_size=2)
        for _ in range(2):
            with torch.profiler.record_function("next"):
                next(it)
            with torch.profiler.record_function("between"):
                pass
        it.close()

    trace = _traced(tmp_path / "trace", run)
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"
          and e.get("cat") == "user_annotation"]
    calls = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ev
             if e["name"] == "next"]
    data = [e for e in ev if e["name"].startswith("pf3.data.")]
    assert {e["name"] for e in data} == {"pf3.data.wait", "pf3.data.collate"}
    assert sum(e["name"] == "pf3.data.collate" for e in data) == 2
    for e in data:
        s, d = float(e["ts"]), float(e["dur"])
        assert any(a <= s and s + d <= b for a, b in calls), e["name"]
