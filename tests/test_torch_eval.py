"""Parity of the port's evaluation slice with the JAX package, on the CPU:
the geometry remainder (projection, `plucker_embedding`, epipolar overlap),
the index generator, the evaluator's scoring and files, the benchmarker,
the metric computer, and `mode=test` end to end on the tiny config.

Mirrors tests/test_aux.py's overlap, index-generator, benchmarker and
metric-computer cases and tests/test_configs_eval.py's `mode=test` runs.
Tolerances are stated at each assertion: float32 geometry at atol 1e-6 /
rtol 1e-5; the evaluator's scores from the same model outputs at rtol
1e-5; the whole request at the model test's tolerances
(tests/test_torch_model.py), which give the PSNR and pose bounds stated in
`TestModeTest`.
"""

from __future__ import annotations

import copy
import json
import types
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pf3plat_tpu.evaluation import evaluator as jeval
from pf3plat_tpu.evaluation import index_generator as jindex
from pf3plat_tpu.evaluation import metric_computer as jmetric
from pf3plat_tpu.geometry import epipolar as jepi
from pf3plat_tpu.geometry import projection as jproj
from pf3plat_tpu.geometry import transforms as jtrans
from pf3plat_tpu.models.backbones.vgg_lpips import LPIPS as JLPIPS
from pf3plat_tpu.models.types import DecoderOutput as JDecoderOutput
from pf3plat_tpu.utils import benchmarker as jbench

from pf3plat_tpu_torch import main as tmain
from pf3plat_tpu_torch.evaluation import evaluator as teval
from pf3plat_tpu_torch.evaluation import index_generator as tindex
from pf3plat_tpu_torch.evaluation import metric_computer as tmetric
from pf3plat_tpu_torch.geometry import epipolar as tepi
from pf3plat_tpu_torch.geometry import projection as tproj
from pf3plat_tpu_torch.geometry import transforms as ttrans
from pf3plat_tpu_torch.models.backbones.vgg_lpips import LPIPS
from pf3plat_tpu_torch.models.types import DecoderOutput
from pf3plat_tpu_torch.utils import benchmarker as tbench
from pf3plat_tpu_torch.weights import flatten, load_flat

from test_configs_eval import TINY_OVERRIDES
from test_data import make_chunk
from test_torch_helpers import _no_tf32, jax_tree_from_port, n, one_thread, t  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_thread")
K = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], np.float32)


def _rigid(rng, k, angle=0.3, shift=0.5):
    """(k, 4, 4) random c2w matrices."""
    out = np.broadcast_to(np.eye(4, dtype=np.float32), (k, 4, 4)).copy()
    out[:, :3, :3] = Rotation.from_rotvec(angle * rng.standard_normal((k, 3))).as_matrix()
    out[:, :3, 3] = shift * rng.standard_normal((k, 3))
    return out


def _close(got, want, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(n(got), np.asarray(want), atol=atol, rtol=rtol)


class TestGeometry:
    def test_projection_functions(self):
        rng = np.random.default_rng(0)
        extr = _rigid(rng, 6)
        pts = rng.standard_normal((6, 9, 3)).astype(np.float32) * 2
        hom = np.concatenate([pts, np.ones((6, 9, 1), np.float32)], -1)
        e = extr[:, None]
        _close(tproj.transform_cam2world(t(hom), t(e)), jproj.transform_cam2world(hom, e))
        _close(tproj.transform_world2cam(t(hom), t(e)), jproj.transform_world2cam(hom, e))
        _close(tproj.project_camera_space(t(pts), t(K)), jproj.project_camera_space(pts, K))
        (xy, front), (jxy, jfront) = tproj.project(t(pts), t(e), t(K)), jproj.project(pts, e, K)
        _close(xy, jxy)
        np.testing.assert_array_equal(n(front), np.asarray(jfront))
        assert not n(front).all() and n(front).any()

    def test_intersect_rays_with_parallel_rows(self):
        rng = np.random.default_rng(1)
        ox, oy = (rng.standard_normal((2, 16, 3)).astype(np.float32) for _ in range(2))
        dx, dy = (rng.standard_normal((2, 16, 3)) for _ in range(2))
        dy[:, :3] = dx[:, :3]  # parallel rays
        dx, dy = (d / np.linalg.norm(d, axis=-1, keepdims=True) for d in (dx, dy))
        dx, dy = dx.astype(np.float32), dy.astype(np.float32)
        got = n(tproj.intersect_rays(t(ox), t(dx), t(oy), t(dy)))
        want = np.asarray(jproj.intersect_rays(ox, dx, oy, dy))
        assert (got[:, :3] == 1e10).all() and (want[:, :3] == 1e10).all()  # exactly inf
        # a least-squares solve of near-parallel pairs: relative to its size
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
        # broadcast against one origin
        _close(tproj.intersect_rays(t(ox[:1, :1]), t(dx), t(oy), t(dy)),
               jproj.intersect_rays(ox[:1, :1], dx, oy, dy), rtol=1e-4)

    def test_plucker_embedding(self):
        rng = np.random.default_rng(2)
        o, d = (rng.standard_normal((4, 5, 3)).astype(np.float32) for _ in range(2))
        _close(ttrans.plucker_embedding(t(o), t(d)), jtrans.plucker_embedding(o, d))

    def test_depth_samples_bit_equal_to_geomspace(self):
        """Bit-equal at the overlap's defaults; within a few float32 ulps
        elsewhere (XLA's own log and pow)."""
        want = np.asarray(jnp.geomspace(1.0, 100.0, 32, dtype=jnp.float32))
        np.testing.assert_array_equal(tepi.depth_samples(1.0, 100.0, 32), want)
        for near, far, k in ((0.5, 50.0, 32), (0.1, 1000.0, 64), (2.0, 30.0, 7)):
            np.testing.assert_allclose(
                tepi.depth_samples(near, far, k),
                np.asarray(jnp.geomspace(near, far, k, dtype=jnp.float32)), rtol=2e-6)

    def test_project_ray_samples(self):
        rng = np.random.default_rng(3)
        ea, eb = _rigid(rng, 2, angle=0.2)
        xy, _ = jproj.sample_image_grid((8, 8))
        o, d = jproj.get_world_rays(xy.reshape(-1, 2), ea, K)
        o, d = np.asarray(o), np.asarray(d)
        (gxy, gv), (wxy, wv) = (tepi.project_ray_samples(t(o), t(d), t(eb), t(K)),
                                jepi.project_ray_samples(o, d, eb, K))
        np.testing.assert_array_equal(n(gv), np.asarray(wv))
        assert n(gv).any() and not n(gv).all()
        _close(gxy, wxy, atol=1e-5)  # xy reach 1e8 scale at z ~ 0 (nan_to_num)

    def test_view_overlap(self):
        rng = np.random.default_rng(4)
        got, want = [], []
        for _ in range(12):
            ea, eb = _rigid(rng, 2, angle=0.4)
            got.append(float(tepi.view_overlap(t(ea), t(K), t(eb), t(K))))
            want.append(float(jepi.view_overlap(ea, K, eb, K)))
        assert got == want
        assert len(set(got)) > 4
        # tests/test_aux.py's cases: identical views overlap, opposite don't
        e = np.eye(4, dtype=np.float32)
        assert float(tepi.view_overlap(t(e), t(K), t(e), t(K))) > 0.99
        opp = e.copy()
        opp[:3, :3] = np.diag([-1.0, 1.0, -1.0])
        assert float(tepi.view_overlap(t(e), t(K), t(opp), t(K))) < 0.05


def _scene_poses():
    """Synthetic scenes {name: (c2w (n, 4, 4), intrinsics (n, 3, 3))}. The
    make_chunk camera (0.01 a frame along x) and chip_smoke.py's panned
    camera (0.02 a frame, fx 0.86, fy 1.53) overlap by more than 0.8 at
    every allowed distance (null entries), as do a still camera and a scene
    shorter than the minimum distance; yawing cameras (0.2 and 0.3 degrees
    a frame) and one moving forward (0.1 a frame) reach [0.6, 0.8]."""
    def scene(n, fx=0.9, fy=1.6, shift=0.0, yaw_deg=0.0, forward=0.0):
        c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
        c2w[:, 0, 3] = shift * np.arange(n)
        c2w[:, 2, 3] = forward * np.arange(n)
        c2w[:, :3, :3] = Rotation.from_euler("y", yaw_deg * np.arange(n)[:, None],
                                              degrees=True).as_matrix()
        intr = np.broadcast_to(np.array([[fx, 0, 0.5], [0, fy, 0.5], [0, 0, 1]], np.float32),
                               (n, 3, 3)).copy()
        return c2w, intr

    return {"chunk": scene(60, shift=0.01), "panned": scene(80, 0.86, 1.53, shift=0.02),
            "yaw_fast": scene(140, yaw_deg=0.3), "yaw_slow": scene(170, yaw_deg=0.2),
            "forward": scene(130, forward=0.1), "still": scene(50),
            "short": scene(30, shift=0.01)}


class TestIndexGenerator:
    def test_generate_index_matches_jax(self, tmp_path):
        scenes = _scene_poses()
        got = tindex.generate_index(tindex.IndexGeneratorCfg(output_path=tmp_path / "t.json"),
                                    scenes, seed=0, device="cpu")
        want = jindex.generate_index(jindex.IndexGeneratorCfg(output_path=tmp_path / "j.json"),
                                     scenes, seed=0)
        assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
        assert got == want
        assert any(v is None for v in got.values())
        assert [k for k, v in got.items() if v is not None] == ["yaw_fast", "yaw_slow",
                                                               "forward"]
        # a window no pair reaches gives null entries on both sides
        cfg = dict(min_overlap=1.5, max_overlap=2.0, min_distance=20)
        assert tindex.generate_index(
            tindex.IndexGeneratorCfg(output_path=tmp_path / "t2.json", **cfg), scenes,
            device="cpu") == jindex.generate_index(
            jindex.IndexGeneratorCfg(output_path=tmp_path / "j2.json", **cfg), scenes) == {
            k: None for k in scenes}

    def test_cli_roundtrip(self, tmp_path, capsys):
        (tmp_path / "test").mkdir()
        make_chunk(tmp_path / "test" / "000000.torch", n_scenes=2, n_frames=130, h=24, w=32,
                   seed=7)
        tindex.main([str(tmp_path), "--out", str(tmp_path / "t.json")], device="cpu")
        jindex.main([str(tmp_path), "--out", str(tmp_path / "j.json")])
        out = capsys.readouterr().out
        assert f"{tmp_path / 't.json'}: " in out
        assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
        assert len(json.loads((tmp_path / "t.json").read_text())) == 2


class _JEnc(NamedTuple):
    refined_poses: jax.Array


def _stub_outputs(rng, v=5, h=32, w=32):
    return dict(color=rng.uniform(0, 1, (1, v, h, w, 3)).astype(np.float32),
                depth=rng.uniform(1, 9, (1, v, h, w)).astype(np.float32),
                refined_poses=np.linalg.inv(_rigid(rng, v, angle=0.3))[None])


class _JStub:
    """Forward of the JAX evaluator: fixed outputs, whatever the inputs."""

    def __init__(self, o):
        self.o = o

    def forward(self, params, images, intr, near, far, step, rng, depth_mode=None):
        depth = jnp.asarray(self.o["depth"]) if depth_mode is not None else None
        return _JEnc(jnp.asarray(self.o["refined_poses"])), JDecoderOutput(
            jnp.asarray(self.o["color"]), depth)


class _TStub:
    """The same outputs for the port's evaluator."""

    def __init__(self, o):
        self.o = o

    def __call__(self, images, intr, near, far, global_step=0, depth_mode=None,
                 generator=None):
        enc = types.SimpleNamespace(refined_poses=t(self.o["refined_poses"]))
        depth = t(self.o["depth"]) if depth_mode is not None else None
        return enc, DecoderOutput(color=t(self.o["color"]), depth=depth)


def _examples(rng, overlaps, v=5, h=32, w=32):
    out = []
    for i, ov in enumerate(overlaps):
        ex = {"context": dict(
            image=rng.uniform(0, 1, (1, v, h, w, 3)).astype(np.float32),
            intrinsics=np.broadcast_to(K, (1, v, 3, 3)).copy(),
            near=np.ones((1, v), np.float32), far=np.full((1, v), 100.0, np.float32),
            extrinsics=_rigid(rng, v, angle=0.3)[None]), "scene": [f"scene_{i}"]}
        if ov is not None:
            ex["overlap"] = np.array([ov], np.float32)  # as the dataset hands it over
        out.append(ex)
    return out


@pytest.fixture(scope="module")
def lpips_pair():
    """JAX LPIPS parameters and the port's LPIPS carrying them."""
    img = jnp.zeros((1, 32, 32, 3))
    params = jax.jit(JLPIPS().init)(jax.random.PRNGKey(0), img, img)
    lp = LPIPS()
    load_flat(lp, flatten(jax.tree_util.tree_map(np.asarray, params)["params"]), [], "lpips")
    lp.requires_grad_(False)
    return jax.jit(lambda a, b: JLPIPS().apply(params, a, b)), lp


class TestScoring:
    def test_records_files_and_summary_match(self, tmp_path, lpips_pair):
        """A stub model with fixed colour, depth and poses behind both
        evaluators: each record at rtol 1e-5, the PNGs byte-equal, and
        `finalize` on the same records the same `scores_all_avg.json`."""
        jlp, lp = lpips_pair
        rng = np.random.default_rng(5)
        outs = _stub_outputs(rng)
        exs = _examples(rng, [0.3, 0.6, 0.9, None, 0.75])
        jev = jeval.Evaluator(jeval.EvalCfg(output_path=tmp_path / "j", eval_time_skip_steps=1),
                              _JStub(outs), None, lpips_apply=jlp)
        tev = teval.Evaluator(teval.EvalCfg(output_path=tmp_path / "t", eval_time_skip_steps=1),
                              _TStub(outs), "cpu", lpips_apply=lp)
        for i, ex in enumerate(exs):
            want = jev.run_example(ex, jax.random.PRNGKey(i), i)
            got = tev.run_example(ex, None, i)
            assert set(got) == set(want) == {"scene", "psnr", "ssim", "lpips", "rot_deg",
                                             "trans_angle_deg", "trans_norm", "bucket"}
            assert (got["scene"], got["bucket"]) == (want["scene"], want["bucket"])
            for k in ("psnr", "ssim", "lpips", "rot_deg", "trans_angle_deg", "trans_norm"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
            assert got["rot_deg"] > 5.0  # the pose errors are far from arccos's edge
        assert [r["bucket"] for r in tev.records] == ["small", "medium", "large", "all", "medium"]
        pngs = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.png"))
        assert pngs == sorted(p.relative_to(tmp_path / "t")
                              for p in (tmp_path / "t").rglob("*.png"))
        assert len(pngs) == 5 * (3 + 3 + 1 + 1)  # pred, gt, compare, depth
        for p in pngs:
            assert (tmp_path / "t" / p).read_bytes() == (tmp_path / "j" / p).read_bytes(), p
        own = tev.records
        tev.records = copy.deepcopy(jev.records)
        tsum, jsum = tev.finalize(), jev.finalize()
        assert tsum == jsum
        assert set(jsum) == {"all", "small", "medium", "large"} and jsum["all"]["count"] == 5
        assert {"auc_5", "auc_10", "auc_20", "rot_deg_median"} <= set(jsum["all"])
        assert ((tmp_path / "t" / "scores_all_avg.json").read_text()
                == (tmp_path / "j" / "scores_all_avg.json").read_text())
        bench = json.loads((tmp_path / "t" / "benchmark.json").read_text())
        assert bench["encoder_decoder"]["count"] == 4  # 5 requests, the first skipped
        mem = json.loads((tmp_path / "t" / "peak_memory.json").read_text())
        assert mem == json.loads((tmp_path / "j" / "peak_memory.json").read_text())
        # the port's own records summarise within their tolerance
        tev2 = teval.Evaluator(teval.EvalCfg(output_path=tmp_path / "t2"), _TStub(outs), "cpu")
        tev2.records = own
        for bucket, agg in tev2.finalize().items():
            for k, x in agg.items():
                np.testing.assert_allclose(x, jsum[bucket][k], rtol=1e-5, err_msg=(bucket, k))

    def test_overlap_bucket_edges(self):
        for ov in (None, 0.0, 0.4999, 0.5, 0.75, 0.7501, 1.0, np.array([0.75])):
            assert teval.overlap_bucket(ov) == jeval.overlap_bucket(ov)


class TestBenchmarker:
    @pytest.mark.parametrize("skip", [0, 2, 5], ids=lambda s: f"skip{s}")
    def test_summarize_matches_jax(self, skip, tmp_path):
        times = {"encoder_decoder": [0.5, 0.25, 0.125, 0.375], "video": [1.0]}
        tb, jb = tbench.Benchmarker(skip_first=skip), jbench.Benchmarker(skip_first=skip)
        for b in (tb, jb):
            for tag, ts in times.items():
                b.execution_times[tag].extend(ts)
        assert tb.summarize() == jb.summarize()
        tb.dump(tmp_path / "t.json")
        jb.dump(tmp_path / "j.json")
        assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
        tb.clear_history()
        assert tb.summarize() == {}

    def test_time_and_dump_memory_on_the_cpu(self, tmp_path):
        b = tbench.Benchmarker(skip_first=1, device="cpu")
        for _ in range(3):
            with b.time("op", num_calls=2):
                torch.ones((8, 8)).sum()
        assert b.summarize()["op"]["count"] == 5  # 6 entries, the first skipped
        b.dump_memory(tmp_path / "t.json")
        jbench.Benchmarker().dump_memory(tmp_path / "j.json")
        assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
            (tmp_path / "j.json").read_text()) == {
            "bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}


class TestMetricComputer:
    def test_matches_jax_and_cli(self, tmp_path, lpips_pair, capsys):
        from PIL import Image

        jlp, lp = lpips_pair
        rng = np.random.default_rng(6)
        for d in ("gt", "m1", "m2"):
            (tmp_path / d).mkdir()
        for i in range(3):
            img = rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / "gt" / f"{i}.png")
            Image.fromarray(img).save(tmp_path / "m1" / f"{i}.png")
            noisy = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(noisy).save(tmp_path / "m2" / f"{i}.png")
        methods = {"m1": tmp_path / "m1", "m2": tmp_path / "m2", "none": tmp_path / "gt" / "x"}
        got = tmetric.compute_metrics(tmp_path / "gt", methods, lpips_apply=lp, device="cpu")
        want = jmetric.compute_metrics(tmp_path / "gt", methods, lpips_apply=jlp)
        assert got["none"] == want["none"] == {"count": 0}
        for m in ("m1", "m2"):
            assert set(got[m]) == set(want[m]) and got[m]["count"] == 3
            for k in ("psnr", "ssim", "lpips"):
                np.testing.assert_allclose(got[m][k], want[m][k], rtol=1e-5, err_msg=(m, k))
        assert got["m1"]["psnr"] > 50  # identical images
        tmetric.main([str(tmp_path / "gt"), f"m2={tmp_path / 'm2'}", "--out",
                      str(tmp_path / "o.json")], device="cpu")
        saved = json.loads((tmp_path / "o.json").read_text())
        assert saved["m2"]["count"] == 3 and "lpips" not in saved["m2"]
        assert json.loads(capsys.readouterr().out) == saved


def _tiny_run(tmp_path, name="run", extra=(), n_scenes=2, n_frames=20, seed=3, index=True,
              targets=(5, 8, 11)):
    """(argv of the port's main, JAX config) of `mode=test` on the tiny
    config over one synthetic chunk, with an index in the released schema
    that holds one null entry (tests/test_configs_eval.py's set-up)."""
    from pf3plat_tpu.utils.config import load_config as jload

    root = tmp_path / name
    data = root / "data" / "test"
    data.mkdir(parents=True)
    make_chunk(data / "000000.torch", n_scenes=n_scenes, n_frames=n_frames, h=72, w=128,
               seed=seed)
    overrides = list(TINY_OVERRIDES) + [
        'dataset.roots=["%s"]' % (root / "data"), f"test.output_path={root / 'out'}",
        f"checkpointing.directory={root / 'ckpt'}", *extra]
    if index:
        keys = [ex["key"] for ex in torch.load(data / "000000.torch", weights_only=False)]
        (root / "index.json").write_text(json.dumps(
            {keys[0]: {"context": [2, 14], "target": list(targets)}, keys[1]: None}))
        overrides.append(f"evaluation_index={root / 'index.json'}")
    config = REPO / "configs" / "re10k_test.yaml"
    return [str(config), *overrides], jload(config, overrides)


def _artifacts(out: Path, n_images: int | None = None):
    """tests/test_configs_eval.py's artifact checks on an output folder."""
    scores = json.loads((out / "scores_all_avg.json").read_text())
    assert scores["all"]["count"] >= 1 and np.isfinite(scores["all"]["psnr"])
    if "rot_deg" in scores["all"]:
        for k in ("auc_5", "auc_10", "auc_20"):
            assert 0.0 <= scores["all"][k] <= 1.0
    assert (out / "metrics.txt").exists()
    preds = list((out / "images" / "pred").glob("*.png"))
    assert preds and list((out / "images" / "gt").glob("*.png"))
    assert n_images is None or len(preds) == n_images
    assert list((out / "depth").glob("*.png"))
    assert list((out / "video").glob("*.gif")) or list((out / "video").glob("*.mp4"))
    return scores


class TestModeTest:
    def test_run_test_matches_jax_evaluator(self, tmp_path, capsys, monkeypatch):
        """`main(<re10k_test.yaml>, device="cpu")` on the tiny config with
        the parameters of a checkpoint, against the JAX evaluator's
        `run_example` on the same example, parameters and RANSAC noise.

        The port's random init is carried into the JAX trees (the inverse of
        `weights.load_jax_params`) and saved as the run's checkpoint, which
        `run_test` restores. Tolerances are the model test's
        (tests/test_torch_model.py: colours at 5e-3, poses 2e-3), which
        bound the PSNR at 0.05 dB, SSIM and LPIPS at 5e-3, the pose angles
        at 0.2 degrees and the translation error at 2e-3."""
        from test_torch_model import jax_ransac_noise

        from pf3plat_tpu.main import build_model as jbuild
        from pf3plat_tpu.models.pf3plat import PF3platParams
        from pf3plat_tpu_torch.models.pf3plat import PF3plat
        from pf3plat_tpu_torch.training import checkpoints as tckpt
        from pf3plat_tpu_torch.training.train import init_train_state
        from pf3plat_tpu_torch.utils.config import load_config
        from pf3plat_tpu_torch.weights import (
            ENCODER_RULES, LIGHTGLUE_RULES, UNIDEPTH_RULES, load_jax_params)

        monkeypatch.chdir(REPO)
        # one target view (v=3): the JAX forward's compile grows with the
        # view pairs (cold: ~50 s at v=3, ~75 s at v=5)
        argv, jcfg = _tiny_run(tmp_path, targets=(8,))
        cfg = load_config(Path(argv[0]), argv[1:])
        raw = next(tmain.batch_iterator(cfg, "test", 0, 1, lambda: 0))
        ctx = raw["context"]
        assert ctx["image"].shape == (1, 3, 32, 32, 3)

        # the port's init as the run's checkpoint, and as JAX trees
        torch.manual_seed(7)
        tm = tmain.build_model(cfg, "cpu")
        # LightGlue's per-layer assignment heads: only the last runs, and the
        # JAX tree holds that one
        heads = tm.lightglue.log_assignment
        for head in heads[:-1]:
            head.load_state_dict(heads[-1].state_dict())
        jm = jbuild(jcfg)
        args = [jnp.asarray(ctx[k]) for k in ("image", "intrinsics", "near", "far")]
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)
        trainable = {"params": jax_tree_from_port(tm.encoder, shapes.trainable["params"],
                                                  ENCODER_RULES, "encoder")}
        frozen = {k: {"params": jax_tree_from_port(getattr(tm, k), shapes.frozen[k]["params"],
                                                   rules, k)}
                  for k, rules in (("unidepth", UNIDEPTH_RULES), ("superpoint", []),
                                   ("lightglue", LIGHTGLUE_RULES), ("lpips", []))}
        check = PF3plat(tm.cfg, device="cpu")  # the inverse really inverts
        load_jax_params(check, trainable, frozen)
        for (name, a), b in zip(tm.state_dict().items(), check.state_dict().values()):
            assert torch.equal(a, b), name
        ckpt = tckpt.CheckpointManager(cfg.checkpointing)
        ckpt.maybe_save(init_train_state(tm)._replace(step=7), force=True)
        ckpt.save_frozen(tckpt.frozen_state(tm))

        # the JAX evaluator on the first request, run_test's first key
        _, key = jax.random.split(jax.random.PRNGKey(jcfg.seed))
        params = PF3platParams(jax.tree_util.tree_map(jnp.asarray, trainable),
                               jax.tree_util.tree_map(jnp.asarray, frozen))
        jev = jeval.Evaluator(
            jeval.EvalCfg(output_path=tmp_path / "jax", save_image=False), jm, params,
            lpips_apply=jax.jit(lambda a, b: jm.lpips_apply(params.frozen, a, b)))
        want = jev.run_example(raw, key, 0)
        v, e = ctx["image"].shape[1], jcfg.encoder
        noise = t(jax_ransac_noise(key, 1, v * (v - 1) // 2, e.ransac_samples,
                                   jcfg.model.max_matches))

        forward = PF3plat.forward

        def with_noise(self, *a, generator=None, **kw):
            return forward(self, *a, ransac_noise=noise, **kw)

        monkeypatch.setattr(PF3plat, "forward", with_noise)
        tmain.main(argv, device="cpu")
        out = capsys.readouterr().out
        assert "loaded checkpoint at step 7" in out
        rows = [json.loads(r) for r in
                (tmp_path / "run" / "out" / "metrics.txt").read_text().splitlines()]
        assert len(rows) == 1  # the null entry is skipped
        got = rows[0]
        assert got["scene"] == want["scene"] and got["bucket"] == want["bucket"] == "all"
        assert abs(got["psnr"] - want["psnr"]) <= 0.05
        for k in ("ssim", "lpips"):
            assert abs(got[k] - want[k]) <= 5e-3, k
        for k in ("rot_deg", "trans_angle_deg"):
            assert abs(got[k] - want[k]) <= 0.2, k
        assert abs(got["trans_norm"] - want["trans_norm"]) <= 2e-3
        scores = _artifacts(tmp_path / "run" / "out")
        assert scores["all"]["count"] == 1
        bench = json.loads((tmp_path / "run" / "out" / "benchmark.json").read_text())
        assert bench["encoder_decoder"]["count"] == 1
        assert set(json.loads((tmp_path / "run" / "out" / "peak_memory.json").read_text())) == {
            "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}

    def test_all_sampler_video_eval(self, tmp_path, monkeypatch):
        """`test.sampler=all`: every (capped) frame is context and target
        (tests/test_configs_eval.py:161-185)."""
        monkeypatch.chdir(REPO)
        argv, _ = _tiny_run(tmp_path, extra=("test.sampler=all", "test.all_sampler_max_views=4"),
                            n_scenes=1, n_frames=9, seed=5, index=False)
        tmain.main(argv, device="cpu")
        # 4 views spliced: targets = views[1:-1] -> 2 pred/gt images
        _artifacts(tmp_path / "run" / "out", n_images=2)
