"""Parity of the port's training entry point and its host-side modules with
the JAX package, on the CPU: visualization, trajectories, logging,
profiling, and `main` itself on `configs/smoke.yaml` (train, checkpoint,
resume, validation artifacts, log rows). The checkpoint modules have their
own file (tests/test_torch_checkpoints.py).

Mirrors tests/test_aux.py's logging, profiling, trajectory, visualization
and encoder-vis cases.
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pf3plat_tpu.utils import logging as jlogging
from pf3plat_tpu.visualization import encoder_vis as jvis
from pf3plat_tpu.visualization import layout as jlayout
from pf3plat_tpu.visualization import trajectories as jtraj
from pf3plat_tpu.visualization import validation as jvalidation

from pf3plat_tpu_torch import main as tmain
from pf3plat_tpu_torch.models.types import Gaussians
from pf3plat_tpu_torch.training import checkpoints as tckpt
from pf3plat_tpu_torch.training.train import TrainState
from pf3plat_tpu_torch.utils import logging as tlogging
from pf3plat_tpu_torch.utils import profiling as tprofiling
from pf3plat_tpu_torch.visualization import encoder_vis as tvis
from pf3plat_tpu_torch.visualization import layout as tlayout
from pf3plat_tpu_torch.visualization import trajectories as ttraj
from pf3plat_tpu_torch.visualization import validation as tvalidation

from test_data import make_chunk
from test_torch_helpers import n, one_thread, t  # noqa: F401

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
pytestmark = pytest.mark.usefixtures("one_thread")


class TestTrajectories:
    def _rotations(self, seed, k):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(k):
            q, r = np.linalg.qr(rng.standard_normal((3, 3)))
            q *= np.sign(np.diag(r))
            q[:, 0] *= np.sign(np.linalg.det(q))
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = q
            m[:3, 3] = rng.standard_normal(3)
            out.append(m)
        return out

    def test_interpolation_and_slerp_match(self):
        a, b = self._rotations(0, 2)
        ts = np.linspace(0, 1, 9).astype(np.float32)
        np.testing.assert_allclose(
            n(ttraj.interpolate_extrinsics(t(a), t(b), t(ts))),
            np.asarray(jtraj.interpolate_extrinsics(jnp.asarray(a), jnp.asarray(b),
                                                    jnp.asarray(ts))), atol=1e-6)
        np.testing.assert_allclose(
            n(ttraj.interpolate_intrinsics(t(a[:3, :3]), t(b[:3, :3]), t(ts))),
            np.asarray(jtraj.interpolate_intrinsics(jnp.asarray(a[:3, :3]),
                                                    jnp.asarray(b[:3, :3]), jnp.asarray(ts))),
            atol=1e-6)
        # nearly equal rotations take the lerp branch
        q = np.array([[1.0, 0, 0, 0], [0.5, 0.5, 0.5, 0.5]], np.float32)
        q1 = q + np.array([[0, 1e-7, 0, 0], [0, 0, 0, 0]], np.float32)
        np.testing.assert_allclose(
            n(ttraj.slerp(t(q), t(q1), t(ts[:2, None]))),
            np.asarray(jtraj.slerp(jnp.asarray(q), jnp.asarray(q1), jnp.asarray(ts[:2, None]))),
            atol=1e-6)

    def test_wobble_and_spin_match(self):
        (a,) = self._rotations(1, 1)
        ts = np.linspace(0, 1, 24).astype(np.float32)
        np.testing.assert_allclose(
            n(ttraj.generate_wobble(t(a), torch.tensor(0.3), t(ts))),
            np.asarray(jtraj.generate_wobble(jnp.asarray(a), jnp.asarray(0.3),
                                             jnp.asarray(ts))), atol=1e-6)
        np.testing.assert_allclose(n(ttraj.generate_spin(12, 20.0, 2.5)),
                                   np.asarray(jtraj.generate_spin(12, 20.0, 2.5)), atol=1e-6)

    def test_matrix_to_quaternion_matches(self):
        from pf3plat_tpu.geometry.transforms import matrix_to_quaternion as jm2q

        from pf3plat_tpu_torch.geometry.transforms import matrix_to_quaternion as tm2q

        rots = np.stack([m[:3, :3] for m in self._rotations(2, 32)])
        rots[:4] = np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1]), np.eye(3)
        np.testing.assert_allclose(n(tm2q(t(rots))), np.asarray(jm2q(jnp.asarray(rots))),
                                   atol=1e-6)


class TestVisualization:
    def test_layout_exact(self):
        rng = np.random.default_rng(0)
        a = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        b = rng.uniform(0, 1, (6, 12)).astype(np.float32)
        for fn in ("hcat", "vcat"):
            np.testing.assert_array_equal(getattr(tlayout, fn)(a, b, gap=3),
                                          getattr(jlayout, fn)(a, b, gap=3))
        np.testing.assert_array_equal(tlayout.add_border(a), jlayout.add_border(a))
        d = rng.uniform(0.5, 9, (5, 7))
        np.testing.assert_array_equal(tlayout.apply_depth_color_map(d),
                                      jlayout.apply_depth_color_map(d))
        np.testing.assert_array_equal(tlayout.apply_depth_color_map(d, 1.0, 10.0),
                                      jlayout.apply_depth_color_map(d, 1.0, 10.0))

    def test_comparison_panel_and_files_exact(self, tmp_path):
        rng = np.random.default_rng(2)
        args = (rng.uniform(0, 1, (2, 16, 16, 3)), rng.uniform(0, 1, (3, 16, 16, 3)),
                rng.uniform(0, 1, (3, 16, 16, 3)))
        depth = rng.uniform(1, 5, (2, 16, 16))
        got = tvalidation.comparison_panel(*args, depth=depth, path=tmp_path / "t.png")
        want = jvalidation.comparison_panel(*args, depth=depth, path=tmp_path / "j.png")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                      np.asarray(Image.open(tmp_path / "j.png")))

    def test_save_video_gif_exact(self, tmp_path):
        rng = np.random.default_rng(3)
        frames = [rng.uniform(0, 1, (12, 10, 3)) for _ in range(4)]
        tlayout.save_video(frames, tmp_path / "t.mp4")
        jlayout.save_video(frames, tmp_path / "j.mp4")
        gt, gj = Image.open(tmp_path / "t.gif"), Image.open(tmp_path / "j.gif")
        assert gt.n_frames == gj.n_frames == 4
        for i in range(4):
            gt.seek(i)
            gj.seek(i)
            np.testing.assert_array_equal(np.asarray(gt.convert("RGB")),
                                          np.asarray(gj.convert("RGB")))

    def test_topdown_projection(self):
        rng = np.random.default_rng(3)
        g = 64
        gauss = Gaussians(
            torch.as_tensor(rng.standard_normal((1, g, 3)), dtype=torch.float32),
            (torch.eye(3) * 1e-3).expand(1, g, 3, 3),
            torch.as_tensor(rng.standard_normal((1, g, 3, 1)), dtype=torch.float32),
            torch.full((1, g), 0.8),
        )
        img = tvalidation.project_gaussians_topdown(gauss, resolution=64)
        assert img.shape == (64, 64, 3)
        assert np.isfinite(img).all()


class TestEncoderVis:
    def test_gaussians_panel_exact(self):
        rng = np.random.default_rng(0)
        v, h, w = 3, 16, 24
        g = 2 * h * w  # gaussians from the first and last views
        args = (rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32),
                rng.uniform(0, 1, (g,)).astype(np.float32),
                (np.eye(3) * rng.uniform(1e-5, 1e-3, (g, 1, 1))).astype(np.float32),
                rng.uniform(0, 1, (g, 3)).astype(np.float32))
        np.testing.assert_array_equal(tvis.gaussians_panel(*args), jvis.gaussians_panel(*args))

    def test_matches_panel_exact(self):
        rng = np.random.default_rng(1)
        v, h, w, m = 3, 20, 30, 8
        pi, pj = np.array([0, 0, 1]), np.array([1, 2, 2])
        args = (rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32),
                rng.uniform(0, [w - 1, h - 1], (3, m, 2)),
                rng.uniform(0, [w - 1, h - 1], (3, m, 2)),
                rng.uniform(0, 1, (3, m)).astype(np.float32),
                rng.uniform(0, 1, (3, m)) < 0.7, pi, pj)
        np.testing.assert_array_equal(tvis.matches_panel(*args), jvis.matches_panel(*args))

    def test_encoder_internals_panels_exact(self, tmp_path):
        """The validation step's encoder panels from torch tensors equal the
        JAX package's from the same arrays."""
        rng = np.random.default_rng(4)
        b, v, h, w, m = 1, 3, 12, 16, 6
        g = 2 * h * w
        arrays = dict(
            opacities=rng.uniform(0, 1, (b, g)).astype(np.float32),
            covariances=(np.eye(3) * rng.uniform(1e-5, 1e-3, (b, g, 1, 1))).astype(np.float32),
            harmonics=rng.uniform(0, 1, (b, g, 3, 4)).astype(np.float32),
            kpts0=rng.uniform(0, [w - 1, h - 1], (b, 3, m, 2)).astype(np.float32),
            kpts1=rng.uniform(0, [w - 1, h - 1], (b, 3, m, 2)).astype(np.float32),
            scores=rng.uniform(0, 1, (b, 3, m)).astype(np.float32),
            valid=rng.uniform(0, 1, (b, 3, m)) < 0.7,
        )
        images = rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32)

        def enc(wrap):
            a = {k: wrap(x) for k, x in arrays.items()}
            return types.SimpleNamespace(
                gaussians=types.SimpleNamespace(**{k: a[k] for k in (
                    "opacities", "covariances", "harmonics")}),
                correspondences=types.SimpleNamespace(**{k: a[k] for k in (
                    "kpts0", "kpts1", "scores", "valid")}))

        tvis.encoder_internals_panels(images, enc(torch.as_tensor), tmp_path / "t")
        jvis.encoder_internals_panels(images, enc(jnp.asarray), tmp_path / "j")
        for name in ("gaussians.png", "matches.png"):
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / name)),
                                          np.asarray(Image.open(tmp_path / "j" / name)))


class TestLoggingAndProfiling:
    def test_local_logger_matches(self, tmp_path):
        for mod, d, val in ((tlogging, tmp_path / "t", torch.tensor(0.25)),
                            (jlogging, tmp_path / "j", jnp.asarray(0.25))):
            log = mod.LocalLogger(d)
            log.log_scalars(1, {"loss": 0.5})
            log.log_scalars(2, {"loss": val, "psnr": 11.0})
            log.log_image("pred", 1, np.full((4, 4, 3), 0.5))
            log.close()
        rows = [[{k: v for k, v in json.loads(ln).items() if k != "time"}
                 for ln in (tmp_path / x / "scalars.jsonl").read_text().splitlines()]
                for x in ("t", "j")]
        assert rows[0] == rows[1] == [{"step": 1, "loss": 0.5},
                                      {"step": 2, "loss": 0.25, "psnr": 11.0}]
        assert (tmp_path / "t" / "images" / "pred" / "000001.png").exists()

    def test_cpu_trace_breakdown_and_busy(self, tmp_path):
        x = torch.ones((256, 256))
        with tprofiling.trace(tmp_path, window="w"):
            (x @ x).sum()
        rows = tprofiling.device_op_breakdown(tmp_path)
        assert rows and all(r["total_us"] >= 0 for r in rows)
        assert any("mm" in r["name"] for r in rows)
        assert rows == sorted(rows, key=lambda r: -r["total_us"])
        assert tprofiling.device_op_breakdown(tmp_path, window="w")
        busy = tprofiling.device_busy(tmp_path, window="w")
        assert busy["device_events"] == 0 and busy["busy_us"] == 0.0
        assert busy["launch_lead_min_us"] is None
        assert busy["wall_us"] > 0 and busy["idle_share"] == 1.0
        with pytest.raises(ValueError):
            tprofiling.device_busy(tmp_path, window="no_such_window")

    def test_device_busy_union_of_intervals(self, tmp_path):
        """Overlapping kernels on two streams count once; the window's ends
        clip; host events do not count."""
        ev = [
            {"ph": "X", "cat": "user_annotation", "name": "w", "ts": 100.0, "dur": 100.0},
            {"ph": "X", "cat": "kernel", "name": "a", "ts": 90.0, "dur": 20.0,
             "args": {"correlation": 1, "External id": 7}},
            {"ph": "X", "cat": "kernel", "name": "b", "ts": 105.0, "dur": 10.0,
             "args": {"correlation": 2, "External id": 8}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 150.0, "dur": 10.0},
            {"ph": "X", "cat": "kernel", "name": "d", "ts": 195.0, "dur": 30.0},
            {"ph": "X", "cat": "cpu_op", "name": "e", "ts": 120.0, "dur": 50.0},
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 80.0, "dur": 5.0,
             "args": {"External id": 7}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 85.0,
             "dur": 2.0, "args": {"correlation": 1, "External id": 7}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 107.0,
             "dur": 2.0, "args": {"correlation": 2, "External id": 8}},
        ]
        (tmp_path / "x.pt.trace.json").write_text(json.dumps({"traceEvents": ev}))
        busy = tprofiling.device_busy(tmp_path, window="w")
        # b starts 2 us before its own launch call: a clock drift
        assert busy == {"busy_us": 30.0, "wall_us": 100.0, "idle_share": 0.7,
                        "device_events": 4, "launch_lead_min_us": -2.0,
                        "negative_leads": 1, "negative_lead_us": 10.0}
        rows = tprofiling.device_op_breakdown(tmp_path, window="w")
        assert {r["name"]: r["total_us"] for r in rows} == {"a": 10.0, "b": 10.0, "c": 10.0,
                                                            "d": 5.0}
        assert rows[-1]["name"] == "d"
        assert {r["name"]: r["launched_by"] for r in rows}["a"] == "aten::mm"


class TestMain:
    def _argv(self, tmp_path, *extra):
        return ["configs/smoke.yaml", f'dataset.roots=["{tmp_path / "data"}"]',
                f'checkpointing.directory="{tmp_path / "ckpt"}"',
                f'output_dir="{tmp_path / "logs"}"',
                f'test.output_path="{tmp_path / "out" / "test"}"',
                "train.val_check_interval=2", "data_loader.num_workers=2", *extra]

    def test_train_checkpoint_resume_validate(self, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(CONFIG_DIR.parent)
        (tmp_path / "data" / "train").mkdir(parents=True)
        make_chunk(tmp_path / "data" / "train" / "000000.torch", n_scenes=2, n_frames=20,
                   seed=0)
        tmain.main(self._argv(tmp_path), device="cpu")
        out = capsys.readouterr().out
        for s in (1, 2, 3):
            assert f"step {s}: loss=" in out
        assert "failed" not in out
        ckpt = tckpt.CheckpointManager(tckpt.CheckpointCfg(directory=tmp_path / "ckpt"))
        assert ckpt.all_steps() == [2, 3] and ckpt.has_frozen()  # interval 2 + forced last
        saved = torch.load(tmp_path / "ckpt" / "state" / "3" / "state.pt", weights_only=True)
        val = tmp_path / "out" / "validation"
        assert sorted(p.name for p in val.iterdir()) == ["step_0000000", "step_0000002"]
        for d in val.iterdir():
            for name in ("comparison.png", "wobble.gif", "gaussians.png", "matches.png"):
                assert (d / name).exists(), (d, name)
        rows = (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()
        assert [json.loads(r)["step"] for r in rows] == [1, 2, 3]
        assert all(np.isfinite(json.loads(r)["loss"]) for r in rows)

        # resume: the run's own checkpoint, one more step
        # (run_train imports make_model_train_step at call time)
        from pf3plat_tpu_torch.training import train as ttrain

        restored = {}
        make_step = ttrain.make_model_train_step

        def recording(*a, **kw):
            step = make_step(*a, **kw)

            def wrapped(state, batch, **kws):
                restored.setdefault("state", TrainState(
                    [p.detach().clone() for p in state.params], state.opt_state, state.step))
                return step(state, batch, **kws)
            return wrapped

        monkeypatch.setattr(ttrain, "make_model_train_step", recording)
        tmain.main(self._argv(tmp_path, "max_steps=4"), device="cpu")
        out = capsys.readouterr().out
        assert "resumed from step 3" in out and "step 4: loss=" in out
        got = restored["state"]
        assert got.step == saved["step"] == 3
        assert got.opt_state.count == saved["count"]
        for a, b in zip(got.params + got.opt_state.mu + got.opt_state.nu,
                        saved["params"] + saved["mu"] + saved["nu"]):
            assert torch.equal(a, b)
        assert ckpt.all_steps() == [3, 4]
        assert (val / "step_0000004" / "wobble.gif").exists()
        rows = (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()
        assert [json.loads(r)["step"] for r in rows] == [1, 2, 3, 4]

    def test_train_through_a_mesh(self, tmp_path, capsys, monkeypatch):
        """`train.tile_axis=2` puts the step on a (1, 2) mesh (both shards on
        the one device here), as the JAX loop's mesh rule does."""
        monkeypatch.chdir(CONFIG_DIR.parent)
        (tmp_path / "data" / "train").mkdir(parents=True)
        make_chunk(tmp_path / "data" / "train" / "000000.torch", n_scenes=1, n_frames=20,
                   seed=1)
        tmain.main(self._argv(tmp_path, "train.tile_axis=2", 'decoder.impl="pallas"',
                              "max_steps=1", "train.sanity_validation=false"), device="cpu")
        out = capsys.readouterr().out
        assert "mesh: data=1 tile=2 hosts=1" in out
        row = json.loads((tmp_path / "logs" / "scalars.jsonl").read_text())
        assert row["step"] == 1 and np.isfinite(row["loss"])

    def test_mode_test_not_ported(self, monkeypatch):
        """`mode=test` is ported now: `main` hands the config and the device
        to `run_test` (run end to end in tests/test_torch_eval.py)."""
        calls = []
        monkeypatch.setattr(tmain, "run_test", lambda cfg, device: calls.append((cfg, device)))
        tmain.main([str(CONFIG_DIR / "re10k_test.yaml"), "mode=test"], device="cpu")
        assert [(cfg.mode, device) for cfg, device in calls] == [("test", "cpu")]

    def test_step_generator(self):
        draw = lambda s, k: torch.randn(4, generator=tmain.step_generator(s, k, "cpu"))  # noqa
        assert torch.equal(draw(1, 5), draw(1, 5))
        assert not torch.equal(draw(1, 5), draw(1, 6))
        assert not torch.equal(draw(1, 5), draw(2, 5))

    def test_default_device_is_cuda(self, monkeypatch):
        """Without `device`, `main` runs on the card and raises without one."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmain.main([str(CONFIG_DIR / "smoke.yaml")])
