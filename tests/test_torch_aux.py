"""Parity of the port's remaining host-side modules with the JAX package, on
the CPU: `training.train.make_train_step` and `make_optimizer`,
`utils.ply_export` and `models.backbones.weight_convert` (its converters,
its CLI, the `.pkl` artifacts through the port's loader, and `mode=test
weights=<dir>`).

Mirrors tests/test_training.py's train step on precomputed frozen inputs,
tests/test_aux.py's PLY round trip and tests/test_weights_path.py.
Tolerances are stated at each assertion.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.models.backbones import weight_convert as jwc
from pf3plat_tpu.models.decoder import DecoderCfg as JDecoderCfg
from pf3plat_tpu.models.encoder import PoseFreeEncoder as JEncoder
from pf3plat_tpu.ops.rasterizer import RasterizeConfig as JRasterCfg
from pf3plat_tpu.training import losses as jlosses, train as jtrain
from pf3plat_tpu.utils.ply_export import export_ply as jexport_ply

from pf3plat_tpu_torch import main as tmain
from pf3plat_tpu_torch.models.backbones import weight_convert as twc
from pf3plat_tpu_torch.models.decoder import DecoderCfg
from pf3plat_tpu_torch.models.encoder import (
    Correspondences, EncoderCfg, FrozenInputs, PoseFreeEncoder)
from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig
from pf3plat_tpu_torch.training import losses, train
from pf3plat_tpu_torch.training.pretrained import load_pretrained_frozen
from pf3plat_tpu_torch.utils.ply_export import export_ply
from pf3plat_tpu_torch.weights import (
    ENCODER_RULES, LIGHTGLUE_RULES, UNIDEPTH_RULES, flatten, jax_leaf, load_flat)

from test_encoder import synthetic_scene, tiny_cfg
from test_torch_helpers import _no_tf32, jax_tree_from_port, n, one_thread, t  # noqa: F401
from test_torch_model import jax_ransac_noise

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def train_steps():
    """Two steps of `make_train_step` on both sides (tests/test_training.py's
    synthetic scene, v=2 with 64 exact matches, the tiled decoder,
    LossCfg(ssim_weight=0)), from the port's random init carried into the
    JAX tree, with the same RANSAC noise. The encoder is
    tests/test_training.py's tiny one with one attention layer, 8 RANSAC
    hypotheses and a two-level depth U-Net without attention: the JAX
    step's trace and compile take most of this file's time. Returns the
    port encoder and, per step, (JAX aux, port aux, JAX state, port
    state)."""
    jcfg = dataclasses.replace(tiny_cfg(), n_attn_layers=1, ransac_samples=8,
                               depth_unet_channel_mult=(1, 1), depth_unet_attn_res=(),
                               costvolume_unet_attn_res=())
    scene = {k: jax.tree_util.tree_map(np.array, v) for k, v in synthetic_scene(v=2).items()}
    fields = ("d_feature", "d_backbone", "num_depth_candidates", "multiview_trans_attn_split",
              "n_attn_layers", "d_pose", "pose_heads", "ransac_samples",
              "costvolume_unet_feat_dim", "costvolume_unet_channel_mult",
              "costvolume_unet_attn_res", "depth_unet_feat_dim", "depth_unet_attn_res",
              "depth_unet_channel_mult")
    tcfg = EncoderCfg(**{f: getattr(jcfg, f) for f in fields},
                      gaussian_adapter=GaussianAdapterCfg(sh_degree=1))
    torch.manual_seed(0)
    tenc = PoseFreeEncoder(tcfg)
    jenc = JEncoder(jcfg)
    ctx = {k: scene[k] for k in ("images", "intrinsics", "near", "far")}
    args = (*(jnp.asarray(x) for x in ctx.values()),
            jax.tree_util.tree_map(jnp.asarray, scene["frozen"]),
            jax.tree_util.tree_map(jnp.asarray, scene["corr"]), jnp.asarray(0),
            jax.random.PRNGKey(0))
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(1), *args)
    params = {"encoder": {"params": jax_tree_from_port(tenc, shapes["params"], ENCODER_RULES,
                                                       "encoder")}}
    params = jax.tree_util.tree_map(jnp.asarray, params)

    raster = dict(tile_size=16, tile_capacity=256, chunk=64)
    jopt = jtrain.make_optimizer(jtrain.OptimizerCfg(lr=1e-3, max_steps=100))
    jstep = jax.jit(jtrain.make_train_step(
        jenc, JDecoderCfg(impl="tiled", raster=JRasterCfg(**raster)),
        jlosses.LossCfg(ssim_weight=0.0), jopt, (32, 32)))
    jstate = jtrain.init_train_state(params, jopt)
    jbatch = {"context": {"image": args[0], "intrinsics": args[1], "near": args[2],
                          "far": args[3]},
              "target": {"image": args[0]}, "frozen": args[4], "corr": args[5]}

    topt = train.make_optimizer(train.OptimizerCfg(lr=1e-3, max_steps=100))
    tstep = train.make_train_step(
        tenc, DecoderCfg(impl="tiled", raster=RasterizeConfig(**raster)),
        losses.LossCfg(ssim_weight=0.0), topt, (32, 32))
    tparams = list(tenc.parameters())
    tstate = train.TrainState(tparams, topt.init(tparams), 0)
    tbatch = {"context": {"image": t(ctx["images"]), "intrinsics": t(ctx["intrinsics"]),
                          "near": t(ctx["near"]), "far": t(ctx["far"])},
              "target": {"image": t(ctx["images"])},
              "frozen": FrozenInputs(*(t(x) for x in scene["frozen"])),
              "corr": Correspondences(*(t(x) for x in scene["corr"]))}
    m = scene["corr"][0].shape[2]
    out = []
    for s in range(2):
        rng = jax.random.PRNGKey(100 + s)
        jstate, jaux = jstep(jstate, jbatch, rng)
        noise = t(jax_ransac_noise(rng, 1, 1, jcfg.ransac_samples, m))
        tstate, taux = tstep(tstate, tbatch, ransac_noise=noise)
        out.append((jax.tree_util.tree_map(np.asarray, jaux), {k: n(v) for k, v in taux.items()},
                    jstate, tstate))
    return tenc, out


class TestMakeTrainStep:
    def test_loss_parts_and_grad_norm(self, train_steps):
        _, steps = train_steps
        for s, (jaux, taux, _, tstate) in enumerate(steps):
            assert tstate.step == s + 1
            assert set(taux) == set(jaux) == {"mse", "ssim", "pose", "psnr", "loss", "grad_norm"}
            # the render and photometric parts: rtol 1e-4
            for k in ("mse", "ssim", "psnr", "loss"):
                np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-4, atol=1e-7,
                                           err_msg=f"{k} step {s}")
            # the pose loss and the gradient norm reach the pose stacks' bf16
            # attention (tests/test_torch_training.py): rtol 1e-3
            for k in ("pose", "grad_norm"):
                np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-3, err_msg=f"{k} step {s}")
            assert taux["pose"] > 0 and taux["grad_norm"] > 0

    def test_gradients_through_adam_first_moment(self, train_steps):
        """The gradients, read from Adam's first moment (step 1: 0.1 * the
        clipped gradient; step 2: 0.1 * g2 + 0.09 * g1), tensor by tensor in
        norm, at tests/test_torch_training.py's tolerances (1e-2 after step
        1, 5e-2 after step 2)."""
        tenc, steps = train_steps
        names = [name for name, _ in tenc.named_parameters()]
        for s, (_, _, jstate, tstate) in enumerate(steps):
            adam = jstate.opt_state.inner_state[1][0]
            assert int(adam.count) == tstate.opt_state.count == s + 1
            flat = flatten(jax.tree_util.tree_map(np.asarray, adam.mu)["encoder"]["params"])
            mus = [jax_leaf(flat, name, ENCODER_RULES, "adam")[1] for name in names]
            top = max(np.linalg.norm(x) for x in mus)
            checked = 0
            for name, jmu, tmu in zip(names, mus, tstate.opt_state.mu):
                ref = np.linalg.norm(jmu)
                # gradients that vanish analytically hold only round-off
                if ref > 1e-6 * top:
                    err = np.linalg.norm(n(tmu) - jmu)
                    assert err <= (1e-2, 5e-2)[s] * ref, (s, name, err / ref)
                    checked += 1
            assert checked > len(names) // 2


class TestMakeOptimizer:
    def test_init_update_equal_opt_update(self):
        """`make_optimizer(cfg)` is `init_opt_state` / `opt_update` with the
        config's schedule, step for step and bit for bit, a NaN-gradient
        step skipped (zero update, state kept but the non-finite count)."""
        cfg = train.OptimizerCfg(max_steps=1000)
        opt = train.make_optimizer(cfg)
        schedule = train.make_schedule(cfg)
        rng = np.random.default_rng(0)
        shapes = ((4, 3), (7,), (2, 2, 2))
        params = [torch.zeros(sh) for sh in shapes]
        a, b = opt.init(params), train.init_opt_state(params)
        grads = [[t(s * rng.standard_normal(sh)) for sh in shapes] for s in (1.0, 0.05, 0.5)]
        bad = [g.clone() for g in grads[0]]
        bad[1][3] = float("nan")
        grads.insert(1, bad)
        for i, g in enumerate(grads):
            ua, a = opt.update(g, a)
            ub, b = train.opt_update(cfg, schedule, g, b)
            for x, y in zip(ua + a.mu + a.nu, ub + b.mu + b.nu):
                assert torch.equal(x, y)
            assert (a.count, a.notfinite_count) == (b.count, b.notfinite_count)
            if i == 1:
                assert all(float(u.abs().max()) == 0 for u in ua)
                assert (a.count, a.notfinite_count) == (1, 1)
        assert (a.count, a.notfinite_count) == (3, 0)
        assert opt.schedule(5) == schedule(5)


class TestPlyExport:
    def _inputs(self, seed=1, g=100):
        rng = np.random.default_rng(seed)
        q = rng.standard_normal((g, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        extr = np.eye(4, dtype=np.float32)
        extr[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0] * [1, 1, 1]
        extr[:3, :3] *= np.sign(np.linalg.det(extr[:3, :3]))
        return (extr, rng.standard_normal((g, 3)).astype(np.float32),
                rng.uniform(0.01, 0.1, (g, 3)).astype(np.float32), q.astype(np.float32),
                rng.standard_normal((g, 3, 25)).astype(np.float32),
                rng.uniform(0, 1, g).astype(np.float32))

    @staticmethod
    def _read(path):
        header, _, body = path.read_bytes().partition(b"end_header\n")
        n_props = header.count(b"property float")
        return header, np.frombuffer(body, "<f4").reshape(-1, n_props)

    def test_matches_jax(self, tmp_path):
        args = self._inputs()
        export_ply(*args, tmp_path / "t.ply")
        jexport_ply(*args, tmp_path / "j.ply")
        (th, td), (jh, jd) = self._read(tmp_path / "t.ply"), self._read(tmp_path / "j.ply")
        assert th == jh
        np.testing.assert_allclose(td, jd, atol=1e-6)

    def test_export_roundtrip(self, tmp_path):
        """tests/test_aux.py:73-93."""
        extr, means, scales, _, sh, opac = self._inputs(g=100)
        rot = np.tile([0, 0, 0, 1.0], (100, 1)).astype(np.float32)
        export_ply(np.eye(4, dtype=np.float32), means, scales, rot, sh, opac,
                   tmp_path / "out.ply")
        header, data = self._read(tmp_path / "out.ply")
        assert b"element vertex 100" in header and data.shape == (100, 17)
        assert np.isfinite(data).all()


@pytest.fixture(scope="module")
def tiny_frozen_shapes():
    """The JAX frozen parameter tree's layout of the tiny config (no
    compile: `jax.eval_shape` of the init)."""
    from pf3plat_tpu.main import build_model as jbuild
    from pf3plat_tpu.utils.config import load_config as jload

    from test_configs_eval import TINY_OVERRIDES

    jm = jbuild(jload(REPO / "configs" / "re10k_test.yaml", list(TINY_OVERRIDES)))
    images = jnp.zeros((1, 2, 32, 32, 3), jnp.float32)
    intr = jnp.broadcast_to(jnp.eye(3), (1, 2, 3, 3)).astype(jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), images, intr, jnp.ones((1, 2)),
                            jnp.full((1, 2), 100.0))
    return shapes.frozen


def _release_checkpoints(raw: Path, frozen) -> list[str]:
    """Synthetic torch checkpoints in the RELEASE layouts for the frozen
    shapes (tests/test_weights_path.py's helpers), and the converter's
    arguments for them."""
    from test_unidepth_parity import TDecoder, _tiny_vit_sd, sd_np
    from test_weights_path import make_lightglue_sd, make_lpips_sd, make_superpoint_sd

    from pf3plat_tpu_torch.models.backbones.unidepth import UniDepthCfg

    rng = np.random.default_rng(0)
    raw.mkdir(exist_ok=True)
    torch.save(make_superpoint_sd(rng, frozen["superpoint"]), raw / "superpoint.pth")
    torch.save(make_lightglue_sd(rng, frozen["lightglue"]), raw / "lightglue.pth")
    torch.save(make_lpips_sd(rng, frozen["lpips"]), raw / "vgg.pth")
    ucfg = UniDepthCfg.tiny_test()
    e = ucfg.vit.embed_dim
    dec = TDecoder(e, ucfg.hidden_dim, ucfg.num_heads, ucfg.expansion, ucfg.depths,
                   ucfg.camera_dim, len(ucfg.output_idx))
    vit_sd = _tiny_vit_sd(e, ucfg.vit.depth, ucfg.vit.pos_embed_size)
    usd = {f"pixel_decoder.{k}": torch.tensor(v) for k, v in sd_np(dec).items()}
    usd.update({f"pixel_encoder.{k}": torch.tensor(np.asarray(v)) for k, v in vit_sd.items()})
    torch.save(usd, raw / "unidepth.pth")
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in vit_sd.items()}, raw / "dinov2.pth")
    return ["--superpoint", str(raw / "superpoint.pth"), "--lightglue", str(raw / "lightglue.pth"),
            "--dinov2", str(raw / "dinov2.pth"), "--unidepth", str(raw / "unidepth.pth"),
            "--vgg", str(raw / "vgg.pth")]


@pytest.fixture(scope="module")
def converted(tmp_path_factory, tiny_frozen_shapes):
    """The release checkpoints converted by both CLIs: (raw dir, port
    output dir, JAX output dir)."""
    root = tmp_path_factory.mktemp("weights")
    args = _release_checkpoints(root / "raw", tiny_frozen_shapes)
    twc.main([*args, "--out", str(root / "t")])
    old = sys.argv
    try:
        sys.argv = ["weight_convert", *args, "--out", str(root / "j")]
        jwc.main()
    finally:
        sys.argv = old
    return root / "raw", root / "t", root / "j"


def _assert_trees_bit_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_trees_bit_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


class TestWeightConvert:
    @pytest.mark.parametrize("artifact", ["superpoint", "lightglue", "dinov2", "unidepth",
                                          "lpips_vgg"])
    def test_cli_artifacts_bit_equal(self, converted, artifact):
        _, tdir, jdir = converted
        with (tdir / f"{artifact}.pkl").open("rb") as f:
            got = pickle.load(f)
        with (jdir / f"{artifact}.pkl").open("rb") as f:
            want = pickle.load(f)
        _assert_trees_bit_equal(got, want)

    def test_converters_bit_equal(self, converted):
        """Every `convert_*` on the release state dicts, and the helpers."""
        raw = converted[0]

        def sd(name):
            return {k: v.numpy() for k, v in torch.load(raw / name, weights_only=False).items()}

        for fn, name in (("convert_superpoint", "superpoint.pth"),
                         ("convert_lightglue", "lightglue.pth"), ("convert_dinov2", "dinov2.pth"),
                         ("convert_lpips_vgg", "vgg.pth")):
            _assert_trees_bit_equal(getattr(twc, fn)(sd(name)), getattr(jwc, fn)(sd(name)))
        (tp, tinfo), (jp, jinfo) = twc.convert_unidepth(sd("unidepth.pth")), jwc.convert_unidepth(
            sd("unidepth.pth"))
        _assert_trees_bit_equal(tp, jp)
        assert tinfo == jinfo
        w = np.random.default_rng(1).standard_normal((5, 4, 3, 2)).astype(np.float32)
        np.testing.assert_array_equal(twc.conv_w(w), jwc.conv_w(w))
        np.testing.assert_array_equal(twc.linear_w(w[:, :, 0, 0]), jwc.linear_w(w[:, :, 0, 0]))

    def test_port_loader_equals_jax_loader(self, converted, tiny_frozen_shapes):
        """The port's CLI output through the port's `load_pretrained_frozen`
        gives the frozen modules that the JAX loader's tree gives through
        the port's parameter map (`weights.load_flat`, as `load_jax_params`
        does)."""
        from pf3plat_tpu.training.pretrained import load_pretrained_frozen as jload_frozen
        from pf3plat_tpu_torch.utils.config import load_config

        from test_configs_eval import TINY_OVERRIDES

        _, tdir, jdir = converted
        cfg = load_config(REPO / "configs" / "re10k_test.yaml", list(TINY_OVERRIDES))
        torch.manual_seed(0)
        a = tmain.build_model(cfg, "cpu")
        torch.manual_seed(1)
        b = tmain.build_model(cfg, "cpu")
        assert sorted(load_pretrained_frozen(tdir, a)) == ["lightglue", "lpips_vgg",
                                                           "superpoint", "unidepth"]
        template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                          tiny_frozen_shapes)
        jtree = jax.tree_util.tree_map(np.asarray, jload_frozen(jdir, template))
        for key, rules in (("unidepth", UNIDEPTH_RULES), ("superpoint", []),
                           ("lightglue", LIGHTGLUE_RULES), ("lpips", [])):
            load_flat(getattr(b, key), flatten(jtree[key]["params"]), rules, key)
            for (name, x), y in zip(getattr(a, key).state_dict().items(),
                                    getattr(b, key).state_dict().values()):
                assert torch.equal(x, y), (key, name)

    def test_corrupted_artifact_raises(self, converted, tmp_path):
        from pf3plat_tpu_torch.utils.config import load_config

        from test_configs_eval import TINY_OVERRIDES

        _, tdir, _ = converted
        with (tdir / "superpoint.pkl").open("rb") as f:
            tree = pickle.load(f)
        first = sorted(tree["params"])[0]
        tree["params"][first]["kernel"] = np.zeros(
            tree["params"][first]["kernel"].shape + (2,), np.float32)
        with (tmp_path / "superpoint.pkl").open("wb") as f:
            pickle.dump(tree, f)
        cfg = load_config(REPO / "configs" / "re10k_test.yaml", list(TINY_OVERRIDES))
        model = tmain.build_model(cfg, "cpu")
        with pytest.raises(ValueError, match="superpoint"):
            load_pretrained_frozen(tmp_path, model)
        with pytest.raises(FileNotFoundError):
            load_pretrained_frozen(tmp_path / "empty", model)

    def test_mode_test_with_weights(self, converted, tmp_path, capsys, monkeypatch):
        """`mode=test weights=<dir>` runs the evaluation protocol on the
        converted weights (tests/test_weights_path.py:246-270)."""
        from test_configs_eval import TINY_OVERRIDES
        from test_data import make_chunk

        monkeypatch.chdir(REPO)
        data = tmp_path / "data" / "test"
        data.mkdir(parents=True)
        make_chunk(data / "000000.torch", n_scenes=1, n_frames=12, h=72, w=128, seed=11)
        tmain.main([str(REPO / "configs" / "re10k_test.yaml"), *TINY_OVERRIDES,
                    'dataset.roots=["%s"]' % (tmp_path / "data"),
                    f"test.output_path={tmp_path / 'out'}",
                    f"checkpointing.directory={tmp_path / 'ckpt'}", "test.save_video=false",
                    "evaluation_index=null",
                    "view_sampler.min_distance_between_context_views=2",
                    "view_sampler.max_distance_between_context_views=6",
                    "view_sampler.initial_min_distance_between_context_views=2",
                    "view_sampler.initial_max_distance_between_context_views=6",
                    f"weights={converted[1]}"], device="cpu")
        assert "loaded pretrained frozen weights: superpoint, lightglue, unidepth, lpips_vgg" \
            in capsys.readouterr().out
        scores = json.loads((tmp_path / "out" / "scores_all_avg.json").read_text())
        assert scores["all"]["count"] >= 1 and np.isfinite(scores["all"]["psnr"])
