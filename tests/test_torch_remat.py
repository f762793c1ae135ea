"""The port's memory and precision policy for training against the JAX
package's, on the CPU: `EncoderCfg.remat` / `remat_mode` (the attention
stacks and the cross-view aggregator recomputed in the backward, then the
two U-Nets under "selective" or the whole depth predictor under any other
mode), the per-chunk recompute of the plane sweep, of LPIPS and of the
`tiled` backend's chunks, and `unet_dtype` / `costvolume_dtype`.

  * the three remat modes give bit-equal train steps (loss, every gradient,
    every updated parameter) from the same parameters and generator;
  * the default mode is the one `tests/test_torch_training.py` holds to the
    JAX train step;
  * saved-tensor accounting over one forward: no warped chunk is saved, and
    the saved bytes order as off > selective >= coarse; the `tiled`
    backend saves no chunk's alphas;
  * U-Net, plane-sweep warp and depth predictor at bfloat16 against the JAX
    modules at bfloat16, weights through `weights.py`, with the tolerances
    stated at each assertion;
  * JAX parameter trees made under each remat setting load into the port.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.models.costvolume import (
    DepthPredictorCfg as JDepthPredictorCfg, DepthPredictorMultiView as JDepthPredictor,
    warp_with_pose_depth_candidates as jwarp)
from pf3plat_tpu.models.encoder import PoseFreeEncoder as JEncoder
from pf3plat_tpu.models.unet import UNetModel as JUNet

from pf3plat_tpu_torch.models.costvolume import (
    DepthPredictorCfg, DepthPredictorMultiView, warp_with_pose_depth_candidates)
from pf3plat_tpu_torch.models.encoder import EncoderCfg, PoseFreeEncoder
from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
from pf3plat_tpu_torch.models.pf3plat import PF3plat
from pf3plat_tpu_torch.models.unet import UNetModel
from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig
from pf3plat_tpu_torch.ops.rasterizer.compositing import composite_chunk, gaussian_alpha
from pf3plat_tpu_torch.ops.rasterizer.tiled import composite_tables
from pf3plat_tpu_torch.training import losses, train
from pf3plat_tpu_torch.weights import ENCODER_RULES, flatten, jax_leaf, load_flat

from test_encoder import synthetic_scene, tiny_cfg
from test_torch_helpers import _no_tf32, n, one_thread, t  # noqa: F401
from test_torch_model import H, W, _cfgs, _inputs

pytestmark = pytest.mark.usefixtures("one_thread")

MODES = {"off": dict(remat=False), "selective": dict(remat=True, remat_mode="selective"),
         "coarse": dict(remat=True, remat_mode="coarse")}
# One bfloat16 step, relative.
BF16_STEP = 2.0**-8


def _model(mode: str, chunk: int) -> PF3plat:
    """tests/test_torch_model.py's tiny PF3plat under a remat mode, its
    plane sweep in chunks of `chunk` of its 16 candidates, random weights
    from torch seed 0 (the same for every mode)."""
    _, cfg = _cfgs()
    enc = dataclasses.replace(cfg.encoder, costvolume_scan_chunk=chunk, **MODES[mode])
    torch.manual_seed(0)
    return PF3plat(dataclasses.replace(cfg, encoder=enc), device="cpu")


def _batch():
    images, intr, near, far = (t(a) for a in _inputs())
    return dict(context=dict(image=images, intrinsics=intr, near=near, far=far),
                target=dict(image=images))


def _step(mode: str) -> dict:
    """One train step in chunks of 4 on one thread (a module fixture runs
    before `one_thread`, and the thread count sets CPU summation orders):
    loss parts, gradients, parameters."""
    model = _model(mode, 4)
    assert model.cfg.encoder.remat_policy == mode
    step = train.make_model_train_step(model, losses.LossCfg(), train.OptimizerCfg())
    state = train.init_train_state(model)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, aux = step(state, _batch(), generator=torch.Generator().manual_seed(5))
    finally:
        torch.set_num_threads(threads)
    return dict(aux={k: n(v) for k, v in aux.items()},
                grads=[n(p.grad).copy() for p in state.params],
                params=[n(p).copy() for p in state.params])


@pytest.fixture(scope="module")
def step_off():
    return _step("off")


@pytest.mark.parametrize("mode", ["selective", "coarse"])
def test_remat_modes_step_bit_equal(step_off, mode):
    """The recompute replays the same float32 operations, and the autograd
    graph is the same: the step is bit for bit the step without remat."""
    got = _step(mode)
    assert got["aux"].keys() == step_off["aux"].keys()
    for k, v in step_off["aux"].items():
        assert np.array_equal(got["aux"][k], v), k
    assert step_off["aux"]["grad_norm"] > 0 and np.isfinite(step_off["aux"]["loss"])
    for key in ("grads", "params"):
        for i, (a, b) in enumerate(zip(got[key], step_off[key])):
            assert np.array_equal(a, b), (key, i)


def test_default_mode_is_the_training_parity_mode():
    """tests/test_torch_training.py's train-step parity runs both packages
    at their default encoder config: selective remat, float32."""
    jcfg, tcfg = _cfgs()
    for cfg in (jcfg.encoder, tcfg.encoder):
        assert (cfg.remat, cfg.remat_mode, cfg.unet_dtype, cfg.costvolume_dtype) == (
            True, "selective", "float32", "float32")
    assert tcfg.encoder.remat_policy == "selective"
    assert EncoderCfg().remat_policy == "selective"


def _saved_by_encoder_forward(mode: str, chunk: int) -> list[tuple[tuple, int]]:
    """(shape, bytes) of every tensor autograd saves in one encoder forward."""
    model = _model(mode, chunk)
    b = _batch()["context"]
    frozen, corr = model.perceive(b["image"], b["intrinsics"])
    saved = []

    def pack(x):
        saved.append((tuple(x.shape), x.numel() * x.element_size()))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        model.encoder(b["image"], b["intrinsics"], b["near"], b["far"], frozen, corr, 0,
                      generator=torch.Generator().manual_seed(5))
    return saved


def test_saved_tensors_no_warped_chunk_and_ordered():
    """A warped chunk is (v b, chunk, h/4, w/4, d_feature) = (2, 4, 8, 8, 32)
    here. The unchunked sweep (one pass over all 16 candidates, which is not
    recomputed) shows that the accounting sees such a volume."""
    enc = _cfgs()[1].encoder
    whole = (2, enc.num_depth_candidates, H // 4, W // 4, enc.d_feature)
    assert whole in {s for s, _ in _saved_by_encoder_forward("off", 16)}
    chunk = (2, 4, H // 4, W // 4, enc.d_feature)
    total = {}
    for mode in MODES:
        saved = _saved_by_encoder_forward(mode, 4)
        assert chunk not in {s for s, _ in saved}, mode
        total[mode] = sum(nbytes for _, nbytes in saved)
    assert total["off"] > total["selective"] >= total["coarse"], total


def test_tiled_saves_no_chunk_alphas():
    """The `tiled` backend's chunks are recomputed in the backward: its
    forward saves none of a chunk's (tiles, pixels, chunk) alphas, which one
    chunk computed outside the recompute does save."""
    rng = np.random.default_rng(0)
    tiles, cap, chunk, ch, ts = 3, 16, 8, 3, 4
    p = ts * ts
    feat = np.concatenate([rng.uniform(0, ts, (tiles, cap, 2)),
                           np.tile([0.5, 0.0, 0.5], (tiles, cap, 1)),
                           rng.uniform(0, 1, (tiles, cap, ch)),
                           rng.uniform(0.3, 0.9, (tiles, cap, 1))], -1)
    gathered = t(feat).requires_grad_(True)
    valid = torch.ones((tiles, cap), dtype=torch.bool)
    px = t(rng.uniform(0, ts, (tiles, p)))
    py = t(rng.uniform(0, ts, (tiles, p)))
    config = RasterizeConfig(tile_size=ts, tile_capacity=cap, chunk=chunk)
    alphas = (tiles, p, chunk)

    def saved_shapes(fn):
        shapes = set()

        def pack(x):
            shapes.add(tuple(x.shape))
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            fn()
        return shapes

    def one_chunk():
        data = gathered[:, :chunk]
        alpha = gaussian_alpha(px, py, data[..., 0:2], data[..., 2:5], data[..., 5 + ch],
                               valid[:, :chunk], config)
        composite_chunk(alpha, data[..., 5:5 + ch], torch.ones((tiles, p)),
                        torch.zeros((tiles, p, ch)), config)

    assert alphas in saved_shapes(one_chunk)
    out = []
    assert alphas not in saved_shapes(lambda: out.append(composite_tables(
        gathered, valid, px, py, torch.zeros(ch), ch, config)))
    out[0].sum().backward()
    assert gathered.grad is not None and torch.isfinite(gathered.grad).all()


def _random_tree(shapes, seed: int):
    """Random float32 parameters of a JAX parameter tree's shapes: kernels
    N(0, 1 / fan_in), scales 1 + N(0, 0.1), the rest N(0, 0.1) (no zero
    init, so every path carries signal)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _both(jmodule, tmodule_of, args, seed: int):
    """Outputs of the JAX module and of the port's, at float32 and at
    bfloat16, with the same random parameters loaded through `weights.py`
    -> {dtype: (JAX outputs, port outputs)} as lists of numpy arrays. The
    JAX module is compiled with `xla_allow_excess_precision` off, so each op
    is rounded to the dtype flax gives it, as when it runs op by op (XLA's
    default may skip bfloat16 roundings between ops)."""
    jargs = [jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(jmodule("float32").init, jax.random.PRNGKey(0), *jargs)["params"]
    tree = _random_tree(shapes, seed)
    out = {}
    for dt in ("float32", "bfloat16"):
        j = jax.jit(jmodule(dt).apply).lower({"params": tree}, *jargs).compile(
            compiler_options={"xla_allow_excess_precision": False})({"params": tree}, *jargs)
        tm = tmodule_of(dt)
        load_flat(tm, flatten(tree), [], "test")
        with torch.no_grad():
            p = tm(*(t(a) for a in args))
        j, p = (j, p) if isinstance(j, tuple) else ((j,), (p,))
        assert all(x.dtype == jnp.float32 for x in j) and all(x.dtype == torch.float32 for x in p)
        out[dt] = ([np.asarray(x) for x in j], [n(x) for x in p])
    return out


def _bf16_switch_is_on(out, parity_f32):
    """bfloat16 moves each output, in both packages, by more than ten times
    the float32 parity error."""
    for k, (jf, pf) in enumerate(zip(*out["float32"])):
        jb, pb = out["bfloat16"][0][k], out["bfloat16"][1][k]
        for bf, f in ((jb, jf), (pb, pf)):
            assert np.abs(bf - f).max() > 10 * parity_f32[k], k


def test_unet_bf16_matches_jax():
    """Identical inputs: the bfloat16 convolutions round the same sums, so
    the two packages' bfloat16 U-Nets differ by at most one bfloat16 step of
    the largest output (measured: bit-equal)."""
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 16)).astype(np.float32)
    kw = dict(attention_resolutions=(2,), channel_mult=(1, 1), num_views=2)
    out = _both(
        lambda dt: JUNet(model_channels=16, out_channels=16, dtype=jnp.dtype(dt), **kw),
        lambda dt: UNetModel(16, 16, 16, dtype=getattr(torch, dt), **kw), (x,), seed=2)
    (jf,), (pf,) = out["float32"]
    (jb,), (pb,) = out["bfloat16"]
    scale = np.abs(jf).max()
    # float32: the attention's bf16-rounded operands (tests/test_torch_model.py)
    np.testing.assert_allclose(pf, jf, rtol=2e-3, atol=2e-3 * scale)
    np.testing.assert_allclose(pb, jb, rtol=0, atol=BF16_STEP * scale)
    _bf16_switch_is_on(out, [np.abs(pf - jf).max()])


def test_costvolume_warp_bf16_matches_jax():
    """The plane sweep at costvolume_dtype=bfloat16 gathers bfloat16
    features and interpolates them with float32 weights into a float32
    sample, in both packages: float32 parity on the bfloat16-rounded
    features."""
    rng = np.random.default_rng(6)
    feat = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    k = np.broadcast_to(np.array([[7.0, 0, 3.5], [0, 6.0, 3.0], [0, 0, 1]]),
                        (2, 3, 3)).astype(np.float32)
    pose = np.broadcast_to(np.eye(4), (2, 4, 4)).copy().astype(np.float32)
    pose[:, 0, 3] = [0.3, -0.2]
    depth = rng.uniform(1, 10, (2, 4)).astype(np.float32)
    j16 = jwarp(jnp.asarray(feat, jnp.bfloat16), *map(jnp.asarray, (k, pose, depth)))
    p16 = warp_with_pose_depth_candidates(t(feat).bfloat16(), t(k), t(pose), t(depth))
    assert j16.dtype == jnp.float32 and p16.dtype == torch.float32
    np.testing.assert_allclose(n(p16), np.asarray(j16), rtol=1e-5, atol=1e-6)
    p32 = warp_with_pose_depth_candidates(t(feat), t(k), t(pose), t(depth))
    assert np.abs(n(p16) - n(p32)).max() > 1e-3


def test_depth_predictor_bf16_matches_jax():
    """unet_dtype = costvolume_dtype = bfloat16 in both packages. The U-Nets'
    inputs differ by float32 round-off; their bfloat16 layers spread that to
    a few bfloat16 steps over the outputs, as far as bfloat16 moves either
    package from float32 (measured: max 0.38% and 1.0%, mean 0.05% and 0.11%
    of the largest output; JAX's bfloat16 against its float32: max 0.47%
    and 1.4%). Held: max 8 steps, mean 1 step."""
    rng = np.random.default_rng(3)
    b, v, h4, d, c = 1, 2, 8, 16, 16
    extr = np.broadcast_to(np.eye(4), (b, v, 4, 4)).copy().astype(np.float32)
    extr[:, 1, 0, 3] = -0.3
    args = (rng.standard_normal((b, v, h4, h4, c)).astype(np.float32),
            np.broadcast_to(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]),
                            (b, v, 3, 3)).astype(np.float32),
            extr, np.ones((b, v), np.float32), np.full((b, v), 20.0, np.float32),
            rng.uniform(0, 1, (v * b, 4 * h4, 4 * h4, 3)).astype(np.float32),
            rng.uniform(0.05, 1, (v * b, 4 * h4, 4 * h4, 1)).astype(np.float32),
            np.eye(d, dtype=np.float32)[rng.integers(0, d, (v * b, h4, h4))])
    kw = dict(feature_channels=c, num_depth_candidates=d, costvolume_unet_feat_dim=16,
              costvolume_unet_channel_mult=(1, 1), costvolume_unet_attn_res=(2,),
              gaussian_raw_channels=12, depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
              depth_unet_channel_mult=(1, 1, 1), costvolume_scan_chunk=4)
    out = _both(
        lambda dt: JDepthPredictor(JDepthPredictorCfg(**kw, unet_dtype=dt, costvolume_dtype=dt)),
        lambda dt: DepthPredictorMultiView(DepthPredictorCfg(**kw, unet_dtype=dt,
                                                             costvolume_dtype=dt)),
        args, seed=4)
    parity = []
    for (jf, pf), (jb, pb) in zip(zip(*out["float32"]), zip(*out["bfloat16"])):
        scale = np.abs(jf).max()
        np.testing.assert_allclose(pf, jf, rtol=1e-3, atol=1e-3 * scale)
        parity.append(np.abs(pf - jf).max())
        diff = np.abs(pb - jb)
        assert diff.max() <= 8 * BF16_STEP * scale and diff.mean() <= BF16_STEP * scale, (
            diff.max() / scale, diff.mean() / scale)
    _bf16_switch_is_on(out, parity)


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_params_of_each_remat_mode_load(mode):
    """The JAX encoder's parameter tree under remat=false, "selective"
    (its U-Nets named CheckpointUNetModel_k) and "coarse" (a remat'ed depth
    predictor, still named `depth_predictor`) loads into the port: every
    tensor carried, values equal."""
    jcfg = dataclasses.replace(tiny_cfg(), **MODES[mode])
    scene = synthetic_scene(v=2)
    args = (*(jnp.asarray(scene[k]) for k in ("images", "intrinsics", "near", "far")),
            jax.tree_util.tree_map(jnp.asarray, scene["frozen"]),
            jax.tree_util.tree_map(jnp.asarray, scene["corr"]), jnp.asarray(0),
            jax.random.PRNGKey(0))
    shapes = jax.eval_shape(JEncoder(jcfg).init, jax.random.PRNGKey(1), *args)["params"]
    unets = sorted(k for k in shapes["depth_predictor"] if "UNetModel" in k)
    want = ["CheckpointUNetModel_0", "CheckpointUNetModel_1"] if mode == "selective" else [
        "UNetModel_0", "UNetModel_1"]
    assert unets == want
    tree = _random_tree(shapes, seed=7)
    fields = {f.name for f in dataclasses.fields(EncoderCfg)} - {"gaussian_adapter"}
    tenc = PoseFreeEncoder(EncoderCfg(**{k: getattr(jcfg, k) for k in fields},
                                      gaussian_adapter=GaussianAdapterCfg(sh_degree=1)))
    assert tenc.cfg.remat_policy == mode
    # every port tensor from one JAX leaf and every leaf used, or it raises
    flat = flatten(tree)
    load_flat(tenc, flat, ENCODER_RULES, "encoder")
    for name, p in tenc.named_parameters():
        assert np.array_equal(n(p), jax_leaf(flat, name, ENCODER_RULES, "encoder")[1]), name
