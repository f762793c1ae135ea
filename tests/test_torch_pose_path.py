"""The encoder's pose path against the JAX package, on the CPU, on a scene
whose cameras rotate.

The model tests (tests/test_torch_model.py, test_torch_model_v5.py) hold the
pose stage against JAX on a z=4 wall seen by cameras that only translate,
so every true rotation there is the identity and camera sync synchronises
identities. Here the scene of `torch_pose_scene.py` (a non-planar roof;
cameras turning a few degrees and moving ~0.15 of the depth a view) gives
the Kabsch fits, the spectral sync and `so3_project` non-identity rotations:

  * the encoder's pose stage (RANSAC, confidences, sync, the refinement
    transformer with a live pose head) at the model test's tiny config
    (reduced as tests/test_torch_aux.py reduces it for its train step),
    against JAX at the model test's tolerance (poses 2e-3), and its
    recovery of the scene's true motion;
  * `pose_loss` and its gradient with respect to the refined poses, the
    points and the depths, against JAX (value rtol 1e-5, gradients 1e-4 of
    their largest entry);
  * one `make_train_step` on the scene against the JAX `make_train_step`
    (tests/test_torch_aux.py's tolerances: the pose loss and gradient norm
    rtol 1e-3, the gradients in Adam's first moment 1e-2 a tensor);
  * `camera_synchronization` on mixed confidences, one pair below
    `confidence_min`, and on none (the chain fallback), against JAX (1e-4);
  * `so3_project` on reflections and near-reflections (det -> -1) against
    JAX (1e-5).

The RANSAC noise is the JAX encoder's own draws (`jax_ransac_noise`), so
both sides take the same hypotheses.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.geometry import camera_sync as jsync
from pf3plat_tpu.geometry.transforms import so3_project as jso3_project
from pf3plat_tpu.models.decoder import DecoderCfg as JDecoderCfg
from pf3plat_tpu.models.encoder import (
    Correspondences as JCorr, EncoderCfg as JEncoderCfg, FrozenInputs as JFrozen,
    PoseFreeEncoder as JEncoder)
from pf3plat_tpu.models.gaussian_adapter import GaussianAdapterCfg as JAdapterCfg
from pf3plat_tpu.ops.rasterizer import RasterizeConfig as JRasterCfg
from pf3plat_tpu.training import losses as jlosses, train as jtrain

from pf3plat_tpu_torch.geometry import camera_sync
from pf3plat_tpu_torch.geometry.transforms import so3_project
from pf3plat_tpu_torch.models.decoder import DecoderCfg
from pf3plat_tpu_torch.models.encoder import (
    Correspondences, EncoderCfg, FrozenInputs, PoseFreeEncoder)
from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig
from pf3plat_tpu_torch.training import losses, train
from pf3plat_tpu_torch.weights import ENCODER_RULES, flatten, jax_leaf

from test_torch_helpers import _no_tf32, jax_tree_from_port, n, one_thread, t  # noqa: F401
from test_torch_model import ENC, jax_ransac_noise
from torch_pose_scene import (
    live_pose_head, pose_errors, pose_scene, rotation_deg, view_pairs)

pytestmark = pytest.mark.usefixtures("one_thread")

B, V, H, W, M = 1, 3, 32, 32, 64
CORR = ("kpts0", "kpts1", "scores", "valid")
# The model test's tiny encoder reduced as tests/test_torch_aux.py reduces it
# for its train step (one attention layer, 8 hypotheses, U-Nets without
# attention): the JAX step's trace and compile take most of this file's
# time.
TINY = dict(ENC, n_attn_layers=1, ransac_samples=8, depth_unet_channel_mult=(1, 1),
            depth_unet_attn_res=(), costvolume_unet_attn_res=())

def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=rtol, atol=atol)


def _jax_args(scene: dict, key):
    return (*(jnp.asarray(scene[k]) for k in ("images", "intrinsics", "near", "far")),
            JFrozen(jnp.asarray(scene["depth"]), jnp.asarray(scene["features"])),
            JCorr(*(jnp.asarray(scene[k]) for k in CORR)), jnp.asarray(0), key)


def _port_inputs(scene: dict):
    return ((*(t(scene[k]) for k in ("images", "intrinsics", "near", "far")),
             FrozenInputs(t(scene["depth"]), t(scene["features"])),
             Correspondences(*(t(scene[k]) for k in CORR))))


@pytest.fixture(scope="module")
def scene():
    return pose_scene(B, V, H, W, M, seed=0, feature_shape=(8, 8, ENC["d_backbone"]))


@pytest.fixture(scope="module")
def models(scene):
    """The port's encoder from seed 0 with a live pose head, the JAX encoder
    and its parameter tree holding the same numbers."""
    torch.manual_seed(0)
    tenc = PoseFreeEncoder(EncoderCfg(**TINY, gaussian_adapter=GaussianAdapterCfg(sh_degree=1)))
    live_pose_head(tenc)
    jenc = JEncoder(JEncoderCfg(**TINY, gaussian_adapter=JAdapterCfg(sh_degree=1)))
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(1),
                            *_jax_args(scene, jax.random.PRNGKey(0)))
    tree = jax_tree_from_port(tenc, shapes["params"], ENCODER_RULES, "encoder")
    return tenc, jenc, jax.tree_util.tree_map(jnp.asarray, {"params": tree})


@pytest.fixture(scope="module")
def encoded(models, scene):
    """Both encoders' outputs on the scene, same parameters and noise."""
    tenc, jenc, params = models
    key = jax.random.PRNGKey(11)
    jout = jax.jit(jenc.apply)(params, *_jax_args(scene, key))
    noise = jax_ransac_noise(key, B, V * (V - 1) // 2, TINY["ransac_samples"], M)
    with torch.no_grad():
        tout = tenc(*_port_inputs(scene), 0, ransac_noise=t(noise))
    return tout, jout


@pytest.mark.parametrize("field,tol", [
    ("pairwise_poses", 2e-3), ("sync_poses", 2e-3), ("refined_poses", 2e-3),
    ("pair_confidences", 1e-5)])
def test_pose_stage_against_jax(encoded, field, tol):
    tout, jout = encoded
    _close(getattr(tout, field), getattr(jout, field), atol=tol)


def test_refinement_moves_the_poses(encoded):
    """The live pose head moves the refined poses off the synchronised ones
    (so the comparison above holds the refinement transformer too)."""
    tout, _ = encoded
    assert float((tout.refined_poses - tout.sync_poses).abs().max()) > 1e-2


@pytest.mark.parametrize("field", ["pairwise_poses", "sync_poses"])
def test_recovers_the_true_motion(encoded, scene, field):
    """The coarse (cam_i -> cam_j) and synchronised (view 0 -> view k) poses
    recover the scene's rotations to 1.5 degrees and its translation
    directions to 5 (32 x 32 pixels: half a pixel of quantisation is ~0.06
    of the ~4 depth), as the JAX package does to 0.05 degrees of it."""
    truth = scene["rel"] if field == "pairwise_poses" else np.linalg.inv(scene["c2w"])
    moving = rotation_deg(truth[..., :3, :3], np.eye(3))
    assert moving[moving > 0].min() > 2.0  # every true rotation is a real one
    tout, jout = encoded
    got = pose_errors(n(getattr(tout, field)), truth)
    ref = pose_errors(np.asarray(getattr(jout, field)), truth)
    assert got["rot_deg_max"] < 1.5 and got["trans_deg_max"] < 5.0, got
    for k in got:
        assert abs(got[k] - ref[k]) < 0.05, (k, got, ref)


@pytest.mark.parametrize("rel_weight", [0.0, 0.5])
def test_pose_loss_and_gradient_against_jax(encoded, scene, rel_weight):
    """`pose_loss` on the encoder's outputs (the port's refined poses, points
    and depths handed to both sides) and its gradient with respect to those
    three; with `pose_weight_rel` > 0 also under the coarse poses."""
    tout, jout = encoded
    cfg_t = losses.LossCfg(pose_weight_rel=rel_weight)
    cfg_j = jlosses.LossCfg(pose_weight_rel=rel_weight)
    leaves = [n(x) for x in (tout.refined_poses, tout.xyz, tout.depths)]
    intr = scene["intrinsics"]
    jenc = jout._replace(pairwise_poses=jnp.asarray(n(tout.pairwise_poses)),
                         pair_confidences=jnp.asarray(n(tout.pair_confidences)))

    def jloss(refined, xyz, depths):
        return jlosses.pose_loss(jenc._replace(refined_poses=refined, xyz=xyz, depths=depths),
                                 jnp.asarray(intr), cfg_j)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, leaves))
    xs = [torch.tensor(x, requires_grad=True) for x in leaves]
    tval = losses.pose_loss(tout._replace(refined_poses=xs[0], xyz=xs[1], depths=xs[2]),
                            t(intr), cfg_t)
    tval.backward()
    assert float(tval) > 0
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    for x, g in zip(xs, jgrads):
        g = np.asarray(g)
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(n(x.grad), g, rtol=0, atol=1e-4 * np.abs(g).max())


@pytest.fixture(scope="module")
def train_step(models, scene):
    """One `make_train_step` on both sides on the scene (tiled decoder,
    LossCfg(ssim_weight=0), as tests/test_torch_aux.py), the JAX noise
    handed to the port. Returns the port encoder and (JAX aux, port aux,
    JAX state, port state)."""
    tenc, jenc, params = models
    tenc = copy.deepcopy(tenc)  # the step updates its parameters in place
    key = jax.random.PRNGKey(100)
    args = _jax_args(scene, key)
    raster = dict(tile_size=16, tile_capacity=256, chunk=64)
    jopt = jtrain.make_optimizer(jtrain.OptimizerCfg(lr=1e-3, max_steps=100))
    jstep = jax.jit(jtrain.make_train_step(
        jenc, JDecoderCfg(impl="tiled", raster=JRasterCfg(**raster)),
        jlosses.LossCfg(ssim_weight=0.0), jopt, (H, W)))
    jbatch = {"context": dict(zip(("image", "intrinsics", "near", "far"), args[:4])),
              "target": {"image": args[0]}, "frozen": args[4], "corr": args[5]}
    jstate, jaux = jstep(jtrain.init_train_state({"encoder": params}, jopt), jbatch, key)

    topt = train.make_optimizer(train.OptimizerCfg(lr=1e-3, max_steps=100))
    tstep = train.make_train_step(
        tenc, DecoderCfg(impl="tiled", raster=RasterizeConfig(**raster)),
        losses.LossCfg(ssim_weight=0.0), topt, (H, W))
    images, intr, near, far, frozen, corr = _port_inputs(scene)
    tbatch = {"context": {"image": images, "intrinsics": intr, "near": near, "far": far},
              "target": {"image": images}, "frozen": frozen, "corr": corr}
    noise = t(jax_ransac_noise(key, B, V * (V - 1) // 2, TINY["ransac_samples"], M))
    tparams = list(tenc.parameters())
    tstate, taux = tstep(train.TrainState(tparams, topt.init(tparams), 0), tbatch,
                         ransac_noise=noise)
    return tenc, (jax.tree_util.tree_map(np.asarray, jaux), {k: n(x) for k, x in taux.items()},
                  jstate, tstate)


def test_make_train_step_loss_parts(train_step):
    """The pose term is live (> 0) and agrees with JAX at rtol 1e-3 (it
    reaches the pose stacks' bf16 attention), as does the gradient norm;
    the photometric parts at 1e-4."""
    _, (jaux, taux, _, _) = train_step
    assert taux["pose"] > 0 and np.isfinite(taux["grad_norm"])
    for k in ("mse", "psnr", "loss"):
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-4, atol=1e-7, err_msg=k)
    for k in ("pose", "grad_norm"):
        np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-3, err_msg=k)


def test_make_train_step_gradients(train_step):
    """The step's gradients, read from Adam's first moment (0.1 x the
    clipped gradient), tensor by tensor in norm within 1e-2 of JAX's
    (tests/test_torch_aux.py's step-1 tolerance); the pose loss reaches the
    scale/shift head through the points and depths, and the pose head."""
    tenc, (_, _, jstate, tstate) = train_step
    names = [name for name, _ in tenc.named_parameters()]
    adam = jstate.opt_state.inner_state[1][0]
    flat = flatten(jax.tree_util.tree_map(np.asarray, adam.mu)["encoder"]["params"])
    mus = [jax_leaf(flat, name, ENCODER_RULES, "adam")[1] for name in names]
    top = max(np.linalg.norm(x) for x in mus)
    checked = set()
    for name, jmu, tmu in zip(names, mus, tstate.opt_state.mu):
        ref = np.linalg.norm(jmu)
        if ref > 1e-6 * top:  # gradients that vanish analytically hold round-off
            assert np.linalg.norm(n(tmu) - jmu) <= 1e-2 * ref, name
            checked.add(name)
    assert len(checked) > len(names) // 2
    assert {"pose_branch.Dense_1.weight", "scale_shift_predictor.Dense_1.weight"} <= checked


def _confidences(raw: np.ndarray, v: int, confidence_min: float = 0.5) -> np.ndarray:
    """The encoder's pair confidences from mean match scores (b, P):
    pairs of views that are not neighbours are shifted by `confidence_min`
    and rescaled, so a mean below it gives 0."""
    out = raw.copy()
    for p, (i, j) in enumerate(view_pairs(v)):
        if j - i > 1:
            out[:, p] = np.maximum(raw[:, p] - confidence_min, 0.0) / (1.0 - confidence_min)
    return out.astype(np.float32)


@pytest.mark.parametrize("v,raw", [
    # one non-neighbour pair below confidence_min (0.3 -> 0)
    (3, [[0.9, 0.3, 0.7]]),
    # mixed, two pairs below confidence_min, two rows
    (4, [[0.95, 0.45, 0.8, 0.6, 0.2, 0.85], [0.7, 0.9, 0.55, 0.9, 0.75, 0.6]]),
    # no confidence at all: the synchronised mass degenerates, the chain
    # fallback is taken
    (4, [[0.0] * 6]),
])
def test_camera_synchronization_mixed_confidences(v, raw):
    """Noisy pairwise poses of the rotating scene, synchronised with the
    encoder's confidences, against JAX (1e-4); the chain fallback where
    the confidences vanish."""
    raw = np.asarray(raw, np.float64)
    scene = pose_scene(raw.shape[0], v, 32, 32, 8, seed=v)
    rng = np.random.default_rng(v)
    rel = scene["rel"].astype(np.float64)
    for bi in range(rel.shape[0]):
        for p in range(rel.shape[1]):
            w = rng.normal(0, 0.02, 3)  # a small random rotation, then noise on t
            k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            rel[bi, p, :3, :3] = (np.eye(3) + k + k @ k / 2) @ rel[bi, p, :3, :3]
            rel[bi, p, :3, 3] += rng.normal(0, 0.02, 3)
    rel = rel.astype(np.float32)
    conf = _confidences(raw, v)
    pi, pj = (tuple(x) for x in zip(*view_pairs(v)))
    seq = [view_pairs(v).index((k, k + 1)) for k in range(v - 1)]
    jchain = jax.jit(jsync.camera_chaining)(jnp.asarray(rel[:, seq]))
    want = jax.jit(lambda r, c, f: jsync.camera_synchronization(r, c, pi, pj, v, fallback=f))(
        jnp.asarray(rel), jnp.asarray(conf), jchain)
    got = camera_sync.camera_synchronization(t(rel), t(conf), pi, pj, v,
                                             fallback=camera_sync.camera_chaining(t(rel[:, seq])))
    _close(got, want, atol=1e-4)
    if not conf.any():
        _close(got, jchain, atol=1e-5)
    else:
        # the synchronised poses stay near the truth
        assert pose_errors(n(got), np.linalg.inv(scene["c2w"]))["rot_deg_max"] < 5.0


@pytest.mark.parametrize("case", ["reflection", "near_singular_reflection",
                                  "near_rotation"])
def test_so3_project_near_reflections(case):
    """`so3_project` of matrices with det < 0 (distinct singular values, so
    the nearest rotation is unique), with a vanishing third singular value
    (det -> -0), and of noisy rotations, against JAX (1e-5): rotations come
    out (det +1, orthonormal)."""
    rng = np.random.default_rng(3)

    def rotations(k):
        q, r = np.linalg.qr(rng.standard_normal((k, 3, 3)))
        q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
        return q * np.linalg.det(q)[:, None, None]

    u, vt = rotations(16), rotations(16)
    sigma = {"reflection": [1.3, 1.0, -0.7], "near_singular_reflection": [1.1, 0.9, -1e-4],
             "near_rotation": [1.0, 1.0, 1.0]}[case]
    m = np.einsum("kij,j,kjl->kil", u, np.asarray(sigma), vt)
    if case == "near_rotation":
        m = m + rng.normal(0, 0.05, m.shape)
    m = m.astype(np.float32)
    got = so3_project(t(m))
    _close(got, jso3_project(jnp.asarray(m)), atol=1e-5)
    g = n(got).astype(np.float64)
    np.testing.assert_allclose(np.linalg.det(g), 1.0, atol=1e-5)
    np.testing.assert_allclose(g @ np.swapaxes(g, -1, -2), np.broadcast_to(np.eye(3), g.shape),
                               atol=1e-5)


def test_scene_is_consistent():
    """The shared scene's matches are the true motion: view i's points moved
    by the true cam_i -> cam_j transform land within half a pixel's depth
    step of view j's points, and every pair's true rotation is real."""
    s = pose_scene(2, 3, 64, 64, 32, seed=1)
    jj, ii = np.meshgrid(np.arange(64), np.arange(64))
    rays = np.stack([(jj + 0.5) / 64 - 0.5, (ii + 0.5) / 64 - 0.5, np.ones((64, 64))], -1)
    for p, (i, j) in enumerate(view_pairs(3)):
        for bi in range(2):
            k0 = s["kpts0"][bi, p].astype(int)
            k1 = s["kpts1"][bi, p].astype(int)
            xi = rays[k0[:, 1], k0[:, 0]] * s["depth"][bi, i, k0[:, 1], k0[:, 0], None]
            xj = rays[k1[:, 1], k1[:, 0]] * s["depth"][bi, j, k1[:, 1], k1[:, 0], None]
            r = s["rel"][bi, p]
            assert np.abs(xi @ r[:3, :3].T + r[:3, 3] - xj).max() < 0.05
            assert rotation_deg(r[:3, :3], np.eye(3)) > 2.0


@pytest.mark.parametrize("site", ["kabsch", "sync", "pose_loss", "pose_errors"])
def test_pose_path_runs_exact_under_the_policy(models, encoded, scene, site, monkeypatch):
    """With TF32 allowed (the declared policy on the card), the pose path's
    geometry still runs with TF32 off: the RANSAC fits, the camera sync,
    the pose loss forward and in its backward, and the evaluator's pose
    errors (on an H100, TF32 moved five views' synchronised poses by 0.09
    and the coarse fits by 2.5e-3: chip_smoke.py phase pose_path)."""
    from pf3plat_tpu_torch.geometry import procrustes
    from pf3plat_tpu_torch.training import metrics

    owner, name = {"kabsch": (procrustes, "weighted_kabsch"),
                   "sync": (camera_sync, "camera_synchronization"),
                   "pose_loss": (losses, "_pose_loss"),
                   "pose_errors": (metrics, "geodesic_distance")}[site]
    seen = []
    inner = getattr(owner, name)

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return inner(*args, **kwargs)

    monkeypatch.setattr(owner, name, spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    tenc, _, _ = models
    tout, _ = encoded
    if site in ("kabsch", "sync"):
        noise = torch.zeros((B, V * (V - 1) // 2, TINY["ransac_samples"], M))
        with torch.no_grad():
            tenc(*_port_inputs(scene), 0, ransac_noise=noise)
    elif site == "pose_loss":
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (tout.refined_poses, tout.xyz, tout.depths)]
        losses.pose_loss(tout._replace(refined_poses=leaves[0], xyz=leaves[1], depths=leaves[2]),
                         t(scene["intrinsics"]), losses.LossCfg()).backward()
        assert len(seen) == 2  # the forward and the backward's recompute
    else:
        metrics.pose_errors(torch.linalg.inv(tout.refined_poses), t(scene["c2w"]))
    assert seen and not any(any(flags) for flags in seen), seen
    assert torch.backends.cuda.matmul.allow_tf32  # the policy is back outside
