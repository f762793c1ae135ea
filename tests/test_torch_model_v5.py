"""The serving request's view count, v=5, through the whole forward: the
port's `PF3plat.forward` against the JAX package's, on the CPU.

The serving protocol splices 2 context and 3 target views into one sorted
stack of 5 (context first and last), so 10 view pairs go through RANSAC and
camera sync, the first-to-last pair among them, and the evaluator keeps the
targets' renders as `slice(1, -1)` (`evaluation/evaluator.py`). The model
test (tests/test_torch_model.py) holds v=3 only.

The port's random init is carried into the JAX trees
(`test_torch_helpers.jax_tree_from_port`, the inverse of the port's loader),
so only the JAX forward and perception compile. Both sides run the tiny
config of the model test at its precision (frozen perception "highest")
with the same RANSAC noise, and are held at its tolerances: keypoints and
match masks exactly, depths, features, scores and poses 2e-3, gaussians and
colours 5e-3.

  * perception of the five views (UniDepth, SuperPoint, LightGlue over the
    10 pairs). Random weights keep no match, as on the card;
  * the forward with perception's outputs replaced, on both sides, by a
    wall seen by cameras 0.2 apart with 64 exact matches a pair, so RANSAC
    and camera sync run on real matches in all 10 pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.models.pf3plat import PF3plat as JPF3plat, PF3platParams

from pf3plat_tpu_torch.models.pf3plat import PF3plat
from pf3plat_tpu_torch.weights import ENCODER_RULES, LIGHTGLUE_RULES, UNIDEPTH_RULES

from test_torch_helpers import _no_tf32, jax_tree_from_port, n, one_thread, t  # noqa: F401
from test_torch_model import ENC, _cfgs, jax_ransac_noise

V = 5
PAIRS = V * (V - 1) // 2
M = 64  # matches a pair
TARGETS = slice(1, -1)  # the evaluator's target views of the splice


def _inputs_v5():
    """Five views of the model test's smooth textured scene, each shifted two
    pixels further: context views 0 and 4, targets 1-3."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32), indexing="ij")
    base = np.stack([np.sin(7 * xx + 3 * yy), np.cos(5 * yy - 2 * xx), np.sin(4 * xx * yy)], -1)
    images = np.stack([
        np.clip(0.5 + 0.4 * np.roll(base, 2 * k, axis=1) + 0.05 * rng.standard_normal(base.shape),
                0, 1) for k in range(V)])[None].astype(np.float32)
    intr = np.broadcast_to(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]),
                           (1, V, 3, 3)).astype(np.float32)
    return images, intr, np.ones((1, V), np.float32), np.full((1, V), 100.0, np.float32)


def _wall_perception(seed=0):
    """Perception's outputs for a z=4 wall seen by cameras translated 0.2
    apart along x (the model test's `_synthetic_encoder_inputs` at v=5):
    depth, random features, and M exact correspondences in every pair."""
    rng = np.random.default_rng(seed)
    depth = np.full((1, V, 32, 32), 4.0, np.float32)
    feats = rng.standard_normal((1, V, 8, 8, ENC["d_backbone"])).astype(np.float32)
    k0 = np.zeros((1, PAIRS, M, 2), np.float32)
    k1 = np.zeros_like(k0)
    for p, (i, j) in enumerate((i, j) for i in range(V) for j in range(i + 1, V)):
        # x in [-1, 1.5]: every view, 0.8 apart at most, sees every point
        pts = np.stack([rng.uniform(-1.0, 1.5, (1, M)), rng.uniform(-1.5, 1.5, (1, M)),
                        np.full((1, M), 4.0)], axis=-1)
        for view, arr in ((i, k0), (j, k1)):
            arr[:, p, :, 0] = (pts[..., 0] - 0.2 * view) / pts[..., 2] * 32 + 16
            arr[:, p, :, 1] = pts[..., 1] / pts[..., 2] * 32 + 16
    return (depth, feats), (k0, k1, np.full((1, PAIRS, M), 0.9, np.float32),
                            np.ones((1, PAIRS, M), bool))


@pytest.fixture(scope="module")
def models():
    """The port's tiny model from a seed, and the JAX model and parameters
    holding the same numbers."""
    jcfg, tcfg = _cfgs()
    torch.manual_seed(3)
    tm = PF3plat(tcfg, device="cpu")
    # LightGlue's per-layer assignment heads: only the last runs, and the
    # JAX tree holds that one
    heads = tm.lightglue.log_assignment
    for head in heads[:-1]:
        head.load_state_dict(heads[-1].state_dict())
    jm = JPF3plat(jcfg)
    inputs = _inputs_v5()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))
    trainable = {"params": jax_tree_from_port(tm.encoder, shapes.trainable["params"],
                                              ENCODER_RULES, "encoder")}
    frozen = {k: {"params": jax_tree_from_port(getattr(tm, k), shapes.frozen[k]["params"],
                                               rules, k)}
              for k, rules in (("unidepth", UNIDEPTH_RULES), ("superpoint", []),
                               ("lightglue", LIGHTGLUE_RULES), ("lpips", []))}
    params = PF3platParams(jax.tree_util.tree_map(jnp.asarray, trainable),
                           jax.tree_util.tree_map(jnp.asarray, frozen))
    return tm, jm, params, inputs


@pytest.fixture(scope="module")
def perceived(models):
    tm, jm, params, (images, intr, _, _) = models
    jout = jax.jit(jm.perceive)(params.frozen, jnp.asarray(images), jnp.asarray(intr))
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tout = tm.perceive(t(images), t(intr))
    finally:
        torch.set_num_threads(old)
    return tout, jout


@pytest.fixture(scope="module")
def forward_v5(models):
    """Both `forward`s on the five views with the wall's perception and the
    same RANSAC noise."""
    from pf3plat_tpu.models.encoder import Correspondences as JCorr, FrozenInputs as JFrozen
    from pf3plat_tpu_torch.models.encoder import Correspondences, FrozenInputs

    tm, jm, params, inputs = models
    (depth, feats), corr = _wall_perception()
    jm.perceive = lambda frozen, images, intr: (
        JFrozen(jnp.asarray(depth), jnp.asarray(feats)), JCorr(*(jnp.asarray(a) for a in corr)))
    rng = jax.random.PRNGKey(7)
    jenc, jout = jax.jit(jm.forward)(params, *(jnp.asarray(a) for a in inputs), jnp.asarray(0),
                                     rng)
    noise = jax_ransac_noise(rng, 1, PAIRS, ENC["ransac_samples"], M)
    tm.perceive = lambda images, intr: (FrozenInputs(t(depth), t(feats)),
                                        Correspondences(*(t(a) for a in corr)))
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            tenc, tout = tm(*(t(a) for a in inputs), 0, ransac_noise=t(noise))
    finally:
        torch.set_num_threads(old)
        del tm.perceive
    return tenc, tout, jenc, jout


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=rtol, atol=atol)


def test_perception_of_five_views(perceived):
    """Depth and features per view; keypoints, match masks and scores of all
    10 pairs (random LightGlue weights keep no match)."""
    (tf, tc), (jf, jc) = perceived
    _close(tf.depth, jf.depth, rtol=2e-3, atol=2e-3)
    _close(tf.features, jf.features, rtol=2e-3, atol=2e-3)
    assert tc.valid.shape == (1, PAIRS, 32)
    np.testing.assert_array_equal(n(tc.valid), np.asarray(jc.valid))
    np.testing.assert_array_equal(n(tc.kpts0), np.asarray(jc.kpts0))
    np.testing.assert_array_equal(n(tc.kpts1), np.asarray(jc.kpts1))
    _close(tc.scores, jc.scores, rtol=2e-3, atol=2e-3)


def test_poses_through_ransac_and_camera_sync(forward_v5):
    """All 10 pairwise poses, the first-to-last pair (pair 3 of (0, 1), (0,
    2), (0, 3), (0, 4), (1, 2), ...: a 0.8 shift along -x) recovered, the
    synchronised and refined poses of the 5 views, the confidences."""
    te, _, je, _ = forward_v5
    assert te.pairwise_poses.shape[:2] == (1, PAIRS) and te.refined_poses.shape[:2] == (1, V)
    np.testing.assert_allclose(n(te.pairwise_poses)[0, V - 2, :3, 3], [-0.8, 0, 0], atol=0.05)
    _close(te.depths, je.depths, rtol=2e-3, atol=2e-3)
    _close(te.pairwise_poses, je.pairwise_poses, atol=2e-3)
    _close(te.sync_poses, je.sync_poses, atol=2e-3)
    _close(te.refined_poses, je.refined_poses, atol=2e-3)
    _close(te.pair_confidences, je.pair_confidences)


def test_gaussians_and_the_targets_renders(forward_v5):
    te, tout, je, jout = forward_v5
    for f in ("means", "covariances", "harmonics", "opacities"):
        _close(getattr(te.gaussians, f), getattr(je.gaussians, f), rtol=5e-3, atol=5e-3)
    assert tout.color.shape == (1, V, 32, 32, 3)
    _close(tout.color[:, TARGETS], jout.color[:, TARGETS], rtol=5e-3, atol=5e-3)
