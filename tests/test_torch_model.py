"""Parity of the port's models (pf3plat_tpu_torch.models) with the JAX
package, on the CPU, through `weights.load_jax_params`.

One tiny PF3plat is initialized on the JAX side (UniDepth tiny_test, the
tests/test_encoder.py encoder config, 64 keypoints, 2 LightGlue layers,
streamed decoder with compaction on), its parameters are carried into the
port, and: each module of port-order steps 8-14 is run on both sides on the
same numpy inputs, then the whole serving forward (step 15) on v=3 32x32
images with the same RANSAC noise.

Tolerances: float32 math is held to rtol 1e-4 / atol 1e-5 where the chain
is short. Attention rounds its inputs to bf16 on both sides (the JAX
`mxu_einsum`); f32 summation-order differences before that rounding can
flip a bf16 rounding (2^-8 relative), so modules with attention get
atol/rtol 2e-3, and the whole slice (many such layers in sequence) is
compared at the tolerances stated at each assertion. Discrete choices
(keypoints, matches, the mono-cue argmin, the RANSAC argmax through the
poses) are checked equal first.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.models.backbones.unidepth import UniDepthCfg as JUniDepthCfg
from pf3plat_tpu.models.decoder import DecoderCfg as JDecoderCfg
from pf3plat_tpu.models.encoder import EncoderCfg as JEncoderCfg
from pf3plat_tpu.models.gaussian_adapter import GaussianAdapterCfg as JAdapterCfg
from pf3plat_tpu.models.pf3plat import PF3plat as JPF3plat, PF3platCfg as JPF3platCfg
from pf3plat_tpu.ops.rasterizer import RasterizeConfig as JRasterCfg

from pf3plat_tpu_torch.models.backbones.unidepth import UniDepthCfg
from pf3plat_tpu_torch.models.decoder import DecoderCfg
from pf3plat_tpu_torch.models.encoder import EncoderCfg
from pf3plat_tpu_torch.models.gaussian_adapter import GaussianAdapterCfg
from pf3plat_tpu_torch.models.pf3plat import PF3plat, PF3platCfg
from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig
from pf3plat_tpu_torch.weights import load_jax_params

from test_torch_helpers import _no_tf32, n, t  # noqa: F401

B, V, H, W = 1, 3, 32, 32
ENC = dict(
    d_feature=32, d_backbone=128, num_depth_candidates=16, multiview_trans_attn_split=2,
    n_attn_layers=2, d_pose=32, pose_heads=4, ransac_samples=32,
    costvolume_unet_feat_dim=16, costvolume_unet_channel_mult=(1, 1),
    costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8, depth_unet_attn_res=(4,),
    depth_unet_channel_mult=(1, 1, 1),
)
RASTER = dict(pairs_budget_factor=0.6, compact_min_pairs=0)
TOP = dict(max_keypoints=64, max_matches=32, lightglue_layers=2)


def _cfgs():
    jcfg = JPF3platCfg(
        encoder=JEncoderCfg(**ENC, gaussian_adapter=JAdapterCfg(sh_degree=1)),
        decoder=JDecoderCfg(raster=JRasterCfg(**RASTER)),
        unidepth=JUniDepthCfg.tiny_test(), frozen_matmul_precision="highest", **TOP)
    tcfg = PF3platCfg(
        encoder=EncoderCfg(**ENC, gaussian_adapter=GaussianAdapterCfg(sh_degree=1)),
        decoder=DecoderCfg(raster=RasterizeConfig(**RASTER)),
        unidepth=UniDepthCfg.tiny_test(), frozen_matmul_precision="highest", **TOP)
    return jcfg, tcfg


def _inputs():
    rng = np.random.default_rng(0)
    # A smooth textured scene so SuperPoint finds structure at 32x32.
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    base = np.stack([np.sin(7 * xx + 3 * yy), np.cos(5 * yy - 2 * xx), np.sin(4 * xx * yy)], -1)
    images = np.stack([
        np.clip(0.5 + 0.4 * np.roll(base, 2 * k, axis=1) + 0.05 * rng.standard_normal(base.shape),
                0, 1) for k in range(V)])[None].astype(np.float32)
    intr = np.broadcast_to(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]),
                           (B, V, 3, 3)).astype(np.float32)
    near = np.ones((B, V), np.float32)
    far = np.full((B, V), 100.0, np.float32)
    return images, intr, near, far


def jax_ransac_noise(rng, b, n_pairs, samples, m):
    """The Gumbel draws the JAX encoder makes (encoder.py:287,292 ->
    procrustes.py:81-83,57), as one (b, n_pairs, samples, m) array."""
    out = np.zeros((b, n_pairs, samples, m), np.float32)
    rngs = jax.random.split(rng, n_pairs)
    for p in range(n_pairs):
        keys = jax.random.split(rngs[p], b)
        for bi in range(b):
            ks = jax.random.split(keys[bi], samples)
            out[bi, p] = np.asarray(jax.vmap(
                lambda k: jax.random.gumbel(k, (m,), jnp.float32))(ks))
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model with the same parameters, inputs)."""
    jcfg, tcfg = _cfgs()
    jm = JPF3plat(jcfg)
    images, intr, near, far = _inputs()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                              jnp.asarray(intr), jnp.asarray(near), jnp.asarray(far))
    tm = PF3plat(tcfg, device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    frozen = {k: to_np(params.frozen[k]) for k in ("unidepth", "superpoint", "lightglue")}
    load_jax_params(tm, to_np(params.trainable), frozen)
    return jm, params, tm, (images, intr, near, far)


@pytest.fixture(scope="module")
def forward(pair):
    """Both whole-slice forwards, same parameters and RANSAC noise."""
    jm, params, tm, (images, intr, near, far) = pair
    rng = jax.random.PRNGKey(7)
    jargs = tuple(jnp.asarray(a) for a in (images, intr, near, far))
    jfrozen, jcorr = jax.jit(jm.perceive)(params.frozen, *jargs[:2])
    jenc, jout = jax.jit(jm.forward)(params, *jargs, jnp.asarray(0), rng)
    m = jcorr.kpts0.shape[2]
    noise = jax_ransac_noise(rng, B, V * (V - 1) // 2, ENC["ransac_samples"], m)
    tfrozen, tcorr = tm.perceive(t(images), t(intr))
    tenc, tout = tm(t(images), t(intr), t(near), t(far), 0, ransac_noise=t(noise))
    return dict(jfrozen=jfrozen, jcorr=jcorr, jenc=jenc, jout=jout,
                tfrozen=tfrozen, tcorr=tcorr, tenc=tenc, tout=tout)


def _close(a, b, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=rtol, atol=atol)


class TestWeights:
    def test_every_parameter_carried(self, pair):
        _, params, tm, _ = pair
        n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params.trainable))
        n_port = sum(p.numel() for p in tm.encoder.parameters())
        assert n_jax == n_port
        for k, mod in (("superpoint", tm.superpoint), ("unidepth", tm.unidepth)):
            n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params.frozen[k]))
            assert n_jax == sum(p.numel() for p in mod.parameters()), k


class TestEncoderModules:
    """Port-order steps 8-12, module by module, on the carried weights."""

    def _rng(self, seed):
        return np.random.default_rng(seed)

    def test_self_and_cross_blocks(self, pair):
        from pf3plat_tpu.models.layers import CrossBlock, SelfBlock

        _, params, tm, _ = pair
        p = params.trainable["params"]
        x = self._rng(1).standard_normal((2, 9, 32)).astype(np.float32)
        y = self._rng(2).standard_normal((2, 13, 32)).astype(np.float32)
        j = SelfBlock(32, 4).apply({"params": p["depth_self_attn_0"]}, jnp.asarray(x))
        with torch.no_grad():
            _close(tm.encoder.depth_self_attn_0(t(x)), j, rtol=2e-3, atol=2e-3)
            j0, j1 = CrossBlock(32, 4).apply({"params": p["pose_cross_attn_0"]},
                                             jnp.asarray(x), jnp.asarray(y))
            t0, t1 = tm.encoder.pose_cross_attn_0(t(x), t(y))
        _close(t0, j0, rtol=2e-3, atol=2e-3)
        _close(t1, j1, rtol=2e-3, atol=2e-3)

    def test_loftr_and_swin(self, pair):
        from pf3plat_tpu.models.layers import LocalFeatureTransformer
        from pf3plat_tpu.models.multiview_transformer import MultiViewFeatureTransformer

        _, params, tm, _ = pair
        p = params.trainable["params"]
        x = self._rng(3).standard_normal((2, 16, 32)).astype(np.float32)
        j = LocalFeatureTransformer(32, 4).apply({"params": p["dino_aggregator"]}, jnp.asarray(x))
        with torch.no_grad():
            _close(tm.encoder.dino_aggregator(t(x)), j)
            maps = self._rng(4).standard_normal((2, 4, 4, 32)).astype(np.float32)
            for splits in (1, 2):
                j = MultiViewFeatureTransformer(1, 32).apply(
                    {"params": p["cross_view_aggregator"]}, jnp.asarray(maps), splits)
                _close(tm.encoder.cross_view_aggregator(t(maps), splits), j,
                       rtol=2e-3, atol=2e-3)

    def test_unet_and_costvolume_warp(self, pair):
        from pf3plat_tpu.models.costvolume import warp_with_pose_depth_candidates as jwarp
        from pf3plat_tpu.models.unet import UNetModel as JUNet
        from pf3plat_tpu_torch.models.costvolume import warp_with_pose_depth_candidates

        _, params, tm, _ = pair
        p = params.trainable["params"]["depth_predictor"]
        x = self._rng(5).standard_normal((2, 8, 8, 16)).astype(np.float32)
        j = JUNet(model_channels=16, out_channels=16, attention_resolutions=(2,),
                  channel_mult=(1, 1), num_views=2).apply(
            {"params": p["CheckpointUNetModel_0"]}, jnp.asarray(x))
        with torch.no_grad():
            _close(tm.encoder.depth_predictor.cv_unet(t(x)), j, rtol=2e-3, atol=2e-3)
        rng = self._rng(6)
        feat = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
        k = np.broadcast_to(np.array([[7.0, 0, 3.5], [0, 6.0, 3.0], [0, 0, 1]]),
                            (2, 3, 3)).astype(np.float32)
        pose = np.broadcast_to(np.eye(4), (2, 4, 4)).copy().astype(np.float32)
        pose[:, 0, 3] = [0.3, -0.2]
        depth = rng.uniform(1, 10, (2, 4)).astype(np.float32)
        _close(warp_with_pose_depth_candidates(t(feat), t(k), t(pose), t(depth)),
               jwarp(jnp.asarray(feat), jnp.asarray(k), jnp.asarray(pose), jnp.asarray(depth)))

    def test_adapter_procrustes_sync(self):
        from pf3plat_tpu.geometry import camera_sync as jsync, procrustes as jproc
        from pf3plat_tpu.models.gaussian_adapter import adapt_gaussians as jadapt
        from pf3plat_tpu_torch.geometry import camera_sync, procrustes
        from pf3plat_tpu_torch.models.gaussian_adapter import adapt_gaussians

        rng = self._rng(8)
        cfg_j, cfg_t = JAdapterCfg(sh_degree=2), GaussianAdapterCfg(sh_degree=2)
        c2w = np.broadcast_to(np.eye(4), (2, 1, 4, 4)).copy().astype(np.float32)
        c2w[:, 0, :3, 3] = rng.standard_normal((2, 3))
        intr = np.broadcast_to(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]),
                               (2, 1, 3, 3)).astype(np.float32)
        coords = rng.uniform(0, 1, (2, 10, 2)).astype(np.float32)
        depth = rng.uniform(1, 5, (2, 10)).astype(np.float32)
        opac = rng.uniform(0, 1, (2, 10)).astype(np.float32)
        raw = rng.standard_normal((2, 10, cfg_t.d_in)).astype(np.float32)
        jo = jadapt(cfg_j, *(jnp.asarray(a) for a in (c2w, intr, coords, depth, opac, raw)), (8, 8))
        to = adapt_gaussians(cfg_t, *(t(a) for a in (c2w, intr, coords, depth, opac, raw)), (8, 8))
        for a, b in zip(to, jo):
            _close(a, b)

        # RANSAC on noisy correspondences with the same Gumbel draws
        pts = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
        pts[..., 2] += 4
        r_true = np.asarray(jax.vmap(lambda q: jnp.eye(3))(jnp.zeros(2)))
        q = pts @ r_true + np.array([0.2, -0.1, 0.05], np.float32)
        q[:, :5] += 0.5  # outliers
        w = rng.uniform(0.2, 1.0, (2, 40)).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(3), 2)
        jfit = jax.vmap(lambda k, a, c, s: jproc.align_ransac(k, a, c, s, n_samples=16,
                                                              threshold=0.05))(
            keys, jnp.asarray(pts), jnp.asarray(q), jnp.asarray(w))
        noise = np.stack([np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (40,)))(
            jax.random.split(keys[i], 16))) for i in range(2)])
        tfit = procrustes.align_ransac(t(pts), t(q), t(w), t(noise), threshold=0.05)
        _close(tfit.r, jfit.r, atol=1e-4)
        _close(tfit.t, jfit.t, atol=1e-4)

        rel = np.broadcast_to(np.eye(4), (2, 3, 4, 4)).copy().astype(np.float32)
        rel[..., :3, 3] = rng.standard_normal((2, 3, 3)) * 0.3
        conf = rng.uniform(0.2, 1, (2, 3)).astype(np.float32)
        jchain = jsync.camera_chaining(jnp.asarray(rel[:, :2]))
        _close(camera_sync.camera_chaining(t(rel[:, :2])), jchain)
        js = jsync.camera_synchronization(jnp.asarray(rel), jnp.asarray(conf), (0, 0, 1),
                                          (1, 2, 2), 3, fallback=jchain)
        ts = camera_sync.camera_synchronization(t(rel), t(conf), (0, 0, 1), (1, 2, 2), 3,
                                                fallback=t(np.asarray(jchain)))
        _close(ts, js, atol=1e-4)


def _synthetic_encoder_inputs(seed=0, m=64):
    """A z=4 wall seen by V cameras translated 0.2 apart along x, with exact
    correspondences (the construction of tests/test_encoder.py), so the
    encoder's RANSAC has enough matches to leave its identity fallback."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (B, V, H, W, 3)).astype(np.float32)
    depth = np.full((B, V, H, W), 4.0, np.float32)
    feats = rng.standard_normal((B, V, 8, 8, ENC["d_backbone"])).astype(np.float32)
    pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
    k0 = np.zeros((B, len(pairs), m, 2), np.float32)
    k1 = np.zeros_like(k0)
    for p, (i, j) in enumerate(pairs):
        pts = np.stack([rng.uniform(-1.5, 1.5, (B, m)), rng.uniform(-1.5, 1.5, (B, m)),
                        np.full((B, m), 4.0)], axis=-1)
        for vi, arr in ((i, k0), (j, k1)):
            x = pts[..., 0] - 0.2 * vi
            arr[:, p, :, 0] = x / pts[..., 2] * W + 0.5 * W
            arr[:, p, :, 1] = pts[..., 1] / pts[..., 2] * H + 0.5 * H
    scores = np.full((B, len(pairs), m), 0.9, np.float32)
    valid = np.ones((B, len(pairs), m), bool)
    return images, depth, feats, (k0, k1, scores, valid)


class TestEncoderWithMatches:
    def test_ransac_sync_refine_gaussians(self, pair):
        """Port-order steps 11-12 with 64 exact matches per pair and the
        same RANSAC noise: coarse, synchronized and refined poses and the
        Gaussians agree, and the coarse poses recover the true motion."""
        from pf3plat_tpu.models.encoder import Correspondences as JCorr, FrozenInputs as JFrozen
        from pf3plat_tpu_torch.models.encoder import Correspondences, FrozenInputs

        jm, params, tm, (_, intr, near, far) = pair
        images, depth, feats, corr = _synthetic_encoder_inputs()
        rng = jax.random.PRNGKey(11)
        jenc = jax.jit(jm.encoder.apply)(
            params.trainable, jnp.asarray(images), jnp.asarray(intr), jnp.asarray(near),
            jnp.asarray(far), JFrozen(jnp.asarray(depth), jnp.asarray(feats)),
            JCorr(*(jnp.asarray(a) for a in corr)), jnp.asarray(0), rng)
        noise = jax_ransac_noise(rng, B, len(corr[0][0]), ENC["ransac_samples"], 64)
        with torch.no_grad():
            tenc = tm.encoder(t(images), t(intr), t(near), t(far),
                              FrozenInputs(t(depth), t(feats)),
                              Correspondences(*(t(a) for a in corr)), 0, ransac_noise=t(noise))
        # the fits really ran: view 0 -> 1 is a 0.2 shift along -x
        np.testing.assert_allclose(n(tenc.pairwise_poses)[0, 0, :3, 3], [-0.2, 0, 0], atol=0.05)
        _close(tenc.pairwise_poses, jenc.pairwise_poses, atol=2e-3)
        _close(tenc.sync_poses, jenc.sync_poses, atol=2e-3)
        _close(tenc.refined_poses, jenc.refined_poses, atol=2e-3)
        _close(tenc.pair_confidences, jenc.pair_confidences)
        for f in ("means", "covariances", "harmonics", "opacities"):
            _close(getattr(tenc.gaussians, f), getattr(jenc.gaussians, f), rtol=5e-3, atol=5e-3)


class TestBackbones:
    """Port-order steps 13-14 on the carried frozen weights."""

    def test_unidepth(self, pair, forward):
        jf, tf = forward["jfrozen"], forward["tfrozen"]
        # UniDepth's ViT attention rounds to bf16 on both sides (see module doc)
        _close(tf.features, jf.features, rtol=2e-3, atol=2e-3)
        _close(tf.depth, jf.depth, rtol=2e-3, atol=2e-3)

    def test_superpoint_lightglue_matches(self, pair, forward):
        jc, tc = forward["jcorr"], forward["tcorr"]
        np.testing.assert_array_equal(n(tc.valid), np.asarray(jc.valid))
        assert n(tc.valid).sum() > 0
        np.testing.assert_array_equal(n(tc.kpts0), np.asarray(jc.kpts0))
        np.testing.assert_array_equal(n(tc.kpts1), np.asarray(jc.kpts1))
        _close(tc.scores, jc.scores, rtol=2e-3, atol=2e-3)


class TestWholeSlice:
    def test_poses(self, forward):
        je, te = forward["jenc"], forward["tenc"]
        _close(te.depths, je.depths, rtol=2e-3, atol=2e-3)
        # same RANSAC hypotheses -> same coarse poses (rotations compared,
        # not SVD factors)
        _close(te.pairwise_poses, je.pairwise_poses, atol=2e-3)
        _close(te.sync_poses, je.sync_poses, atol=2e-3)
        _close(te.refined_poses, je.refined_poses, atol=2e-3)

    def test_gaussians_and_render(self, forward):
        je, te = forward["jenc"], forward["tenc"]
        for f in ("means", "covariances", "harmonics", "opacities"):
            _close(getattr(te.gaussians, f), getattr(je.gaussians, f), rtol=5e-3, atol=5e-3)
        _close(forward["tout"].color, forward["jout"].color, rtol=5e-3, atol=5e-3)
        assert forward["tout"].color.shape == (B, V, H, W, 3)
