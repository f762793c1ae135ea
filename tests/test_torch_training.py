"""Parity of the port's training slice (pf3plat_tpu_torch.training, LPIPS,
SSIM) with the JAX package, on the CPU.

  * the optimizer against optax: the OneCycle schedule, clip + Adam over
    three steps, a skipped non-finite step and the give-up rule;
  * SSIM, LPIPS (weights carried by `weights.py`, with its image gradient)
    and every loss part on the same numpy inputs, rtol 1e-5 where the chain
    is short;
  * two train steps of the tiny PF3plat of tests/test_torch_model.py on
    both sides, from the same parameters with the same RANSAC noise: loss
    parts, grad_norm, the gradients (read from Adam's first moment, which
    after step 1 is 0.1 * the clipped gradient) and every encoder parameter
    after each step. Tolerances are stated at each assertion; they are
    wider than rtol 1e-4 only where the bf16 attention of the pose stacks
    (tests/test_torch_model.py) reaches the quantity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pf3plat_tpu.models.backbones.vgg_lpips import LPIPS as JLPIPS
from pf3plat_tpu.models.encoder import Correspondences as JCorr, EncoderOutput as JEnc
from pf3plat_tpu.models.pf3plat import PF3plat as JPF3plat
from pf3plat_tpu.models.types import Gaussians as JGaussians
from pf3plat_tpu.ops.ssim import ssim as jssim
from pf3plat_tpu.training import losses as jlosses, train as jtrain

from pf3plat_tpu_torch.models.encoder import Correspondences, EncoderOutput
from pf3plat_tpu_torch.models.pf3plat import PF3plat
from pf3plat_tpu_torch.models.types import Gaussians
from pf3plat_tpu_torch.ops.ssim import ssim
from pf3plat_tpu_torch.training import losses, train
from pf3plat_tpu_torch.weights import ENCODER_RULES, flatten, jax_leaf, load_jax_params

from test_torch_helpers import _no_tf32, n, t  # noqa: F401
from test_torch_model import B, ENC, TOP, V, _cfgs, _inputs, jax_ransac_noise


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model with the same parameters)."""
    jcfg, tcfg = _cfgs()
    jm = JPF3plat(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in _inputs()))
    tm = PF3plat(tcfg, device="cpu")
    load_jax_params(tm, _to_np(params.trainable), _to_np(params.frozen))
    return jm, params, tm


class TestOptimizer:
    @pytest.mark.parametrize("cosine", [True, False], ids=["onecycle", "linear"])
    def test_schedule_matches_optax(self, cosine):
        """Steps 0..3000 at T = max_steps + 10 = 300,011 (onecycle: warm-up
        to step int(0.01 T) = 3000, then the cosine decay)."""
        cfg = train.OptimizerCfg(cosine_lr=cosine)
        total = cfg.max_steps + 10
        if cosine:
            ref = optax.cosine_onecycle_schedule(
                transition_steps=total, peak_value=cfg.lr, pct_start=max(0.01, 1.5 / total))
        else:
            ref = optax.linear_schedule(cfg.lr / cfg.warm_up_steps, cfg.lr, cfg.warm_up_steps)
        steps = np.arange(3001)
        want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
        got = np.array([train.make_schedule(cfg)(int(s)) for s in steps])
        # both evaluate in float32; numpy's and XLA's cos may round a few
        # values differently (measured: 2 of 3001 differ by 1.1e-6)
        np.testing.assert_allclose(got, want, rtol=2e-6)

    def _trees(self, seed, scales):
        rng = np.random.default_rng(seed)
        shapes = ((4, 3), (7,), (2, 2, 2))
        return [[(s * rng.standard_normal(sh)).astype(np.float32) for sh in shapes]
                for s in scales]

    def _run_both(self, grads_per_step, cfg):
        """Apply the same gradient sequence on both sides from zero
        parameters; returns per-step (port params, optax params, states)."""
        opt = jtrain.make_optimizer(jtrain.OptimizerCfg(**vars(cfg)))
        update = jax.jit(opt.update)
        jparams = [jnp.zeros(g.shape, jnp.float32) for g in grads_per_step[0]]
        jstate = opt.init(jparams)
        tparams = [torch.zeros(g.shape) for g in grads_per_step[0]]
        tstate = train.init_opt_state(tparams)
        schedule = train.make_schedule(cfg)
        out = []
        for grads in grads_per_step:
            upd, jstate = update([jnp.asarray(g) for g in grads], jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            tupd, tstate = train.opt_update(cfg, schedule, [t(g) for g in grads], tstate)
            for p, u in zip(tparams, tupd):
                p.add_(u)
            out.append(([n(p).copy() for p in tparams], [np.asarray(p) for p in jparams],
                        tstate, jstate))
        return out

    def test_clip_adam_three_steps(self):
        """Global norms 6.x, 0.3 and 3.x: clipped, not clipped, clipped."""
        cfg = train.OptimizerCfg(max_steps=1000)
        grads = self._trees(0, (1.0, 0.05, 0.5))
        for tp, jp, tstate, jstate in self._run_both(grads, cfg):
            for a, b in zip(tp, jp):  # atol: 5e-7 of the peak lr
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-10)
            assert tstate.count == int(jstate.inner_state[1][0].count)

    def test_nonfinite_step_skipped_and_give_up_rule(self):
        """A NaN gradient gives a zero update and leaves the moments and the
        schedule's count alone; the next finite step resumes at count 1.
        After more than 100 consecutive failures the update is applied."""
        cfg = train.OptimizerCfg(max_steps=1000)
        good = self._trees(1, (1.0, 1.0))
        bad = [g.copy() for g in good[0]]
        bad[1][3] = np.nan
        res = self._run_both([good[0], bad, good[1]], cfg)
        for tp, jp, _, _ in res:
            for a, b in zip(tp, jp):  # atol: 5e-7 of the peak lr
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-10)
        np.testing.assert_array_equal(res[1][0][0], res[0][0][0])  # zero update
        assert [r[2].count for r in res] == [1, 1, 2]
        assert [int(r[3].inner_state[1][0].count) for r in res] == [1, 1, 2]

        res = self._run_both([bad] * 101, cfg)
        assert res[99][2].notfinite_count == int(res[99][3].notfinite_count) == 100
        assert res[99][2].count == 0 and np.isfinite(res[99][0][1]).all()
        assert res[100][2].count == int(res[100][3].inner_state[1][0].count) == 1
        assert np.isnan(res[100][0][1][3]) and np.isnan(res[100][1][1][3])


def _synthetic_encoder_output(seed=0, b=2, v=3, h=16, w=16, m=20):
    """Random EncoderOutput fields (numpy) for the pose loss: rigid poses,
    depths, camera points and masked scored correspondences."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    n_pairs = v * (v - 1) // 2

    def se3(k):
        out = np.broadcast_to(np.eye(4), (b, k, 4, 4)).copy()
        out[..., :3, :3] = Rotation.from_rotvec(
            0.2 * rng.standard_normal((b * k, 3))).as_matrix().reshape(b, k, 3, 3)
        out[..., :3, 3] = 0.3 * rng.standard_normal((b, k, 3))
        return out.astype(np.float32)

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        pairwise_poses=se3(n_pairs), refined_poses=se3(v),
        depths=f32(rng.uniform(1, 5, (b, v, h, w))),
        xyz=f32(rng.standard_normal((b, v, h, w, 3)) + [0, 0, 4]),
        pair_confidences=f32(rng.uniform(0, 1, (b, n_pairs))),
        corr=(f32(rng.uniform(0, w, (b, n_pairs, m, 2))), f32(rng.uniform(0, w, (b, n_pairs, m, 2))),
              f32(rng.uniform(0, 1, (b, n_pairs, m))), rng.uniform(0, 1, (b, n_pairs, m)) > 0.2),
    )


def _enc_pair(d):
    """The same synthetic EncoderOutput for JAX and for the port."""
    b, v = d["depths"].shape[:2]
    zeros = dict(means=np.zeros((b, 1, 3), np.float32), covariances=np.zeros((b, 1, 3, 3), np.float32),
                 harmonics=np.zeros((b, 1, 3, 1), np.float32), opacities=np.zeros((b, 1), np.float32))
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (b, v, 4, 4))
    fields = dict(pairwise_poses=d["pairwise_poses"], sync_poses=eye,
                  refined_poses=d["refined_poses"], depths=d["depths"], xyz=d["xyz"],
                  pair_confidences=d["pair_confidences"])
    jenc = JEnc(gaussians=JGaussians(**{k: jnp.asarray(x) for k, x in zeros.items()}),
                correspondences=JCorr(*(jnp.asarray(a) for a in d["corr"])),
                **{k: jnp.asarray(x) for k, x in fields.items()})
    tenc = EncoderOutput(gaussians=Gaussians(**{k: t(x) for k, x in zeros.items()}),
                         correspondences=Correspondences(*(t(a) for a in d["corr"])),
                         **{k: t(x) for k, x in fields.items()})
    return jenc, tenc


class TestLosses:
    def test_ssim(self):
        rng = np.random.default_rng(3)
        a, b = (rng.uniform(0, 1, (2, 24, 28, 3)).astype(np.float32) for _ in range(2))
        np.testing.assert_allclose(n(ssim(t(a), t(b))), np.asarray(jssim(a, b)), rtol=1e-5)
        np.testing.assert_allclose(n(ssim(t(a), t(b), size_average=False)),
                                   np.asarray(jssim(a, b, size_average=False)), rtol=1e-5)

    def test_lpips_and_its_image_gradient(self, pair):
        _, params, tm = pair
        rng = np.random.default_rng(4)
        a, b = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
        lp = params.frozen["lpips"]
        ref = JLPIPS().apply(lp, jnp.asarray(a), jnp.asarray(b))
        ref_g = jax.grad(lambda x: JLPIPS().apply(lp, x, jnp.asarray(b)).sum())(jnp.asarray(a))
        ta = t(a).requires_grad_(True)
        got = tm.lpips_apply(ta, t(b))
        got.sum().backward()
        # 13 convolutions deep, summed in another order than XLA's: the
        # gradient is held to 1e-4 of its largest element
        np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5)
        scale = float(np.abs(np.asarray(ref_g)).max())
        np.testing.assert_allclose(n(ta.grad), np.asarray(ref_g), rtol=1e-4, atol=1e-4 * scale)
        assert all(p.grad is None for p in tm.lpips.parameters())

    @pytest.mark.parametrize("rel", [0.0, 0.5], ids=["abs-poses", "with-coarse-poses"])
    def test_loss_parts_and_total(self, pair, rel):
        jm, params, tm = pair
        d = _synthetic_encoder_output()
        jenc, tenc = _enc_pair(d)
        rng = np.random.default_rng(5)
        pred, tgt = (rng.uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32) for _ in range(2))
        intr = np.broadcast_to(np.array([[1.1, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1.0]]),
                               (2, 3, 3, 3)).astype(np.float32)
        jcfg, tcfg = jlosses.LossCfg(pose_weight_rel=rel), losses.LossCfg(pose_weight_rel=rel)
        jtot, jparts = jlosses.total_loss(
            jcfg, jnp.asarray(pred), jnp.asarray(tgt), jenc, jnp.asarray(intr), jnp.asarray(0),
            lpips_fn=lambda x, y: jm.lpips_apply(params.frozen, x, y))
        ttot, tparts = losses.total_loss(tcfg, t(pred), t(tgt), tenc, t(intr), 0,
                                         lpips_fn=tm.lpips_apply)
        assert set(tparts) == set(jparts) == {"mse", "ssim", "pose", "lpips"}
        for k in jparts:
            np.testing.assert_allclose(n(tparts[k]), np.asarray(jparts[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(n(ttot), np.asarray(jtot), rtol=1e-5)
        # LPIPS waits for its step
        late = losses.lpips_loss(tm.lpips_apply, t(pred), t(tgt), 2, 3)
        assert float(late) == 0.0


@pytest.fixture(scope="module")
def steps(pair):
    """Two train steps on both sides from the same parameters and noise.
    Returns per step: (JAX aux, port aux, JAX state, port state, port
    parameters after the step)."""
    jm, params, tm = pair
    images, intr, near, far = _inputs()
    opt = jtrain.make_optimizer(jtrain.OptimizerCfg())
    jstep = jax.jit(jtrain.make_model_train_step(jm, jlosses.LossCfg(), opt, images.shape[2:4]))
    jstate = jtrain.TrainState(params.trainable, opt.init(params.trainable),
                               jnp.zeros((), jnp.int32))
    ctx = dict(image=images, intrinsics=intr, near=near, far=far)
    jbatch = dict(context={k: jnp.asarray(v) for k, v in ctx.items()},
                  target=dict(image=jnp.asarray(images)), frozen_params=params.frozen)
    tstep = train.make_model_train_step(tm, losses.LossCfg(), train.OptimizerCfg())
    tstate = train.init_train_state(tm)
    tbatch = dict(context={k: t(v) for k, v in ctx.items()}, target=dict(image=t(images)))
    out = []
    m = TOP["max_matches"]
    for s in range(2):
        rng = jax.random.PRNGKey(100 + s)
        jstate, jaux = jstep(jstate, jbatch, rng)
        noise = jax_ransac_noise(rng, B, V * (V - 1) // 2, ENC["ransac_samples"], m)
        tstate, taux = tstep(tstate, tbatch, ransac_noise=t(noise))
        out.append((_to_np(jaux), {k: n(v) for k, v in taux.items()}, jstate, tstate,
                    [n(p).copy() for p in tstate.params]))
    return out



def _leaves(tm, jtree):
    """(name, port tensor index, JAX leaf in the port's layout) per encoder
    parameter."""
    flat = flatten(_to_np(jtree)["params"])
    return [(name, i, jax_leaf(flat, name, ENCODER_RULES, "encoder")[1])
            for i, (name, _) in enumerate(tm.encoder.named_parameters())]


class TestTrainStep:
    def test_loss_parts_and_grad_norm(self, steps):
        for s, (jaux, taux, _, tstate, _) in enumerate(steps):
            assert tstate.step == s + 1
            assert set(taux) == set(jaux)
            # the render and photometric parts: rtol 1e-4
            for k in ("mse", "ssim", "lpips", "psnr", "loss"):
                np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-4, err_msg=f"{k} step {s}")
            # the pose loss and the gradient norm reach the pose stacks'
            # bf16 attention: rtol 1e-3
            for k in ("pose", "grad_norm"):
                np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-3, err_msg=f"{k} step {s}")
            assert np.isfinite(taux["loss"]) and taux["grad_norm"] > 0

    def test_gradients_and_parameters(self, pair, steps):
        """The gradients, read from Adam's first moment (step 1: 0.1 * the
        clipped gradient; step 2: 0.1 * g2 + 0.09 * g1), tensor by tensor in
        norm, and every parameter after each step."""
        tm = pair[2]
        lr = [train.make_schedule(train.OptimizerCfg())(k) for k in range(2)]
        # Step 1 reaches the pose stacks' bf16 attention (1e-2). In step 2
        # the gradients of the pose stacks flow through pose_branch.Dense_1,
        # zero at init and +-lr per element after step 1, including the few
        # elements whose gradient was at the noise level and moved the other
        # way (5e-2).
        tol = (1e-2, 5e-2)
        for s, (_, _, jstate, tstate, tparams) in enumerate(steps):
            adam = jstate.opt_state.inner_state[1][0]
            assert int(adam.count) == tstate.opt_state.count == s + 1
            mus = _leaves(tm, adam.mu)
            top = max(np.linalg.norm(jmu) for _, _, jmu in mus)
            flipped = size = 0
            for (name, i, jmu), (_, _, jp) in zip(mus, _leaves(tm, jstate.params)):
                ref = np.linalg.norm(jmu)
                # gradients that vanish analytically (a conv bias in front of
                # a GroupNorm) hold only round-off on both sides
                if ref > 1e-6 * top:
                    err = np.linalg.norm(n(tstate.opt_state.mu[i]) - jmu)
                    assert err <= tol[s] * ref, (s, name, err / ref)
                # Adam moves every element by about lr per step, whatever the
                # gradient's size, so an element whose gradient is at the
                # noise level may move the other way: at most 2 lr apart per
                # step, and rare.
                dp = np.abs(tparams[i] - jp)
                assert dp.max() <= 2.0 * sum(lr[: s + 1]) * (1 + 1e-3), (s, name)
                flipped += int((dp > 0.1 * lr[0]).sum())
                size += dp.size
            assert flipped < 0.01 * size, (s, flipped, size)
