"""The port's precision rules (`pf3plat_tpu_torch/precision.py`) on the CPU.

The JAX package pins a few products to exact float32 (`precision="highest"`:
LightGlue's similarity matrix, the linear attention's two sums, the cost
volume's fusion logits), runs its frozen perception at
`default_matmul_precision("bfloat16")` (bf16 operands, float32 outputs),
and computes every attention outside its TPU flash kernel as `mxu_einsum`
(bf16 operands, f32 sums, float32 result). The port takes other branches
on the card than on the CPU (bf16 autocast in perception, SDPA for
attention), so these tests reach the card's rules on the CPU: perception
under `torch.autocast("cpu", dtype=torch.bfloat16)`, `library_attention`
on CPU tensors (CPU SDPA takes bf16), the policy's flags set and read
without a card.

Tolerances: exact products 1e-6 relative; the heads at the JAX rule are
compared bit for bit with the same layers run in float32 on bf16-rounded
operands; attention against the JAX package at the attention tests' 1e-2 of
the largest magnitude (both sides round the operands and the weights to
bf16, at different places).
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pf3plat_tpu.models import multiview_transformer as jmvt
from pf3plat_tpu.models.layers import mxu_einsum as j_mxu
from pf3plat_tpu.models.layers import scaled_dot_attention as j_attention

from pf3plat_tpu_torch.models import layers
from pf3plat_tpu_torch.models import multiview_transformer as tmvt
from pf3plat_tpu_torch.models.backbones import lightglue as tlg
from pf3plat_tpu_torch.models.backbones.lightglue import LightGlue
from pf3plat_tpu_torch.models.backbones.superpoint import Keypoints, SuperPoint

from test_torch_helpers import _no_tf32, n, t  # noqa: F401

TOL_EXACT = 1e-6  # relative, exact float32 products
TOL_ATTN = 1e-2   # of each tensor's largest magnitude
HEADS = ("convPa", "convPb", "convDa", "convDb")


@pytest.fixture
def precision():
    """The module under test, imported by the tests that use it, so that the
    rest of this file also runs on a tree without it."""
    from pf3plat_tpu_torch import precision as module

    return module


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _autocast():
    return torch.autocast("cpu", dtype=torch.bfloat16)


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _images(seed, b=2, h=64, w=64):
    """A smooth scene with noise, so SuperPoint's scores have structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([np.sin(9 * xx + 4 * yy), np.cos(6 * yy - 3 * xx), np.sin(5 * xx * yy)], -1)
    return torch.as_tensor(np.stack([
        np.clip(0.5 + 0.4 * np.roll(base, 3 * k, axis=1) + 0.1 * rng.standard_normal(base.shape),
                0, 1) for k in range(b)]).astype(np.float32))


def _keypoints(seed, b=1, k=48, d=64, hw=64, invalid=6):
    rng = np.random.default_rng(seed)
    valid = np.ones((b, k), bool)
    valid[:, -invalid:] = False
    desc = rng.standard_normal((b, k, d)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return Keypoints(xy=torch.as_tensor(rng.uniform(0, hw, (b, k, 2)).astype(np.float32)),
                     scores=torch.as_tensor(rng.uniform(0, 1, (b, k)).astype(np.float32)),
                     descriptors=torch.as_tensor(desc), valid=torch.as_tensor(valid))


def _rel(got, want):
    return float((got.detach() - want.detach()).abs().max() / want.detach().abs().max())


class TestPinnedProducts:
    def test_lightglue_similarity_is_exact_float32_under_autocast(self, monkeypatch):
        """Under bf16 autocast LightGlue's similarity matrix is float32 and
        equals the float32 product of the same match descriptors (the JAX
        module's `precision="highest"`), and the matchability logits are
        float32 at the JAX rule."""
        torch.manual_seed(0)
        lg = LightGlue(descriptor_dim=64, n_layers=2, num_heads=4).eval()
        seen = {}
        lg.transformers[-1].cross_attn.register_forward_hook(
            lambda mod, args, out: seen.update(desc=out))
        real = tlg.sigmoid_log_double_softmax

        def spy(sim, z0, z1, mask0, mask1):
            seen.update(sim=sim, z=(z0, z1))
            return real(sim, z0, z1, mask0, mask1)

        monkeypatch.setattr(tlg, "sigmoid_log_double_softmax", spy)
        with torch.no_grad(), _autocast():
            lg(_keypoints(1), _keypoints(2), (64, 64))
        head = lg.log_assignment[-1]
        d = 64
        # the JAX rule by hand: bf16 operands, float32 product and bias
        desc = [x.float() for x in seen["desc"]]
        mdesc = [F.linear(_bf16(x), _bf16(head.final_proj.weight), head.final_proj.bias) / d**0.25
                 for x in desc]
        want = torch.einsum("bmd,bnd->bmn", *mdesc)
        assert seen["sim"].dtype == torch.float32
        assert _rel(seen["sim"], want) <= TOL_EXACT
        for z, x in zip(seen["z"], desc):
            assert z.dtype == torch.float32
            assert torch.equal(z, F.linear(_bf16(x), _bf16(head.matchability.weight),
                                           head.matchability.bias))

    def test_linear_attention_sums_exact_under_autocast(self, monkeypatch, precision):
        """The linear attention's two pinned sums (JAX `layers.py:285,287`)
        are exact float32 under autocast: equal to the float32 einsum of the
        same operands run without autocast."""
        torch.manual_seed(1)
        layer = layers.LoFTREncoderLayer(32, 4)
        calls = []
        real = precision.exact_einsum

        def spy(spec, a, b):
            out = real(spec, a, b)
            calls.append((spec, a, b, out))
            return out

        monkeypatch.setattr(layers, "exact_einsum", spy)
        rng = np.random.default_rng(3)
        x = torch.as_tensor(rng.standard_normal((2, 40, 32)).astype(np.float32))
        with _autocast():
            layer(x, x)
        assert [c[0] for c in calls] == ["...shd,...shv->...hdv", "...lhd,...hd->...lh"]
        for spec, a, b, out in calls:
            assert out.dtype == torch.float32
            want = torch.einsum(spec, a.float(), b.float())
            assert _rel(out, want) <= TOL_EXACT, spec

    def test_costvolume_fusion_logits_exact_under_autocast(self, precision):
        """The cost volume's fusion logits (JAX `costvolume.py:256`) go
        through `exact_einsum`, whose product under autocast and a TF32
        policy equals its run without either, forward and backward."""
        import inspect

        from pf3plat_tpu_torch.models import costvolume

        assert 'exact_einsum("bnc,bmc->bnm", q, kk)' in inspect.getsource(costvolume)
        rng = np.random.default_rng(4)
        q = torch.as_tensor(rng.standard_normal((2, 30, 16)).astype(np.float32))
        k = torch.as_tensor(rng.standard_normal((2, 30, 16)).astype(np.float32))
        g = torch.as_tensor(rng.standard_normal((2, 30, 30)).astype(np.float32))
        q1, k1 = q.clone().requires_grad_(), k.clone().requires_grad_()
        old = _flags()
        try:
            precision.apply_policy(torch.device("cuda"))
            with _autocast():
                got = precision.exact_einsum("bnc,bmc->bnm", q1, k1)
            got.backward(g)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
        q2, k2 = q.clone().requires_grad_(), k.clone().requires_grad_()
        want = torch.einsum("bnc,bmc->bnm", q2, k2)
        want.backward(g)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.equal(q1.grad, q2.grad) and torch.equal(k1.grad, k2.grad)


class TestDecisionHeads:
    def test_superpoint_heads_at_jax_rule_under_autocast(self, monkeypatch, precision):
        """Under bf16 autocast SuperPoint's detector and descriptor heads run
        at the JAX rule (float32 outputs of bf16 operands): keypoints, valid
        masks, scores and descriptors equal the port run without autocast on
        the same backbone features with the heads' weights and inputs rounded
        to bf16."""
        torch.manual_seed(2)
        sp = SuperPoint(max_num_keypoints=96).eval()
        ref = copy.deepcopy(sp)
        with torch.no_grad():
            for k in HEADS:  # each head layer's operands rounded to bf16
                getattr(ref, k).weight.copy_(_bf16(getattr(ref, k).weight))
                getattr(ref, k).register_forward_pre_hook(lambda mod, args: (_bf16(args[0]),))
        images = _images(5)
        feats = {}
        sp.conv4b.register_forward_hook(lambda mod, args, out: feats.update(x=out))
        outs = []
        real = precision.jax_rule

        def spy(layer, x):
            out = real(layer, x)
            outs.append((layer, out))
            return out

        monkeypatch.setattr(precision, "jax_rule", spy)
        with torch.no_grad(), _autocast():
            got = sp(images)
        names = {id(getattr(sp, k)): k for k in HEADS}
        assert sorted(names[id(layer)] for layer, _ in outs) == sorted(HEADS)
        assert all(out.dtype == torch.float32 for _, out in outs)
        assert feats["x"].dtype == torch.bfloat16  # the backbone stays under autocast

        ref.conv4b.register_forward_hook(lambda mod, args, out: feats["x"].float())
        with torch.no_grad():
            want = ref(images)
        assert bool(want.valid.any())
        assert torch.equal(got.xy, want.xy)
        assert torch.equal(got.valid, want.valid)
        torch.testing.assert_close(got.scores, want.scores, rtol=TOL_EXACT, atol=0)
        torch.testing.assert_close(got.descriptors, want.descriptors, rtol=TOL_EXACT, atol=1e-7)

    @pytest.mark.parametrize("layer", [torch.nn.Linear(24, 8),
                                       torch.nn.Conv2d(6, 8, 3, padding=1)],
                             ids=["linear", "conv"])
    def test_jax_rule_and_decision_head(self, layer, precision):
        """`jax_rule` is the layer on bf16-rounded input and weight with the
        float32 bias, in float32, inside or outside autocast;
        `decision_head` takes it inside bf16 autocast and is the layer
        itself outside."""
        rng = np.random.default_rng(6)
        shape = (3, 24) if isinstance(layer, torch.nn.Linear) else (2, 6, 9, 9)
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        want = copy.deepcopy(layer)
        with torch.no_grad():
            want.weight.copy_(_bf16(want.weight))
            want = want(_bf16(x))
        with torch.no_grad():
            with _autocast():
                inside = precision.jax_rule(layer, x)
                head = precision.decision_head(layer, x)
            outside = precision.jax_rule(layer, x)
            plain = precision.decision_head(layer, x)
        for got in (inside, head, outside):
            assert got.dtype == torch.float32
            assert torch.equal(got, want)
        assert torch.equal(plain, layer(x))


# call sites at small sizes: (q shape, k shape, masked, q_scale is d^-0.5)
SITES = {
    "pose-self": ((2, 4, 300, 32), (2, 4, 300, 32), False),
    "lightglue-self-masked": ((1, 4, 96, 64), (1, 4, 96, 64), True),
    "unet-cross-view": ((1, 4, 512, 32), (1, 4, 512, 32), False),
    "lightglue-cross-masked": ((1, 4, 80, 64), (1, 4, 96, 64), True),
}


def _qkv(seed, q_shape, k_shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (q_shape, k_shape, k_shape))


def _mask(seed, q_shape, k_shape):
    rng = np.random.default_rng(seed)
    keep0 = rng.uniform(size=q_shape[:1] + q_shape[2:3]) > 0.2
    keep1 = rng.uniform(size=k_shape[:1] + k_shape[2:3]) > 0.2
    keep0[:, 0] = keep1[:, 0] = True
    return keep0[:, None, :, None] & keep1[:, None, None, :]


def _close(got, want, name):
    got, want = n(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max()
    assert err <= TOL_ATTN * scale, f"{name}: max abs err {err} > {TOL_ATTN} * {scale}"


class TestLibraryAttention:
    @pytest.mark.parametrize("site", list(SITES))
    def test_prescaled_sites_match_jax(self, site):
        """`library_attention` with q prescaled by 1/sqrt(d) against the JAX
        package's `scaled_dot_attention` (its `mxu_einsum` path), masked
        and not."""
        q_shape, k_shape, masked = SITES[site]
        q, k, v = _qkv(7, q_shape, k_shape)
        mask = _mask(8, q_shape, k_shape) if masked else None
        want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           None if mask is None else jnp.asarray(mask))
        got = layers.library_attention(t(q), t(k), t(v), None if mask is None else t(mask),
                                       q_scale=q_shape[-1]**-0.5)
        assert got.dtype == torch.float32
        _close(got, want, site)

    def test_crossblock_logits_match_jax(self):
        """CrossBlock's card branch: both sides' qk scaled by head^-1/4
        before the bf16 product, the logits unscaled, masked (JAX
        `layers.py:212-220`)."""
        q_shape = k_shape = (1, 4, 64, 32)
        qk0, qk1, v1 = _qkv(9, q_shape, k_shape)
        mask = _mask(10, q_shape, k_shape)
        r = (32**-0.5)**0.5
        sim = j_mxu("...id,...jd->...ij", jnp.asarray(qk0) * r, jnp.asarray(qk1) * r)
        sim = jnp.where(jnp.asarray(mask), sim, -1e30)
        want = j_mxu("...ij,...jd->...id", jax.nn.softmax(sim, axis=-1), jnp.asarray(v1))
        got = layers.library_attention(t(qk0) * r, t(qk1) * r, t(v1), t(mask), q_scale=1.0)
        _close(got, want, "crossblock")

    @pytest.mark.parametrize("splits,shift", [(1, False), (2, False), (2, True)],
                             ids=["one-window", "windows", "shifted-windows"])
    def test_swin_windows_match_jax(self, monkeypatch, splits, shift):
        """The swin windows (logits scaled in the product, the shifted
        windows' -100 bias) through `library_attention` against the JAX
        package's `window_attention`."""

        def library(q, k, v, mask=None, bias=None, prescale=True):
            assert not prescale
            return layers.library_attention(q, k, v, mask=mask, bias=bias)

        monkeypatch.setattr(tmvt, "attention", library)
        rng = np.random.default_rng(11)
        q, k, v = (rng.standard_normal((2, 8, 8, 64)).astype(np.float32) for _ in range(3))
        want = jmvt.window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), splits, shift)
        got = tmvt.window_attention(t(q), t(k), t(v), splits, shift)
        assert got.dtype == torch.float32
        _close(got, want, f"swin {splits} {shift}")

    @pytest.mark.parametrize("q_scale,masked", [(32**-0.5, False), (32**-0.5, True),
                                                (None, False), (1.0, True)],
                             ids=["prescaled", "prescaled-masked", "scaled-in-product",
                                  "crossblock"])
    def test_sdpa_gets_bf16_operands_and_returns_float32(self, monkeypatch, q_scale, masked):
        """What `library_attention` hands SDPA outside autocast: bf16 q, k,
        v; at the prescaled sites bf16(q * scale) with SDPA's scale 1.0;
        the mask additive at -1e30 in bf16; a float32 result returned."""
        seen = {}
        real = F.scaled_dot_product_attention

        def spy(q, k, v, attn_mask=None, scale=None, **kw):
            seen.update(q=q, k=k, v=v, mask=attn_mask, scale=scale)
            out = real(q, k, v, attn_mask=attn_mask, scale=scale, **kw)
            seen["out"] = out
            return out

        monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", spy)
        shape = (1, 2, 40, 32)
        q, k, v = (t(x) for x in _qkv(12, shape, shape))
        mask = t(_mask(13, shape, shape)) if masked else None
        # the site scaled in the product passes no q_scale, as on the parent tree
        kw = {} if q_scale is None else dict(q_scale=q_scale)
        got = layers.library_attention(q, k, v, mask, **kw)
        assert seen["q"].dtype == seen["k"].dtype == seen["v"].dtype == torch.bfloat16
        want_q = q if q_scale is None else q * q_scale
        assert torch.equal(seen["q"], want_q.to(torch.bfloat16))
        assert torch.equal(seen["k"], k.to(torch.bfloat16))
        assert torch.equal(seen["v"], v.to(torch.bfloat16))
        assert seen["scale"] == (None if q_scale is None else 1.0)
        if masked:
            assert seen["mask"].dtype == torch.bfloat16
            assert torch.equal(seen["mask"] < -1e29, ~mask)
        else:
            assert seen["mask"] is None
        assert got.dtype == torch.float32
        assert torch.equal(got, seen["out"].float())

    def test_inside_autocast_keeps_the_autocast_dtype(self):
        shape = (1, 2, 40, 32)
        q, k, v = (t(x) for x in _qkv(14, shape, shape))
        with _autocast():
            got = layers.library_attention(q, k, v, q_scale=32**-0.5)
        assert got.dtype == torch.bfloat16


class TestPolicy:
    def test_apply_policy_off_the_card_changes_nothing(self, precision):
        for state in ((False, False), (True, False), (False, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = state
            precision.apply_policy(torch.device("cpu"))
            assert _flags() == state

    def test_apply_policy_on_the_card_sets_the_legacy_flags(self, precision):
        """The declared TF32 setting, through the legacy flags only (reading
        them raises once the newer API has been mixed in)."""
        precision.apply_policy(torch.device("cuda"))
        assert _flags() == (precision.TF32, precision.TF32)

    def test_exact_restores_flags_and_autocast(self, precision):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
        with _autocast():
            with precision.exact():
                assert _flags() == (False, False)
                assert not torch.is_autocast_enabled("cpu")
                with precision.exact():  # re-entrant
                    assert _flags() == (False, False)
                assert _flags() == (False, False)
                assert not torch.is_autocast_enabled("cpu")
            assert _flags() == (True, True)
            assert torch.is_autocast_enabled("cpu")
            with pytest.raises(RuntimeError, match="boom"):
                with precision.exact():
                    raise RuntimeError("boom")
            assert _flags() == (True, True)
            assert torch.is_autocast_enabled("cpu")
            assert torch.get_autocast_dtype("cpu") == torch.bfloat16


def _stand_in(device, *shape):
    """What the dispatch rule reads of a tensor: device type, rank, shape."""
    from types import SimpleNamespace

    return SimpleNamespace(device=SimpleNamespace(type=device), shape=shape,
                           dim=lambda: len(shape))


@pytest.mark.parametrize("env,device,shape,want", [
    (None, "cuda", (9, 4, 4097, 32), True),
    ("1", "cuda", (9, 4, 4097, 32), True),
    ("0", "cuda", (9, 4, 4097, 32), False),
    ("0", "cuda", (5, 16, 2402, 64), False),
    ("1", "cuda", (9, 4, 2047, 32), False),
    ("1", "cpu", (9, 4, 4097, 32), False),
], ids=["unset", "on", "off-pose", "off-vit", "on-short", "on-cpu"])
def test_dispatch_honours_the_flash_switch(monkeypatch, env, device, shape, want):
    """`PF3PLAT_FLASH_ATTENTION=0` keeps every attention off the kernels, as
    in the JAX package (`layers.py:137`); otherwise the rule is the device
    type and the shapes."""
    if env is None:
        monkeypatch.delenv("PF3PLAT_FLASH_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("PF3PLAT_FLASH_ATTENTION", env)
    assert layers.use_flash_attention(_stand_in(device, *shape), _stand_in(device, *shape)) is want


@pytest.fixture(scope="module")
def autocast_forward():
    """The model test's tiny PF3plat (port init from a seed, carried into the
    JAX trees): the port's forward with its perception under CPU bf16
    autocast (what `frozen_matmul_precision="bfloat16"` runs on the card),
    the JAX perception at its default "bfloat16", and the JAX forward on the
    port's perception outputs with the same RANSAC noise."""
    import dataclasses

    from pf3plat_tpu.models.encoder import Correspondences as JCorr, FrozenInputs as JFrozen
    from pf3plat_tpu.models.pf3plat import PF3plat as JPF3plat, PF3platParams

    from pf3plat_tpu_torch.models.pf3plat import PF3plat
    from pf3plat_tpu_torch.weights import ENCODER_RULES, LIGHTGLUE_RULES, UNIDEPTH_RULES

    from test_torch_helpers import jax_tree_from_port
    from test_torch_model import B, ENC, V, _cfgs, _inputs, jax_ransac_noise

    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, frozen_matmul_precision="bfloat16")
    tcfg = dataclasses.replace(tcfg, frozen_matmul_precision="bfloat16")
    torch.manual_seed(3)
    tm = PF3plat(tcfg, device="cpu")
    heads = tm.lightglue.log_assignment  # the JAX tree holds the last head
    for head in heads[:-1]:
        head.load_state_dict(heads[-1].state_dict())
    jm = JPF3plat(jcfg)
    inputs = _inputs()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))
    trainable = {"params": jax_tree_from_port(tm.encoder, shapes.trainable["params"],
                                              ENCODER_RULES, "encoder")}
    frozen = {k: {"params": jax_tree_from_port(getattr(tm, k), shapes.frozen[k]["params"],
                                               rules, k)}
              for k, rules in (("unidepth", UNIDEPTH_RULES), ("superpoint", []),
                               ("lightglue", LIGHTGLUE_RULES), ("lpips", []))}
    params = PF3platParams(jax.tree_util.tree_map(jnp.asarray, trainable),
                           jax.tree_util.tree_map(jnp.asarray, frozen))
    jargs = [jnp.asarray(a) for a in inputs]
    jfrozen, jcorr = jax.jit(jm.perceive)(params.frozen, *jargs[:2])

    tm._frozen_precision = lambda: _autocast()
    rng = jax.random.PRNGKey(7)
    m = jcorr.kpts0.shape[2]
    noise = jax_ransac_noise(rng, B, V * (V - 1) // 2, ENC["ransac_samples"], m)
    perceived = {}
    perceive = tm.perceive

    def keep(images, intr):
        perceived["out"] = perceive(images, intr)
        return perceived["out"]

    tm.perceive = keep
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            tenc, tout = tm(*(t(a) for a in inputs), 0, ransac_noise=t(noise))
    finally:
        torch.set_num_threads(old)
    tfrozen, tcorr = perceived["out"]
    jm.perceive = lambda frozen_, images, intr: (
        JFrozen(jnp.asarray(n(tfrozen.depth)), jnp.asarray(n(tfrozen.features))),
        JCorr(*(jnp.asarray(n(x)) for x in tcorr)))
    jenc, jout = jax.jit(jm.forward)(params, *jargs, jnp.asarray(0), rng)
    return dict(tfrozen=tfrozen, tcorr=tcorr, tenc=tenc, tout=tout, jfrozen=jfrozen,
                jcorr=jcorr, jenc=jenc, jout=jout)


def test_forward_under_autocast_matches_jax(autocast_forward):
    """The tiny forward with perception under bf16 autocast, against the JAX
    package at the model test's tolerances: keypoints and match masks
    equal to the JAX perception's, match scores 2e-3; given the same
    perception outputs, depths and poses 2e-3, gaussians and colours 5e-3.
    (Depth and features are not held to JAX's: the JAX package's CPU
    backend does not round at "bfloat16", and the bf16 ViT is a few percent
    off float32 at random weights.)"""
    got = want = autocast_forward
    tc, jc = got["tcorr"], want["jcorr"]
    for x in (got["tfrozen"].depth, got["tfrozen"].features, tc.kpts0, tc.scores):
        assert x.dtype == torch.float32
    np.testing.assert_array_equal(n(tc.valid), np.asarray(jc.valid))
    np.testing.assert_array_equal(n(tc.kpts0), np.asarray(jc.kpts0))
    np.testing.assert_array_equal(n(tc.kpts1), np.asarray(jc.kpts1))
    np.testing.assert_allclose(n(tc.scores), np.asarray(jc.scores), rtol=2e-3, atol=2e-3)
    te, je = got["tenc"], want["jenc"]

    def close(a, b, rtol, atol):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=rtol, atol=atol)

    close(te.depths, je.depths, 2e-3, 2e-3)
    for f in ("pairwise_poses", "sync_poses", "refined_poses"):
        close(getattr(te, f), getattr(je, f), 0, 2e-3)
    for f in ("means", "covariances", "harmonics", "opacities"):
        close(getattr(te.gaussians, f), getattr(je.gaussians, f), 5e-3, 5e-3)
    close(got["tout"].color, want["jout"].color, 5e-3, 5e-3)
