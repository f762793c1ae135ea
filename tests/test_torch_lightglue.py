"""LightGlue's two sides as one batch (`models/backbones/lightglue.py`) on
the CPU.

  * the stacked forward against the JAX module at b=2 and 2 layers, on
    equal sides and on unequal ones (80 against 96 keypoints, where the
    shorter side is padded): `m0`, `valid`, `scores0` and the last layer's
    per-side descriptors, at `test_torch_model.py`'s tolerances for
    matches (indices and masks equal, scores to 2e-3);
  * the call contract the benchmark's check relies on: one `forward` and
    one last-layer `cross_attn` call a view pair, in `view_pairs` order,
    each `cross_attn` call returning two (b, k, d) tensors;
  * the host ops one full-width call dispatches, held to what the stacked
    forward measures.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.models.backbones.lightglue import LightGlue as JLightGlue
from pf3plat_tpu.models.backbones.superpoint import Keypoints as JKeypoints

from pf3plat_tpu_torch.models.backbones.lightglue import LightGlue
from pf3plat_tpu_torch.models.backbones.matching import match_context_views
from pf3plat_tpu_torch.models.backbones.superpoint import Keypoints, SuperPoint
from pf3plat_tpu_torch.models.encoder import view_pairs
from pf3plat_tpu_torch.weights import LIGHTGLUE_RULES

from test_torch_helpers import _no_tf32, jax_tree_from_port, n, one_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

D, LAYERS, HEADS, HW = 64, 2, 4, (64, 80)
# Random weights score every match far below the released threshold of 0.1:
# with none, `valid` is the mutual nearest neighbours on valid keypoints.
THRESHOLD = 0.0
# Top-level aten ops of one 9-layer call at 1,024 keypoints under CPU bf16
# autocast: 723 for the stacked forward, 1,535 when each side ran alone.
STACKED_OPS = 723


def _pair(seed, b, k0, k1, invalid=6):
    """Side 1 holds side 0's keypoints in another order, each moved a
    little, then k1 - k0 new ones; the last `invalid` of each side are
    invalid. Shared keypoints give random weights mutual matches."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, HW[1], (b, k1, 2)).astype(np.float32)
    desc = rng.standard_normal((b, k1, D)).astype(np.float32)
    perm = rng.permutation(k1)
    xy1 = xy[:, perm] + rng.normal(0, 0.5, (b, k1, 2)).astype(np.float32)
    desc1 = desc[:, perm] + rng.normal(0, 0.05, (b, k1, D)).astype(np.float32)

    def side(xy, desc, k):
        valid = np.ones((b, k), bool)
        valid[:, -invalid:] = False
        return (xy[:, :k], np.ones((b, k), np.float32), desc[:, :k], valid)

    return side(xy, desc, k0), side(xy1, desc1, k1)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    lg = LightGlue(descriptor_dim=D, n_layers=LAYERS, num_heads=HEADS,
                   filter_threshold=THRESHOLD).eval()
    jm = JLightGlue(descriptor_dim=D, n_layers=LAYERS, num_heads=HEADS,
                    filter_threshold=THRESHOLD)
    side = JKeypoints(jnp.zeros((1, 8, 2)), jnp.zeros((1, 8)), jnp.zeros((1, 8, D)),
                      jnp.ones((1, 8), bool))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), side, side, HW)["params"]
    params = {"params": jax_tree_from_port(lg, shapes, LIGHTGLUE_RULES, "lightglue")}
    return lg, jm, params


@pytest.mark.parametrize("k0,k1", [(96, 96), (80, 96)], ids=["equal", "padded"])
def test_stacked_forward_matches_jax(models, k0, k1):
    lg, jm, params = models
    s0, s1 = _pair(3, 2, k0, k1)
    seen = []
    hook = lg.transformers[-1].cross_attn.register_forward_hook(
        lambda mod, args, out: seen.append(tuple(out)))
    try:
        with torch.no_grad():
            got = lg(Keypoints(*(t(x) for x in s0)), Keypoints(*(t(x) for x in s1)), HW)
    finally:
        hook.remove()
    want, state = jax.jit(
        lambda p, a, c: jm.apply(p, a, c, HW, capture_intermediates=True,
                                 mutable=["intermediates"]),
    )(params, JKeypoints(*(jnp.asarray(x) for x in s0)), JKeypoints(*(jnp.asarray(x) for x in s1)))
    (jdesc,) = state["intermediates"][f"cross_{LAYERS - 1}"]["__call__"]
    assert len(seen) == 1
    for side, k, jd in zip(seen[0], (k0, k1), jdesc):
        assert tuple(side.shape) == (2, k, D)
        np.testing.assert_allclose(n(side), np.asarray(jd), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(n(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(n(got.m0), np.asarray(want.m0))
    assert n(got.valid).sum() >= k0
    np.testing.assert_allclose(n(got.scores0), np.asarray(want.scores0), rtol=2e-3, atol=2e-3)


def _images(b, v, h=32, w=32):
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([np.sin(7 * xx + 3 * yy), np.cos(5 * yy - 2 * xx), np.sin(4 * xx * yy)], -1)
    return t(np.stack([np.stack([
        np.clip(0.5 + 0.4 * np.roll(base, 2 * k + i, axis=1)
                + 0.05 * rng.standard_normal(base.shape), 0, 1) for k in range(v)])
        for i in range(b)]).astype(np.float32))


def test_one_call_a_pair_as_the_benchmark_records():
    """`match_context_views` at v=3 with `forward` and the last layer's
    `cross_attn.forward` wrapped as instance attributes (the benchmark's
    `Recorder`): one `forward` a pair in `view_pairs` order, inside it one
    last-layer call, which returns two (b, k, d) tensors."""
    torch.manual_seed(1)
    b, v, k = 2, 3, 64
    sp = SuperPoint(max_num_keypoints=k).eval()
    lg = LightGlue(n_layers=LAYERS).eval()
    images = _images(b, v)
    events = []

    def wrap(obj, key):
        orig = obj.forward

        def wrapper(*args, **kwargs):
            events.append((key, "start", args))
            out = orig(*args, **kwargs)
            events.append((key, "end", out))
            return out

        obj.forward = wrapper

    wrap(lg, "forward")
    wrap(lg.transformers[-1].cross_attn, "cross_attn")
    with torch.no_grad():
        kp = sp(images.reshape(b * v, *images.shape[2:]))
        match_context_views(sp, lg, images, max_matches=16)
    kp = Keypoints(*(x.reshape(b, v, *x.shape[1:]) for x in kp))
    pairs = list(zip(*view_pairs(v)))
    assert [e[:2] for e in events] == [("forward", "start"), ("cross_attn", "start"),
                                       ("cross_attn", "end"), ("forward", "end")] * len(pairs)
    for (i, j), call in zip(pairs, range(0, len(events), 4)):
        kpts0, kpts1, shape = events[call][2]
        assert tuple(shape) == images.shape[2:4]
        assert torch.equal(kpts0.xy, kp.xy[:, i]) and torch.equal(kpts1.xy, kp.xy[:, j])
        out = tuple(events[call + 2][2])
        assert len(out) == 2
        for x in out:
            assert tuple(x.shape) == (b, k, lg.input_proj.out_features)


def test_host_ops_a_call():
    """One 9-layer call at 1,024 keypoints (b=1) under CPU bf16 autocast
    dispatches at most `STACKED_OPS` + 10% top-level aten ops (a profiler
    count on the CPU; the card's attention takes fewer)."""
    torch.manual_seed(2)
    lg = LightGlue().eval()
    rng = np.random.default_rng(4)
    k = 1024

    def side():
        return Keypoints(t(rng.uniform(0, 256, (1, k, 2))), torch.ones(1, k),
                         t(rng.standard_normal((1, k, 256))), torch.ones(1, k, dtype=torch.bool))

    s0, s1 = side(), side()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        lg(s0, s1, (256, 256))  # makes the frame's constants
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            lg(s0, s1, (256, 256))
    ops = [e for e in prof.events() if e.cpu_parent is None and e.name.startswith("aten::")]
    assert len(ops) <= STACKED_OPS * 1.1, len(ops)
