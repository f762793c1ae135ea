"""The port's long-sequence attention (`models/layers.py:FlashAttention`,
kernels `csrc/attention_fwd.cu` / `attention_bwd.cu`) on the CPU, where the
kernels' plain versions run: parity with the JAX package's
`scaled_dot_attention`, the hand-written backward against autograd, and the
dispatch rule.

Tolerances: both sides round q, k, v and the probabilities to bf16 (8 bits
of mantissa, 2^-9 = 2e-3 relative per product term) but at other places
(JAX scales q before rounding it, the kernels scale the f32 logits; JAX's
autodiff rounds other intermediates than the hand-written backward), so
outputs and gradients agree to the 1e-2 class: 1e-2 of the largest
magnitude of each tensor.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pf3plat_tpu.models.layers import scaled_dot_attention as j_attention

from pf3plat_tpu_torch.models import layers

from test_torch_helpers import _no_tf32, n, t  # noqa: F401

TOL = 1e-2  # of each tensor's largest magnitude


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{name}: max abs err {err} > {TOL} * {scale}"


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    w = rng.standard_normal(q_shape).astype(np.float32)  # the scalar loss is sum(out * w)
    return q, k, v, w


SHAPES = {
    "self-2050x32": ((2, 4, 2050, 32), (2, 4, 2050, 32)),
    "cross-2049x2305x64": ((1, 2, 2049, 64), (1, 2, 2305, 64)),
    # One below, at and one above a whole number of the kernels' 128-row CTAs
    # (17 x 128 = 2176), against keys one past a whole number of 64-key
    # tiles. Head dim 64: its scale 1/8 commutes with the bf16 rounding of q
    # (JAX scales q before rounding it), which leaves these cases at <= 0.6e-2
    # where standard-normal inputs at head dim 32 sit at 0.5-1.4e-2 of the
    # largest value depending on the draw.
    "cta-edge-2175x2049x64": ((1, 2, 2175, 64), (1, 2, 2049, 64)),
    "cta-edge-2176x2049x64": ((1, 2, 2176, 64), (1, 2, 2049, 64)),
    "cta-edge-2177x2049x64": ((1, 2, 2177, 64), (1, 2, 2049, 64)),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_flash_attention_matches_jax(case):
    """Forward and the gradients of sum(out * w) w.r.t. q, k, v against JAX
    `scaled_dot_attention` (its einsum path, as on every backend but the
    TPU); neither token count is a multiple of a block."""
    q, k, v, w = _qkv(0, *SHAPES[case])

    def jloss(q, k, v):
        out = j_attention(q, k, v)
        return jnp.sum(out * w), out

    (_, ref_out), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out = layers.FlashAttention.apply(tq, tk, tv)
    assert out.dtype == torch.float32 and out.shape == tq.shape
    (out * t(w)).sum().backward()
    _close(n(out), ref_out, "out")
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref_grads):
        _close(n(got), want, f"d{name}")


def test_backward_plain_matches_autograd_of_forward_plain():
    """The hand-derived backward (probabilities recomputed from the saved
    log-sum-exp, delta = rowsum(dO * out)) against autograd through the
    plain forward, which differs only in where bf16 rounding enters."""
    q, k, v, w = _qkv(1, (1, 2, 300, 32), (1, 2, 260, 32))
    bf = lambda x: t(x).to(torch.bfloat16)  # noqa: E731
    qb, kb, vb, gb = bf(q), bf(k), bf(v), bf(w)
    scale = 32**-0.5
    leaves = [x.float().requires_grad_(True) for x in (qb, kb, vb)]
    out, lse = layers.attention_fwd_plain(*leaves, scale)
    (out * gb.float()).sum().backward()
    grads = layers.attention_bwd_plain(qb, kb, vb, out.detach(), lse.detach(), gb, scale)
    ref_lse = torch.logsumexp(qb.float() @ kb.float().transpose(-1, -2) * scale, dim=-1)
    np.testing.assert_allclose(n(lse), n(ref_lse), rtol=1e-6, atol=1e-6)
    for name, got, leaf in zip("qkv", grads, leaves):
        _close(n(got), n(leaf.grad), f"d{name}")


@pytest.mark.parametrize("q_shape,kv_shape", [((2, 3, 129, 32), (2, 3, 257, 32)),
                                              ((1, 2, 65, 64), (1, 2, 63, 64)),
                                              ((1, 1, 1, 32), (1, 1, 2401, 32))],
                         ids=["129x257x32", "65x63x64", "1x2401x32"])
def test_plain_forward_lse_is_natural_log(q_shape, kv_shape):
    """The interface between the forward and the backward: `lse` is the
    NATURAL-log sum of exponentials of the scaled logits (max + ln(sum)),
    whatever base the kernel's exponentials use inside. f32 sums in another
    order: 1e-5."""
    q, k, v, _ = _qkv(5, q_shape, kv_shape)
    qb, kb, vb = (t(x).to(torch.bfloat16) for x in (q, k, v))
    scale = q_shape[-1] ** -0.5
    _, lse = layers.attention_fwd_plain(qb, kb, vb, scale)
    logits = qb.double() @ kb.double().transpose(-1, -2) * scale
    want = logits.max(dim=-1).values + torch.log(
        torch.exp(logits - logits.max(dim=-1, keepdim=True).values).sum(dim=-1))
    assert lse.shape == q_shape[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(n(lse), n(torch.logsumexp(logits, dim=-1)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(lse), n(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "q_shape,k_shape,match",
    [((2, 3, 70, 32), (2, 3, 90, 32), None),
     ((2, 3, 70, 64), (2, 3, 1, 64), None),
     ((2, 3, 70, 48), (2, 3, 90, 48), "head dim 48"),
     ((6, 70, 32), (6, 90, 32), "batch, heads, tokens, head_dim"),
     ((256, 256, 8, 32), (256, 256, 8, 32), "grid's y dimension")],
    ids=["d32", "d64-one-key", "d48", "3-d", "too-many-heads"])
def test_kernel_argument_rules(q_shape, k_shape, match):
    """What the wrappers accept before a launch: 4-D operands, a built head
    dim, batch x heads within the grid's y dimension (the kernels index the
    head by `blockIdx.y`); token counts are free."""
    q, k = torch.empty(q_shape, device="meta"), torch.empty(k_shape, device="meta")
    if match is None:
        assert layers._attention_dims(q, k) == (*q_shape[:3], k_shape[2], q_shape[3])
    else:
        with pytest.raises(ValueError, match=match):
            layers._attention_dims(q, k)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch for CUDA tensors or raise: they never give
    way to the plain version (only `attention_fwd` / `attention_bwd` pick it,
    and only for tensors that lie on the CPU)."""
    q = torch.zeros((1, 1, 8, 32), dtype=torch.bfloat16)
    out, lse = torch.zeros((1, 1, 8, 32)), torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        layers.attention_fwd_cuda(q, q, q, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        layers.attention_bwd_cuda(q, q, q, out, lse, q, 1.0)


def test_head_dim_is_zero_padded_and_output_dtype_kept():
    """Head dim 24 runs at the built size 32 (zero columns), with the scale
    of the true head dim; a float64 caller gets float64 back."""
    q, k, v, _ = _qkv(2, (1, 2, 70, 24), (1, 2, 90, 24))
    out = layers.FlashAttention.apply(t(q), t(k), t(v))
    _close(n(out), n(layers.attention(t(q), t(k), t(v))), "out")
    assert layers.FlashAttention.apply(t(q).double(), t(k), t(v)).dtype == torch.float64
    with pytest.raises(ValueError, match="head dim 80"):
        layers.FlashAttention.apply(torch.zeros(1, 1, 8, 80), torch.zeros(1, 1, 8, 80),
                                    torch.zeros(1, 1, 8, 80))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_strided_views_of_a_fused_projection(dtype):
    """q, k, v as `SelfBlock` and the ViT hand them over: strided views of
    one qkv tensor, float32 or (under autocast) bf16. The wrapper lays them
    out contiguously; the plain versions and the kernels see the same."""
    rng = np.random.default_rng(4)
    qkv = t(rng.standard_normal((1, 50, 2, 32, 3)).astype(np.float32)).to(dtype)
    q, k, v = (qkv[..., i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    out = layers.FlashAttention.apply(q, k, v)
    ref = layers.FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())
    assert out.dtype == dtype
    np.testing.assert_array_equal(n(out.float()), n(ref.float()))
    got = layers._bf16_contiguous(q)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got.float()), n(q.to(torch.bfloat16).float()))


def _stand_in(device, *shape):
    """What the dispatch rule reads of a tensor: device type, rank, shape."""
    return SimpleNamespace(device=SimpleNamespace(type=device), shape=shape,
                           dim=lambda: len(shape))


@pytest.mark.parametrize(
    "device,q_shape,k_shape,mask,bias,want",
    [
        ("cuda", (9, 4, 4097, 32), (9, 4, 4097, 32), None, None, True),
        ("cuda", (5, 16, 2402, 64), (5, 16, 2402, 64), None, None, True),
        ("cuda", (1, 4, 2048, 32), (1, 4, 4096, 32), None, None, True),
        ("cuda", (9, 4, 4097, 32), (9, 4, 4097, 32), "mask", None, False),
        ("cuda", (9, 4, 4097, 32), (9, 4, 4097, 32), None, "bias", False),
        ("cuda", (9, 4, 2047, 32), (9, 4, 4097, 32), None, None, False),
        ("cuda", (9, 4, 4097, 32), (9, 4, 3, 32), None, None, False),
        ("cuda", (36, 4097, 32), (36, 4097, 32), None, None, False),
        ("cpu", (9, 4, 4097, 32), (9, 4, 4097, 32), None, None, False),
    ],
    ids=["pose-stack", "vit", "at-threshold", "mask", "bias", "short-q", "short-k", "3-d", "cpu"],
)
def test_dispatch_rule(device, q_shape, k_shape, mask, bias, want):
    """The JAX package's rule (`layers.py:135-147`) with the card in the
    TPU's place: everything else stays off the kernel path."""
    assert layers._FLASH_MIN_TOKENS == 2048
    got = layers.use_flash_attention(_stand_in(device, *q_shape), _stand_in(device, *k_shape),
                                     mask, bias)
    assert got is want


def test_cpu_attention_keeps_the_einsum_twin():
    """On the CPU `attention` stays the twin of JAX's `mxu_einsum` path for a
    large unmasked 4-D input too (q scaled before its bf16 rounding), so the
    whole-model parity of tests/test_torch_model.py is unchanged. The two
    frameworks' exp differ in the last bit, which moves a probability across
    a bf16 rounding boundary now and then: atol 1e-4 on outputs up to 0.1."""
    q, k, v, _ = _qkv(3, (1, 2, 2050, 32), (1, 2, 2050, 32))
    ref = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(n(layers.attention(t(q), t(k), t(v))), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
