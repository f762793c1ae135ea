"""The port's precision rules, in one place.

The JAX package runs every float32 product that names no precision at
XLA's DEFAULT (one bf16 pass on the TPU it was written for), pins a few to
exact float32 (`precision="highest"`), and runs its frozen perception under
`jax.default_matmul_precision("bfloat16")`. The port's counterparts:

- `exact()`: autocast off and TF32 off for cuBLAS and cuDNN inside it, for
  the products the JAX package pins to "highest" (`exact_einsum`) and for
  comparisons that must not round;
- `jax_rule(layer, x)`: one layer at the JAX package's bfloat16 rule,
  operands rounded to bf16 and the product taken exactly in float32, so
  the output is float32 (autocast would round the output too);
  `decision_head` applies it to perception's keypoint and match heads
  inside bf16 autocast;
- `apply_policy(device)`: the declared setting for every float32 product
  that no call site pins (`TF32`), set by each entry point on the card;
- `exact_call(fn, *tensors)`: a whole function exact forward and backward
  (the pose loss; the pose stage and the evaluator's pose errors, which
  take no gradient, run inside `exact()`).

Only torch's legacy flags are touched (`torch.backends.cuda.matmul.allow_tf32`,
`torch.backends.cudnn.allow_tf32`): mixing them with the newer
`fp32_precision` settings makes torch raise.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

# The policy for float32 matmuls and convolutions that no call site pins:
# TF32 (10 bits of mantissa) for cuBLAS and cuDNN. The JAX reference ran
# these products at one bf16 pass (8 bits) on its chip; the sites it pins
# stay exact through `exact_einsum`.
TF32 = True


def _tf32_flags() -> tuple[bool, bool]:
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _set_tf32_flags(matmul: bool, cudnn: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def exact():
    """Exact float32 products inside: autocast off (CPU and CUDA), TF32 off
    for cuBLAS and cuDNN. Re-entrant; the previous flags and autocast state
    come back on exit, also after an exception."""
    old = _tf32_flags()
    _set_tf32_flags(False, False)
    try:
        with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
            yield
    finally:
        _set_tf32_flags(*old)


def apply_policy(device: torch.device) -> None:
    """Set the declared policy (`TF32`) for float32 products that no call
    site pins. Off the card it touches nothing."""
    if device.type == "cuda":
        _set_tf32_flags(TF32, TF32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def jax_rule(layer: nn.Linear | nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`layer(x)` under the JAX package's `default_matmul_precision("bfloat16")`:
    input and weight rounded to bf16, the product taken in float32 under
    `exact()`, the float32 bias added; the output is float32."""
    x, w = bf16_round(x), bf16_round(layer.weight)
    with exact():
        if isinstance(layer, nn.Conv2d):
            return layer._conv_forward(x, w, layer.bias)
        return F.linear(x, w, layer.bias)


def decision_head(layer: nn.Linear | nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A perception head whose output makes a discrete choice (keypoint
    scores, descriptors, matchability): at the JAX rule inside bf16
    autocast (the JAX package's bfloat16 scope), the layer itself outside
    it (float32, `frozen_matmul_precision="highest"`)."""
    if torch.is_autocast_enabled(x.device.type):
        return jax_rule(layer, x)
    return layer(x)


class _ExactEinsum(torch.autograd.Function):
    """A two-operand einsum whose forward and backward products run under
    `exact()` (JAX's `precision="highest"` pins the transposed products of
    its VJP too)."""

    @staticmethod
    def forward(ctx, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.spec = spec
        ctx.save_for_backward(a, b)
        with exact():
            return torch.einsum(spec, a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.spec.replace(" ", "").split("->")
        sa, sb = ins.split(",")
        ga = gb = None
        with exact():
            if ctx.needs_input_grad[1]:
                ga = torch.einsum(f"{out},{sb}->{sa}", g, b.float()).to(a.dtype)
            if ctx.needs_input_grad[2]:
                gb = torch.einsum(f"{out},{sa}->{sb}", g, a.float()).to(b.dtype)
        return None, ga, gb


def exact_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.einsum(spec, a, b)` in exact float32 (operands taken as
    float32, a float32 result), forward and backward, whatever autocast or
    the TF32 policy say: the JAX package's
    `jnp.einsum(..., precision="highest")`. Each index of an operand must
    appear in the other operand or the output (no index summed within one
    operand)."""
    return _ExactEinsum.apply(spec, a, b)


class _ExactCall(torch.autograd.Function):
    """`fn(*tensors)` under `exact()`, forward and backward: the backward
    runs the forward once more under `exact()` and takes its gradient
    there, so the products of both passes are exact."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        ctx.fn = fn
        ctx.save_for_backward(*tensors)
        with exact():
            return fn(*tensors)

    @staticmethod
    def backward(ctx, grad):
        inputs = [x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
        wanted = [x for x in inputs if x.requires_grad]
        with exact(), torch.enable_grad():
            got = iter(torch.autograd.grad(ctx.fn(*inputs), wanted, grad, allow_unused=True))
        return (None, *(next(got) if x.requires_grad else None for x in inputs))


def exact_call(fn, *tensors: torch.Tensor) -> torch.Tensor:
    """`fn(*tensors)`, one tensor out, in exact float32 forward and backward
    whatever autocast or the TF32 policy say. Gradients reach `tensors`
    only: tensors that `fn` reads from elsewhere get none."""
    return _ExactCall.apply(fn, *tensors)
