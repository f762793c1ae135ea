"""Precision of the benchmark's reference: exact float32 throughout.

The reference runs inside `reference_precision()` (TF32 off for cuBLAS and
cuDNN, autocast off), so the port's precision helpers reduce to the plain
operation: `exact()` and `exact_call` keep the same exact scope, an exact
einsum is `torch.einsum`, and a perception head is the layer itself.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


@contextlib.contextmanager
def exact():
    """TF32 off for cuBLAS and cuDNN and autocast off inside; the previous
    flags come back on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


reference_precision = exact


def decision_head(layer: nn.Linear | nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return layer(x)


def exact_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(spec, a.float(), b.float())


def exact_call(fn, *tensors: torch.Tensor) -> torch.Tensor:
    return fn(*tensors)
