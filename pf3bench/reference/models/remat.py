"""Rematerialisation: the JAX package's `nn.remat` / `jax.checkpoint`."""

from __future__ import annotations

import torch
import torch.utils.checkpoint


def remat(fn, *args, enabled: bool = True, **kwargs):
    """`fn(*args, **kwargs)`, its activations dropped after the forward and
    recomputed in the backward when `enabled` and autograd records
    (non-reentrant `torch.utils.checkpoint`: the autograd graph, and with it
    the gradients, stays the same). The recompute restores the global RNG
    states only, so `fn` must draw nothing from an explicit generator."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)
