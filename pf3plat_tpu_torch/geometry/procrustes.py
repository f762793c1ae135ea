"""Weighted Procrustes (Kabsch) + soft RANSAC alignment on torch tensors.

Port of `pf3plat_tpu/geometry/procrustes.py`, batched over a leading axis
instead of `vmap`. Convention: (R, t) with Q ~= P @ R + t (row vectors).

The hypotheses are drawn by Gumbel-top-k over log-weights. The Gumbel
noise is an argument: the caller passes a precomputed tensor (the parity
tests rebuild the JAX draws) or a `torch.Generator` to draw it from.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RigidTransform(NamedTuple):
    r: torch.Tensor  # (..., 3, 3), row-vector convention: Q = P @ R + t
    t: torch.Tensor  # (..., 3)


def weighted_kabsch(
    p: torch.Tensor, q: torch.Tensor, w: torch.Tensor, eps: float = 1e-12
) -> RigidTransform:
    """R, t minimizing sum_i w_i |p_i R + t - q_i|^2; p, q (..., n, 3)."""
    w = torch.clamp(w, min=eps)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    mu_p = torch.sum(w[..., None] * p, dim=-2, keepdim=True)
    mu_q = torch.sum(w[..., None] * q, dim=-2, keepdim=True)
    pc = p - mu_p
    qc = q - mu_q
    cov = torch.einsum("...ni,...n,...nj->...ij", pc, w, qc)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(torch.matmul(u, vt))
    ones = torch.ones_like(det)
    s = torch.stack([ones, ones, det], dim=-1)
    r = torch.matmul(u * s[..., None, :], vt)
    t = (mu_q - torch.matmul(mu_p, r))[..., 0, :]
    return RigidTransform(r, t)


def gumbel_noise(
    shape, generator: torch.Generator | None, device, dtype=torch.float32
) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)), from `generator`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny, max=1.0 - 2**-24)))


def align_ransac(
    p: torch.Tensor,
    q: torch.Tensor,
    weights: torch.Tensor,
    noise: torch.Tensor,
    n_hot: int = 3,
    threshold: torch.Tensor | float = 0.01,
) -> RigidTransform:
    """Soft RANSAC rigid alignment, batched.

    p, q: (b, n, 3); weights: (b, n); noise: (b, n_samples, n) Gumbel
    draws; threshold: scalar or (b,). Samples n_samples minimal subsets by
    Gumbel-top-k, fits each with weighted Kabsch, scores soft inliers
    exp(-|residual| / threshold), and refits on the best hypothesis's
    renormalized inliers.
    """
    n = p.shape[-2]
    log_w = torch.log(torch.clamp(weights, min=1e-12))
    idx = torch.topk(log_w[:, None, :] + noise, n_hot, dim=-1).indices  # (b,S,k)

    def take(x):
        b, s, k = idx.shape
        flat = idx.reshape(b, s * k)
        if x.dim() == 3:
            out = torch.gather(x, 1, flat[..., None].expand(b, s * k, 3))
            return out.reshape(b, s, k, 3)
        return torch.gather(x, 1, flat).reshape(b, s, k)

    fits = weighted_kabsch(take(p), take(q), take(weights))  # (b, S, ...)
    pred = torch.einsum("bni,bsij->bsnj", p, fits.r) + fits.t[:, :, None, :]
    delta = torch.linalg.norm(pred - q[:, None], dim=-1)  # (b, S, n)
    thr = torch.as_tensor(threshold, dtype=p.dtype, device=p.device)
    if thr.dim() == 1:
        thr = thr[:, None, None]
    inliers = torch.exp(-delta / thr)

    best = torch.argmax(inliers.sum(dim=-1), dim=-1)  # (b,)
    best_inliers = inliers[torch.arange(p.shape[0], device=p.device), best]
    best_inliers = best_inliers / torch.clamp(
        torch.linalg.norm(best_inliers, dim=-1, keepdim=True), min=1e-12
    )
    best_inliers = torch.clamp(best_inliers, min=1e-7) * n
    return weighted_kabsch(p, q, weights * best_inliers)
