"""Matching front-end: images -> fixed-size Correspondences (port of
`pf3plat_tpu/models/backbones/matching.py`)."""

from __future__ import annotations

import torch

from ...utils.profiling import span
from ..encoder import Correspondences, view_pairs
from .lightglue import LightGlue
from .superpoint import Keypoints, SuperPoint, top_k_stable


def match_context_views(superpoint: SuperPoint, lightglue: LightGlue,
                        images: torch.Tensor, max_matches: int = 512) -> Correspondences:
    """SuperPoint once per view, LightGlue per view pair, then the top
    `max_matches` mutual matches by score (ties to the lower index)."""
    b, v, h, w, _ = images.shape
    pair_i, pair_j = view_pairs(v)
    with span("pf3.perceive.superpoint"):
        kp = superpoint(images.reshape(b * v, h, w, 3))
        kp = Keypoints(*(x.reshape(b, v, *x.shape[1:]) for x in kp))

    def take(x, idx):
        if x.dim() == 3:
            return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
        return torch.gather(x, 1, idx)

    with span("pf3.perceive.lightglue"):
        k0_list, k1_list, s_list, v_list = [], [], [], []
        for i, j in zip(pair_i, pair_j):
            kp_i = Keypoints(*(x[:, i] for x in kp))
            kp_j = Keypoints(*(x[:, j] for x in kp))
            res = lightglue(kp_i, kp_j, (h, w))
            score = torch.where(res.valid, res.scores0, torch.full_like(res.scores0, -1.0))
            top_s, top_idx = top_k_stable(score, max_matches)
            sel_valid = top_s > 0
            m0_sel = take(torch.clamp(res.m0, min=0), top_idx)
            k0_list.append(take(kp_i.xy, top_idx))
            k1_list.append(take(kp_j.xy, m0_sel))
            s_list.append(torch.where(sel_valid, top_s, torch.zeros_like(top_s)))
            v_list.append(sel_valid)
        return Correspondences(
            kpts0=torch.stack(k0_list, dim=1), kpts1=torch.stack(k1_list, dim=1),
            scores=torch.stack(s_list, dim=1), valid=torch.stack(v_list, dim=1),
        )
