"""SuperPoint keypoints + descriptors with fixed-K selection (port of
`pf3plat_tpu/models/backbones/superpoint.py`); layer names are the released
checkpoint's (conv1a..convDb)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


class Keypoints(NamedTuple):
    xy: torch.Tensor           # (b, k, 2) pixel coords (x, y)
    scores: torch.Tensor       # (b, k)
    descriptors: torch.Tensor  # (b, k, 256)
    valid: torch.Tensor        # (b, k) bool


def simple_nms(scores: torch.Tensor, radius: int, iterations: int = 2) -> torch.Tensor:
    """Max-pool NMS with -inf "SAME" padding. scores (b, h, w)."""
    size = radius * 2 + 1

    def max_pool(x):
        return F.max_pool2d(x[:, None], size, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(iterations):
        supp_mask = max_pool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def top_k_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis; ties go to the lower index (`lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _descriptor_sample(desc: torch.Tensor, xy: torch.Tensor, s: int = 8) -> torch.Tensor:
    """Bilinear sample of NHWC (b, hc, wc, c) descriptors at pixel coords
    (align-corners grid in the s-downsampled map), L2-normalized."""
    b, hc, wc, c = desc.shape
    gx = (xy[..., 0] - s / 2 + 0.5) / s
    gy = (xy[..., 1] - s / 2 + 0.5) / s
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    flat = desc.reshape(b, hc * wc, c)

    def tap(yy, xx):
        xi = torch.clamp(xx, 0, wc - 1).to(torch.int64)
        yi = torch.clamp(yy, 0, hc - 1).to(torch.int64)
        return torch.gather(flat, 1, (yi * wc + xi)[..., None].expand(*xi.shape, c))

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    out = top * (1 - fy) + bot * fy
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)


class SuperPoint(nn.Module):
    def __init__(self, max_num_keypoints: int = 1024, nms_radius: int = 4,
                 detection_threshold: float = 0.0005, remove_borders: int = 4,
                 descriptor_dim: int = 256):
        super().__init__()
        self.max_num_keypoints = max_num_keypoints
        self.nms_radius = nms_radius
        self.detection_threshold = detection_threshold
        self.remove_borders = remove_borders
        c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
        self.conv1a = nn.Conv2d(1, c1, 3, padding=1)
        self.conv1b = nn.Conv2d(c1, c1, 3, padding=1)
        self.conv2a = nn.Conv2d(c1, c2, 3, padding=1)
        self.conv2b = nn.Conv2d(c2, c2, 3, padding=1)
        self.conv3a = nn.Conv2d(c2, c3, 3, padding=1)
        self.conv3b = nn.Conv2d(c3, c3, 3, padding=1)
        self.conv4a = nn.Conv2d(c3, c4, 3, padding=1)
        self.conv4b = nn.Conv2d(c4, c4, 3, padding=1)
        self.convPa = nn.Conv2d(c4, c5, 3, padding=1)
        self.convPb = nn.Conv2d(c5, 65, 1)
        self.convDa = nn.Conv2d(c4, c5, 3, padding=1)
        self.convDb = nn.Conv2d(c5, descriptor_dim, 1)

    def forward(self, image: torch.Tensor) -> Keypoints:
        """image (b, h, w, 3) RGB in [0, 1] -> fixed-K masked keypoints."""
        b = image.shape[0]
        gray = (0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2])[:, None]
        x = F.relu(self.conv1a(gray))
        x = F.max_pool2d(F.relu(self.conv1b(x)), 2, 2)
        x = F.relu(self.conv2a(x))
        x = F.max_pool2d(F.relu(self.conv2b(x)), 2, 2)
        x = F.relu(self.conv3a(x))
        x = F.max_pool2d(F.relu(self.conv3b(x)), 2, 2)
        x = F.relu(self.conv4a(x))
        x = F.relu(self.conv4b(x))

        logits = self.convPb(F.relu(self.convPa(x))).permute(0, 2, 3, 1)  # (b, hc, wc, 65)
        scores = torch.softmax(logits.float(), dim=-1)[..., :-1]
        hc, wc = scores.shape[1:3]
        scores = scores.reshape(b, hc, wc, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, hc * 8, wc * 8)
        scores = simple_nms(scores, self.nms_radius)
        pad = self.remove_borders
        if pad:
            mask = torch.zeros((hc * 8, wc * 8), dtype=torch.bool, device=scores.device)
            mask[pad:-pad, pad:-pad] = True
            scores = torch.where(mask[None], scores, torch.full_like(scores, -1.0))

        top_scores, top_idx = top_k_stable(scores.reshape(b, -1), self.max_num_keypoints)
        ys = torch.div(top_idx, wc * 8, rounding_mode="floor").to(torch.float32)
        xs = (top_idx % (wc * 8)).to(torch.float32)
        xy = torch.stack([xs, ys], dim=-1)
        valid = top_scores > self.detection_threshold

        desc = self.convDb(F.relu(self.convDa(x))).permute(0, 2, 3, 1).float()
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12)
        descriptors = _descriptor_sample(desc, xy)
        return Keypoints(
            xy=xy,
            scores=torch.where(valid, top_scores, torch.zeros_like(top_scores)),
            descriptors=torch.where(valid[..., None], descriptors, torch.zeros_like(descriptors)),
            valid=valid,
        )
