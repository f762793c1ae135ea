"""SSIM (gaussian window), NHWC; port of `pf3plat_tpu/ops/ssim.py`.

11x11 gaussian window, sigma 1.5, same-padding depthwise convolutions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Same-padding depthwise 2D conv, NHWC."""
    c = x.shape[-1]
    k = window.shape[0]
    weight = window[None, None].expand(c, 1, k, k)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=k // 2, groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01**2, c2: float = 0.03**2,
         size_average: bool = True) -> torch.Tensor:
    """img1, img2: (b, h, w, c) in [0, 1]. Returns a scalar (or per image)."""
    window = torch.as_tensor(_gaussian_window(window_size, sigma), dtype=img1.dtype,
                             device=img1.device)
    mu1 = _depthwise_blur(img1, window)
    mu2 = _depthwise_blur(img2, window)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
