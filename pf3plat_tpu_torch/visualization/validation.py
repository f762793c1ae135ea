"""Validation visualization panels + orthographic gaussian projections.

Port of `pf3plat_tpu/visualization/validation.py`. Mirrors the reference's
rank-0 `validation_step` panels (`src/model/model_wrapper.py:416-596`):
side-by-side GT/render comparisons, depth panels, top-down orthographic
projections of the gaussian field (`src/visualization/validation_in_3d.py`
via the orthographic render path), and wobble/interpolation trajectory
videos.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.types import Gaussians
from ..ops.rasterizer import render_orthographic
from .layout import apply_depth_color_map, hcat, save_image, save_video, vcat
from .trajectories import generate_wobble, interpolate_extrinsics


def comparison_panel(
    context_images: np.ndarray,  # (v, h, w, 3)
    target_gt: np.ndarray,       # (t, h, w, 3)
    target_pred: np.ndarray,     # (t, h, w, 3)
    depth: np.ndarray | None = None,  # (v, h, w)
    path: Path | None = None,
) -> np.ndarray:
    rows = [
        hcat(*[np.asarray(i) for i in context_images]),
        hcat(*[np.asarray(i) for i in target_gt]),
        hcat(*[np.asarray(i) for i in target_pred]),
    ]
    if depth is not None:
        rows.append(hcat(*[apply_depth_color_map(d) for d in depth]))
    panel = vcat(*rows)
    if path is not None:
        save_image(panel, path)
    return panel


def project_gaussians_topdown(
    gaussians: Gaussians,
    batch_index: int = 0,
    resolution: int = 256,
    margin: float = 0.1,
) -> np.ndarray:
    """Orthographic top-down render of the gaussian field (world +Y down),
    on the gaussians' device."""
    means = gaussians.means[batch_index].detach().cpu().numpy()
    center = np.median(means, axis=0)
    extent = float(np.quantile(np.abs(means - center), 0.95) * (1 + margin)) * 2
    extent = max(extent, 1e-3)

    # Camera looking down -Y at the scene center.
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = np.asarray([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    extr[:3, 3] = center + np.asarray([0, -extent, 0], np.float32)

    dev = gaussians.means.device
    img = render_orthographic(
        torch.as_tensor(extr)[None],
        torch.full((1,), extent),
        torch.full((1,), extent),
        torch.zeros((1,)),
        torch.full((1,), 2 * extent),
        (resolution, resolution),
        torch.zeros((1, 3), device=dev),
        gaussians.means[batch_index][None],
        gaussians.covariances[batch_index][None],
        gaussians.harmonics[batch_index][None],
        gaussians.opacities[batch_index][None],
        device=dev,
    )
    return img[0].detach().cpu().numpy()


def render_trajectory_video(
    decode_fn,
    extrinsics_a: np.ndarray,  # (4, 4) c2w endpoints
    extrinsics_b: np.ndarray,
    num_frames: int = 30,
    mode: str = "interpolate",
    wobble_radius: float = 0.1,
    path: Path | None = None,
) -> list[np.ndarray]:
    """Render frames along a camera path; decode_fn(c2w (s,4,4)) -> (s,h,w,3)."""
    t = torch.linspace(0.0, 1.0, num_frames)
    a = torch.as_tensor(np.asarray(extrinsics_a, np.float32))
    if mode == "interpolate":
        b = torch.as_tensor(np.asarray(extrinsics_b, np.float32))
        traj = interpolate_extrinsics(a, b, t)
    elif mode == "wobble":
        traj = generate_wobble(a, torch.tensor(wobble_radius), t)
    else:
        raise ValueError(f"unknown trajectory mode {mode}")
    frames = [f.detach().cpu().numpy() for f in decode_fn(traj)]
    if path is not None:
        save_video(frames, path)
    return frames
