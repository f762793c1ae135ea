"""Image layout + colormap helpers (numpy, channel-last).

Port of `pf3plat_tpu/visualization/layout.py` (the port's own copy; PNG and
animated GIF through PIL as in the JAX package).

Mirrors the reference's `src/visualization/` utilities used for validation
panels: horizontal/vertical concatenation with borders (`layout.py`),
turbo-style depth colormaps (`color_map.py`), and image saving.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _to_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def add_border(img: np.ndarray, width: int = 2, color=1.0) -> np.ndarray:
    img = _to_hwc(img)
    h, w, c = img.shape
    out = np.full((h + 2 * width, w + 2 * width, c), color, img.dtype)
    out[width:-width, width:-width] = img
    return out


def hcat(*images, gap: int = 2, gap_color=1.0) -> np.ndarray:
    images = [_to_hwc(i) for i in images]
    h = max(i.shape[0] for i in images)
    cols = []
    for i, img in enumerate(images):
        pad = h - img.shape[0]
        img = np.pad(img, ((0, pad), (0, 0), (0, 0)), constant_values=0)
        cols.append(img)
        if i != len(images) - 1:
            cols.append(np.full((h, gap, img.shape[-1]), gap_color, img.dtype))
    return np.concatenate(cols, axis=1)


def vcat(*images, gap: int = 2, gap_color=1.0) -> np.ndarray:
    images = [_to_hwc(i) for i in images]
    w = max(i.shape[1] for i in images)
    rows = []
    for i, img in enumerate(images):
        pad = w - img.shape[1]
        img = np.pad(img, ((0, 0), (0, pad), (0, 0)), constant_values=0)
        rows.append(img)
        if i != len(images) - 1:
            rows.append(np.full((gap, w, img.shape[-1]), gap_color, img.dtype))
    return np.concatenate(rows, axis=0)


def apply_depth_color_map(depth: np.ndarray, near=None, far=None) -> np.ndarray:
    """Inverse-depth viridis-ish colormap -> (h, w, 3) in [0, 1]."""
    depth = np.asarray(depth, np.float64)
    disp = 1.0 / np.maximum(depth, 1e-8)
    lo = disp.min() if far is None else 1.0 / far
    hi = disp.max() if near is None else 1.0 / near
    x = np.clip((disp - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    # Compact turbo-like polynomial approximation.
    r = np.clip(1.6 * x - 0.2, 0, 1)
    g = np.clip(np.sin(np.pi * x) ** 1.5, 0, 1)
    b = np.clip(1.2 - 1.6 * x, 0, 1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def save_image(img: np.ndarray, path: Path) -> None:
    from PIL import Image

    img = np.clip(_to_hwc(np.asarray(img)), 0, 1)
    Path(path).parent.mkdir(exist_ok=True, parents=True)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def save_video(frames: list[np.ndarray], path: Path, fps: int = 30) -> None:
    """Save frames as an animated artifact. Without ffmpeg/skvideo in the
    image, falls back to an animated GIF (same call sites as the reference's
    `save_video`, `src/misc/image_io.py`)."""
    from PIL import Image

    Path(path).parent.mkdir(exist_ok=True, parents=True)
    imgs = [
        Image.fromarray((np.clip(_to_hwc(f), 0, 1) * 255).astype(np.uint8))
        for f in frames
    ]
    gif_path = Path(path).with_suffix(".gif")
    imgs[0].save(
        gif_path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
