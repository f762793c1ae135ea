"""Data shims: crop/rescale, patch alignment, flip augmentation (numpy).

Port of `pf3plat_tpu/data/shims.py` (the port's own copy; PIL's Lanczos
resample as in the JAX package). Mirrors `src/dataset/shims/` with channel-last images:
  * `apply_crop_shim`        — rescale (Lanczos) + center crop with intrinsics
    fixup (`crop_shim.py:51-93`)
  * `apply_patch_shim`       — crop to patch-divisible dims (`patch_shim.py:4-38`)
  * `apply_augmentation_shim`— 50% horizontal flip with extrinsic reflection
    (`augmentation_shim.py:8-37`)
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from .types import Example, Views


def _rescale(image: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """(h, w, 3) float [0,1] -> Lanczos resize to shape."""
    h, w = shape
    img8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    out = Image.fromarray(img8).resize((w, h), Image.LANCZOS)
    return np.asarray(out, np.float32) / 255.0


def _center_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    h_in, w_in = images.shape[-3:-1]
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[..., row : row + h_out, col : col + w_out, :]
    intrinsics = intrinsics.copy()
    intrinsics[..., 0, 0] *= w_in / w_out
    intrinsics[..., 1, 1] *= h_in / h_out
    return images, intrinsics


def rescale_and_crop(
    images: np.ndarray, intrinsics: np.ndarray, shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray]:
    h_in, w_in = images.shape[-3:-1]
    h_out, w_out = shape
    assert h_out <= h_in and w_out <= w_in
    scale = max(h_out / h_in, w_out / w_in)
    h_s, w_s = round(h_in * scale), round(w_in * scale)
    assert h_s == h_out or w_s == w_out
    rescaled = np.stack(
        [_rescale(img, (h_s, w_s)) for img in images.reshape(-1, h_in, w_in, 3)]
    ).reshape(*images.shape[:-3], h_s, w_s, 3)
    return _center_crop(rescaled, intrinsics, shape)


def apply_crop_shim(example: Example, shape: tuple[int, int]) -> Example:
    def views(v: Views) -> Views:
        image, intr = rescale_and_crop(v["image"], v["intrinsics"], shape)
        return {**v, "image": image, "intrinsics": intr}

    return {
        **example,
        "context": views(example["context"]),
        "target": views(example["target"]),
    }


def apply_patch_shim(example: Example, patch_size: int) -> Example:
    def views(v: Views) -> Views:
        h, w = v["image"].shape[-3:-1]
        h_new = (h // patch_size) * patch_size
        w_new = (w // patch_size) * patch_size
        row, col = (h - h_new) // 2, (w - w_new) // 2
        image = v["image"][..., row : row + h_new, col : col + w_new, :]
        intr = v["intrinsics"].copy()
        intr[..., 0, 0] *= w / w_new
        intr[..., 1, 1] *= h / h_new
        return {**v, "image": image, "intrinsics": intr}

    return {
        **example,
        "context": views(example["context"]),
        "target": views(example["target"]),
    }


def reflect_extrinsics(extrinsics: np.ndarray) -> np.ndarray:
    reflect = np.eye(4, dtype=np.float32)
    reflect[0, 0] = -1
    return reflect @ extrinsics @ reflect


def apply_augmentation_shim(
    example: Example, rng: np.random.Generator
) -> Example:
    if rng.random() < 0.5:
        return example

    def views(v: Views) -> Views:
        return {
            **v,
            "image": v["image"][..., ::-1, :].copy(),
            "extrinsics": reflect_extrinsics(v["extrinsics"]),
        }

    return {
        **example,
        "context": views(example["context"]),
        "target": views(example["target"]),
    }
