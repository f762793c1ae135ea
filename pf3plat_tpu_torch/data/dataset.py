"""RE10K/ACID/DL3DV-style chunk dataset reader (host-side numpy pipeline).

Port of `pf3plat_tpu/data/dataset.py` (the port's own copy; numpy and PIL
as in the JAX package, so examples and batches are bit-equal to its own at
the same seed). Mirrors `src/dataset/dataset_re10k.py:55-294`: iterates `.torch` chunk files
(lists of {key, cameras (n,18), images: encoded JPEGs}), decodes the 18-float
camera rows into normalized intrinsics + c2w extrinsics, samples context /
target views, applies the *union trick* (context <- target <- sorted(context
U target), `dataset_re10k.py:155-157`), optional baseline-1 rescaling, flip
augmentation, and the crop shim.

torch (CPU) is used only to deserialize the reference's chunk container
format; everything downstream is numpy. The training loop moves each batch
to the device (`main.py`). Host sharding: each process takes
`chunks[host_id::num_hosts]`.
"""

from __future__ import annotations

import dataclasses
import io
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
from PIL import Image

from .shims import apply_augmentation_shim, apply_crop_shim
from .types import Example
from .view_samplers import SampleError


@dataclasses.dataclass
class DatasetCfg:
    roots: Sequence[Path]
    image_shape: tuple[int, int] = (256, 256)
    near: float = 1.0
    far: float = 100.0
    baseline_epsilon: float = 1e-3
    make_baseline_1: bool = False
    baseline_scale_bounds: bool = False
    max_fov: float = 100.0
    augment: bool = True
    skip_bad_shape: bool = True
    original_image_shape: tuple[int, int] = (360, 640)
    # Debug: restrict iteration to one scene key (reference
    # `dataset.overfit_to_scene`, config/main.yaml) — each pass over the
    # data yields just that scene, so training overfits it.
    overfit_to_scene: Optional[str] = None


def convert_poses(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, 18) rows -> (c2w extrinsics (n,4,4), normalized intrinsics (n,3,3)).

    Row layout (reference `dataset_re10k.py:224-241`): fx fy cx cy _ _ then
    a row-major 3x4 w2c matrix.
    """
    n = poses.shape[0]
    intr = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    intr[:, 0, 0] = poses[:, 0]
    intr[:, 1, 1] = poses[:, 1]
    intr[:, 0, 2] = poses[:, 2]
    intr[:, 1, 2] = poses[:, 3]
    w2c = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2c[:, :3] = poses[:, 6:].reshape(n, 3, 4)
    return np.linalg.inv(w2c), intr


def decode_images(raw_images: Sequence) -> np.ndarray:
    """List of encoded JPEG byte arrays -> (n, h, w, 3) float32 [0,1]."""
    out = []
    for buf in raw_images:
        arr = np.asarray(buf, dtype=np.uint8)
        img = Image.open(io.BytesIO(arr.tobytes()))
        out.append(np.asarray(img.convert("RGB"), np.float32) / 255.0)
    return np.stack(out)


def _get_fov_deg(intrinsics: np.ndarray) -> np.ndarray:
    fx = intrinsics[:, 0, 0]
    fy = intrinsics[:, 1, 1]
    fov_x = 2 * np.arctan(0.5 / fx)
    fov_y = 2 * np.arctan(0.5 / fy)
    return np.degrees(np.stack([fov_x, fov_y], -1))


def load_chunk(path: Path) -> list[dict]:
    """Deserialize one chunk into numpy dicts.

    `.pfchunk` files use the native mmap reader (no pickle,
    `native/pfchunk.cc`); `.torch` files go through `torch.load` (the
    reference's container).
    """
    if Path(path).suffix == ".pfchunk":
        from ..native import PfChunkReader

        r = PfChunkReader(Path(path))
        out = []
        for s_idx in range(len(r)):
            out.append({
                "key": r.key(s_idx),
                "cameras": np.array(r.cameras(s_idx)),
                "images": [
                    np.frombuffer(r.jpeg(s_idx, f), dtype=np.uint8)
                    for f in range(r.num_frames(s_idx))
                ],
            })
        r.close()
        return out

    import torch

    chunk = torch.load(path, map_location="cpu", weights_only=False)
    out = []
    for ex in chunk:
        item = {
            "key": ex["key"],
            "cameras": np.asarray(ex["cameras"], np.float32),
            "images": ex["images"],
        }
        if "overlap" in ex:
            item["overlap"] = float(np.asarray(ex["overlap"]).reshape(-1)[0])
        out.append(item)
    return out


class ChunkDataset:
    """Iterable over Examples. One instance per (stage, host)."""

    def __init__(
        self,
        cfg: DatasetCfg,
        view_sampler,
        stage: str = "train",
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.view_sampler = view_sampler
        self.stage = stage
        self.rng = np.random.default_rng(seed + host_id)
        chunks: list[Path] = []
        for root in cfg.roots:
            stage_dir = Path(root) / ("test" if stage == "val" else stage)
            if stage_dir.exists():
                native = sorted(stage_dir.glob("*.pfchunk"))
                chunks.extend(native if native else sorted(stage_dir.glob("*.torch")))
        self.chunks = chunks[host_id::num_hosts]

    def __iter__(self) -> Iterator[Example]:
        return self.examples(global_step=0)

    def plans(self, get_step) -> Iterator[tuple[dict, dict]]:
        """One epoch of (raw example, sampled plan) pairs.

        The single RNG-consuming walk shared by the synchronous path below
        and the worker-pool path (`data/prefetch.py`) — both consume the
        random stream identically, so results are worker-count independent.
        `get_step` is read per example (prefetching may sample slightly
        ahead of the true step, like the reference's loader workers).
        """
        order = (
            self.rng.permutation(len(self.chunks))
            if self.stage == "train"
            else np.arange(len(self.chunks))
        )
        for ci in order:
            chunk = load_chunk(self.chunks[ci])
            if self.stage == "train":
                chunk = [chunk[i] for i in self.rng.permutation(len(chunk))]
            for ex in chunk:
                plan = self._sample_example(ex, get_step())
                if plan is not None:
                    yield ex, plan

    def examples(self, global_step: int = 0) -> Iterator[Example]:
        for ex, plan in self.plans(lambda: global_step):
            result = self._realize_example(ex, plan)
            if result is not None:
                yield result

    def _sample_example(self, ex: dict, global_step: int) -> Optional[dict]:
        """RNG-consuming phase: view sampling + augmentation seed draw.

        Runs on the iteration thread (self.rng is not thread-safe); the
        returned plan makes `_realize_example` pure, so JPEG decode can run
        on a worker pool (`data/prefetch.py`) — in place of the reference's
        multi-worker DataLoaders
        (`src/dataset/data_module.py:90-110`).
        """
        cfg = self.cfg
        scene = ex["key"]
        if cfg.overfit_to_scene is not None and scene != cfg.overfit_to_scene:
            return None
        extrinsics, intrinsics = convert_poses(ex["cameras"])
        try:
            ctx_idx, tgt_idx = self.view_sampler.sample(
                scene, extrinsics.shape[0], self.rng, global_step
            )
        except SampleError:
            return None
        if (_get_fov_deg(intrinsics) > cfg.max_fov).any():
            return None

        # Union trick: context and target both become sorted(context U target).
        union = np.asarray(
            sorted(set(ctx_idx.tolist()) | set(tgt_idx.tolist())), np.int64
        )
        return {
            "extrinsics": extrinsics,
            "intrinsics": intrinsics,
            "scene": scene,
            "union": union,
            "aug_seed": int(self.rng.integers(2**31 - 1)),
        }

    def _build_example(self, ex: dict, global_step: int) -> Optional[Example]:
        plan = self._sample_example(ex, global_step)
        if plan is None:
            return None
        return self._realize_example(ex, plan)

    def _realize_example(self, ex: dict, plan: dict) -> Optional[Example]:
        """Pure decode/shim phase — thread-safe given a sampled plan."""
        cfg = self.cfg
        extrinsics = plan["extrinsics"]
        intrinsics = plan["intrinsics"]
        scene = plan["scene"]
        union = plan["union"]
        ctx_idx = tgt_idx = union

        images = decode_images([ex["images"][i] for i in union])
        if cfg.skip_bad_shape and images.shape[1:3] != tuple(
            cfg.original_image_shape
        ):
            return None

        scale = 1.0
        if len(union) == 2 and cfg.make_baseline_1:
            a, b = extrinsics[union][:, :3, 3]
            scale = float(np.linalg.norm(a - b))
            if scale < cfg.baseline_epsilon:
                return None
            extrinsics = extrinsics.copy()
            extrinsics[:, :3, 3] /= scale
        nf_scale = scale if cfg.baseline_scale_bounds else 1.0

        def views(idx):
            n = len(idx)
            return {
                "extrinsics": extrinsics[idx],
                "intrinsics": intrinsics[idx],
                "image": images,
                "near": np.full((n,), cfg.near / nf_scale, np.float32),
                "far": np.full((n,), cfg.far / nf_scale, np.float32),
                "index": idx,
            }

        example: Example = {
            "context": views(ctx_idx),
            "target": views(tgt_idx),
            "scene": scene,
        }
        if "overlap" in ex:
            example["overlap"] = ex["overlap"]  # type: ignore[typeddict-unknown-key]
        if self.stage == "train" and cfg.augment:
            example = apply_augmentation_shim(
                example, np.random.default_rng(plan["aug_seed"])
            )
        return apply_crop_shim(example, tuple(cfg.image_shape))


def batch_examples(examples: Sequence[Example]) -> dict:
    """Stack a list of fixed-shape Examples into a batched dict."""
    def stack_views(key):
        return {
            k: np.stack([np.asarray(e[key][k]) for e in examples])
            for k in examples[0][key]
        }

    return {
        "context": stack_views("context"),
        "target": stack_views("target"),
        "scene": [e["scene"] for e in examples],
    }
