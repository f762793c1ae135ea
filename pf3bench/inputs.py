"""Everything a run feeds the program, made from `--seed`: the weights, the
serving scenes and the training chunk files.

The scene and chunk generators are copies of `chip_smoke.py`'s
(`write_main_data`'s panned texture and camera rows); the weights follow
the reference's own default initialisation in distribution, drawn on the
device in one call. Nothing here imports the program.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# numpy SeedSequence streams of one run, by purpose (the seed is the run's)
WEIGHTS, SCENES, CHUNKS, RANSAC = range(4)


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream, *more]))


def torch_seed(seed: int, stream: int, *more: int) -> int:
    """A 63-bit torch seed drawn from (seed, stream, *more)."""
    state = np.random.SeedSequence([seed, stream, *more]).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def step_seed(seed: int, step: int) -> int:
    """The seed of a training step's RANSAC generator, as the training
    loop's `main.step_generator` forms it from (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


# ---- weights ----------------------------------------------------------------


def leaf_statistics(module: torch.nn.Module) -> dict[str, tuple[tuple, float, float]]:
    """{name: (shape, mean, std)} of every parameter of a freshly
    initialised `module`: the distribution its own initialisation draws."""
    out = {}
    for name, p in module.named_parameters():
        x = p.detach().float()
        std = float(x.std()) if x.numel() > 1 else 0.0
        out[name] = (tuple(p.shape), float(x.mean()), std)
    return out


def make_weights(stats: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 weights with each leaf's mean and spread, from one draw of a
    generator on `device` seeded from `seed`: views into one buffer."""
    total = sum(int(np.prod(shape)) for shape, _, _ in stats.values())
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, mean, std) in stats.items():
        n = int(np.prod(shape))
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(std).add_(mean)
        out[name] = leaf
        at += n
    return out


@torch.no_grad()
def load_weights(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `module`'s parameters; the names must match both
    ways."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) - set(params))[:5]
        extra = sorted(set(params) - set(weights))[:5]
        raise ValueError(f"parameter names differ: absent {missing}, unknown {extra}")
    for name, p in params.items():
        p.copy_(weights[name])


# ---- scenes -----------------------------------------------------------------


def texture(r: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth uint8 texture (h, w, 3): uniform noise at 1/8 size, bicubic
    upsampling, Gaussian grain (`chip_smoke.write_main_data`)."""
    from PIL import Image

    small = r.uniform(0, 255, (max(1, h // 8), max(1, w // 8), 3)).astype(np.uint8)
    tex = np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC), np.float32)
    tex = tex + r.normal(0, 6, tex.shape)
    return np.clip(tex, 0, 255).astype(np.uint8)


def intrinsics(traffic: dict, n: int) -> np.ndarray:
    k = traffic["intrinsics"]
    intr = np.zeros((n, 3, 3), np.float32)
    intr[:, 0, 0], intr[:, 1, 1] = k["fx"], k["fy"]
    intr[:, 0, 2], intr[:, 1, 2], intr[:, 2, 2] = k["cx"], k["cy"], 1.0
    return intr


def serve_scene(traffic: dict, seed: int, index: int) -> dict:
    """Request `index` of a serving mix: `views` 256-pixel crops of one
    texture panned `shift` pixels a view (the camera moving along x),
    normalised intrinsics, near and far, as float32 host arrays with a
    batch axis of 1."""
    r = rng(seed, SCENES, index)
    h, w = traffic["image"]
    v, shift = traffic["views"], traffic["shift"]
    tex = texture(r, h, w + shift * (v - 1))
    images = np.stack([tex[:, i * shift:i * shift + w] for i in range(v)]).astype(np.float32)
    return dict(
        images=images[None] / 255.0,
        intrinsics=intrinsics(traffic, v)[None],
        near=np.full((1, v), traffic["near"], np.float32),
        far=np.full((1, v), traffic["far"], np.float32),
    )


def ransac_seed(seed: int, index: int) -> int:
    return torch_seed(seed, RANSAC, index)


# ---- training chunks ----------------------------------------------------------


def _jpeg(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def chunk_scene(r: np.random.Generator, key: str, traffic: dict) -> dict:
    """One RE10K-shaped scene: `frames` JPEGs of `frame_shape` panned
    `shift` pixels a frame over one texture, camera rows (fx fy cx cy, 2
    unused, row-major 3x4 w2c) moving 0.02 a frame along x
    (`chip_smoke.write_main_data`)."""
    h, w = traffic["frame_shape"]
    f, shift = traffic["frames"], traffic["shift"]
    tex = texture(r, h, w + shift * f)
    k = traffic["intrinsics"]
    cams = np.zeros((f, 18), np.float32)
    cams[:, :4] = [k["fx"], k["fy"], k["cx"], k["cy"]]
    for i in range(f):
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = -0.02 * i
        cams[i, 6:] = w2c[:3].reshape(-1)
    return {"key": key, "cameras": cams,
            "frames": [tex[:, i * shift:i * shift + w] for i in range(f)]}


def write_chunks(root: Path, traffic: dict, seed: int, workers: int = 4) -> Path:
    """The training split of a dataset root under `root/<seed>`: `chunks`
    `.torch` chunk files of `scenes_per_chunk` scenes each (the RE10K
    container: a list of {key, cameras, images as uint8 JPEG tensors}).
    Written once a seed: a finished root is reused."""
    out = root / str(seed)
    done = out / "complete"
    if done.exists():
        return out
    split = out / "train"
    split.mkdir(parents=True, exist_ok=True)
    r = rng(seed, CHUNKS)
    q = traffic["jpeg_quality"]
    with ThreadPoolExecutor(workers) as pool:
        for c in range(traffic["chunks"]):
            scenes = [chunk_scene(r, f"{seed}_{c}_{s}", traffic)
                      for s in range(traffic["scenes_per_chunk"])]
            encoded = [list(pool.map(lambda fr: _jpeg(fr, q), sc["frames"])) for sc in scenes]
            torch.save([{"key": sc["key"], "cameras": torch.from_numpy(sc["cameras"]),
                         "images": [torch.frombuffer(bytearray(b), dtype=torch.uint8)
                                    for b in enc]}
                        for sc, enc in zip(scenes, encoded)], split / f"{c:06}.torch")
    done.write_text("")
    return out
