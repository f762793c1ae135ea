"""Evaluation index generation: pick context pairs by view overlap.

Port of `pf3plat_tpu/evaluation/index_generator.py` (the reference's
`src/evaluation/evaluation_index_generator.py:47-159`): for each scene,
search frame pairs whose mutual ray-projection overlap falls in
[min_overlap, max_overlap], pick one (plus evenly spaced target views), and
emit `{scene: {"context": [...], "target": [...], "overlap": x}}` JSON.
The overlaps run on the card unless the caller passes `device="cpu"`; the
numpy generator's draws are the JAX package's, so the same scenes and seed
give the same index.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.epipolar import view_overlap


@dataclasses.dataclass
class IndexGeneratorCfg:
    num_target_views: int = 3
    min_distance: int = 40
    max_distance: int = 120
    min_overlap: float = 0.6
    max_overlap: float = 0.8
    output_path: Path = Path("outputs/evaluation_index.json")


def choose_pair(
    cfg: IndexGeneratorCfg,
    extrinsics: np.ndarray,  # (n, 4, 4) c2w
    intrinsics: np.ndarray,  # (n, 3, 3)
    rng: np.random.Generator,
    device=None,
):
    dev = resolve_device(device)
    extr = torch.as_tensor(np.asarray(extrinsics, np.float32), device=dev)
    intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev)
    n = extrinsics.shape[0]
    for i in rng.permutation(max(1, n - cfg.min_distance)):
        for gap in rng.permutation(
            np.arange(cfg.min_distance, cfg.max_distance + 1)
        ):
            j = i + int(gap)
            if j >= n:
                continue
            ov_ab = float(view_overlap(extr[i], intr[i], extr[j], intr[j]))
            ov_ba = float(view_overlap(extr[j], intr[j], extr[i], intr[i]))
            overlap = min(ov_ab, ov_ba)
            if cfg.min_overlap <= overlap <= cfg.max_overlap:
                targets = np.linspace(i, j, cfg.num_target_views + 2)[1:-1]
                return {
                    "context": [int(i), int(j)],
                    "target": [int(t) for t in np.round(targets)],
                    "overlap": overlap,
                }
        break  # one left-index scan is enough per scene (reference behavior)
    return None


def generate_index(
    cfg: IndexGeneratorCfg, scenes: dict, seed: int = 0, device=None
) -> dict:
    """scenes: {name: (extrinsics (n,4,4), intrinsics (n,3,3))}."""
    rng = np.random.default_rng(seed)
    index = {}
    for name, (extr, intr) in scenes.items():
        index[name] = choose_pair(cfg, np.asarray(extr), np.asarray(intr), rng, device)
    cfg.output_path.parent.mkdir(exist_ok=True, parents=True)
    cfg.output_path.write_text(json.dumps(index, indent=2))
    return index


def main(argv=None, device=None) -> None:
    """CLI (reference `src/scripts/generate_evaluation_index.py` equivalent):

    python -m pf3plat_tpu_torch.evaluation.index_generator DATASET_ROOT \\
        [--out index.json] [--stage test] [--seed 0]

    Walks the chunk files under DATASET_ROOT/STAGE and emits the
    {scene: {context, target, overlap} | null} JSON the evaluation
    protocol consumes.
    """
    import sys

    from ..data.dataset import convert_poses, load_chunk

    argv = list(sys.argv[1:] if argv is None else argv)

    def opt(flag, default):
        if flag in argv:
            i = argv.index(flag)
            v = argv[i + 1]
            del argv[i:i + 2]
            return v
        return default

    out = Path(opt("--out", "evaluation_index.json"))
    stage = opt("--stage", "test")
    seed = int(opt("--seed", "0"))
    if not argv:
        raise SystemExit(main.__doc__)
    root = Path(argv[0]) / stage

    scenes = {}
    chunks = sorted(root.glob("*.pfchunk")) or sorted(root.glob("*.torch"))
    for cpath in chunks:
        for ex in load_chunk(cpath):
            extr, intr = convert_poses(ex["cameras"])
            scenes[ex["key"]] = (extr, intr)
    index = generate_index(IndexGeneratorCfg(output_path=out), scenes, seed, device)
    n_valid = sum(v is not None for v in index.values())
    print(f"{out}: {n_valid}/{len(index)} scenes valid")


if __name__ == "__main__":
    main()
