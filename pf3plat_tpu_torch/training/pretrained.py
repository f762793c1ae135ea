"""Load converted pretrained frozen weights into the port's frozen modules.

Port of `pf3plat_tpu/training/pretrained.py`. The reference initializes its
frozen perception models from hub checkpoints at construction time
(`src/model/LightGlue/lightglue/superpoint.py:144-145`,
`lightglue.py:409-415`, `src/model/encoder/encoder_costvolume.py:81`
`UniDepthV2.from_pretrained`). The JAX package splits that into an offline
conversion step (torch -> `.pkl` Flax trees) and a loader; this is the
port's loader of the same `.pkl` files, through `weights.load_flat`, which
checks every leaf's path and shape so a converter/model mismatch fails
loudly instead of training against silently-random features.
"""

from __future__ import annotations

import pickle
from pathlib import Path

from ..weights import LIGHTGLUE_RULES, UNIDEPTH_RULES, flatten, load_flat

# .pkl artifact name (the JAX converter's) -> frozen module (PF3plat)
_ARTIFACTS = {
    "superpoint": "superpoint",
    "lightglue": "lightglue",
    "unidepth": "unidepth",   # full pixel_encoder (DINOv2) + pixel_decoder
    "lpips_vgg": "lpips",
}
_RULES = {"superpoint": [], "lightglue": LIGHTGLUE_RULES, "unidepth": UNIDEPTH_RULES,
          "lpips": []}


def load_pretrained_frozen(weights_dir: Path, model, require_all: bool = False) -> list[str]:
    """Load the converted `.pkl` trees found in `weights_dir` into the
    frozen modules of `model` (a `models.pf3plat.PF3plat`).

    Each present artifact must match its module leaf for leaf (paths and
    shapes). Missing artifacts keep their random init unless `require_all`.
    Returns the artifacts loaded."""
    weights_dir = Path(weights_dir)
    found = []
    for artifact, key in _ARTIFACTS.items():
        path = weights_dir / f"{artifact}.pkl"
        if not path.exists():
            if require_all:
                raise FileNotFoundError(
                    f"pretrained weights: missing {path} (required)"
                )
            continue
        with path.open("rb") as f:
            tree = pickle.load(f)
        load_flat(getattr(model, key), flatten(tree["params"]), _RULES[key],
                  f"pretrained {artifact}")
        found.append(artifact)
    if not found:
        raise FileNotFoundError(
            f"pretrained weights: no known artifacts "
            f"({', '.join(sorted(_ARTIFACTS))}) under {weights_dir}"
        )
    print(f"loaded pretrained frozen weights: {', '.join(found)}")
    return found
