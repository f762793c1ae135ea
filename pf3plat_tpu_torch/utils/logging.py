"""Local experiment logging (scalar jsonl + image dumps).

Port of `pf3plat_tpu/utils/logging.py`.

Plays the role of the reference's `LocalLogger`
(`src/misc/LocalLogger.py:12-47`, the wandb-less fallback): scalars stream
to `scalars.jsonl`, images land under `images/<tag>/<step>.png`. wandb
itself is intentionally not integrated (no network in the target
deployment; the reference's wandb checkpoint resolution is replaced by
local checkpoints, `training/checkpoints.py`).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


class LocalLogger:
    def __init__(self, output_dir: Path = Path("outputs/local")):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._scalars = (self.dir / "scalars.jsonl").open("a")

    def log_scalars(self, step: int, values: dict) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()

    def log_image(self, tag: str, step: int, image: np.ndarray) -> None:
        from ..visualization.layout import save_image

        save_image(image, self.dir / "images" / tag / f"{step:0>6}.png")

    def close(self) -> None:
        self._scalars.close()
