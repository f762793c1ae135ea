"""A tiny copy of the benchmark for the CPU tests: its metric readers, loops
and architectures with a tiny configuration of PF3plat, and one cell of each
of PF3plat's traffic kinds at 32 x 32. Each real cell that a metric lists is replaced by
the tiny cells that stand for it, and a real cell with no stand-in by none,
so that a new cell takes no entry here."""

from __future__ import annotations

import json
import shutil
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "model": {"tiny_backbones": True, "max_keypoints": 64, "max_matches": 32,
              "lightglue_layers": 2},
    "encoder": {"d_feature": 32, "d_backbone": 128, "num_depth_candidates": 16,
                "multiview_trans_attn_split": 2, "n_attn_layers": 2, "d_pose": 32,
                "ransac_samples": 32, "gaussian_adapter": {"sh_degree": 1},
                "costvolume_unet_feat_dim": 16, "costvolume_unet_channel_mult": [1, 1],
                "costvolume_unet_attn_res": [2], "depth_unet_feat_dim": 8,
                "depth_unet_attn_res": [4], "depth_unet_channel_mult": [1, 1, 1]},
    "decoder": {"raster": {"pairs_budget_factor": 0.48, "compact_min_pairs": 1024}},
    "dataset": {"roots": [], "image_shape": [32, 32], "original_image_shape": [72, 128]},
    "view_sampler": {"num_target_views": 1, "min_distance_between_context_views": 8,
                     "max_distance_between_context_views": 12},
}
K = {"fx": 0.86, "fy": 1.53, "cx": 0.5, "cy": 0.5}
TRAFFIC = {
    "tserve": {"kind": "serve", "views": 5, "image": [32, 32], "shift": 2, "intrinsics": K,
               "near": 1.0, "far": 100.0, "pool": 4, "warmup_requests": 1,
               "check_requests": 1, "profile_requests": 1},
    "ttrain": {"kind": "train", "batch": 2, "chunks": 1, "scenes_per_chunk": 2, "frames": 16,
               "frame_shape": [72, 128], "shift": 2, "jpeg_quality": 90, "intrinsics": K,
               "check_steps": 3, "profile_steps": 1},
}
# The tiny cells that stand for a cell of the benchmark; a cell missing here
# has none, and a metric that lists only such cells lists no tiny cell
TINY_OF = {"re10k-serve.eval": ["tiny.tserve"],
           "re10k-train.b14": ["tiny.ttrain"]}
# Limits for the tiny CPU cells, far above what the sound tiny runs read
# (<= 1e-3 in every relative gap and on the worst step's loss, <= 0.4 in
# the numbers in units of the reference's own gap at TF32, <= 0.01 on the
# worst leaf) and below what each planted fault and the control read.
LIMITS = {"perceive": 0.05, "keypoints": 0.05, "lightglue": 0.05, "means": 0.05,
          "covariances": 1.0, "opacities": 0.05, "harmonics": 1.0, "color": 0.01,
          "loss": 1e-3, "grad": 0.05, "update": 0.3, "update_median": 0.1}


def write_tiny(root: Path, source: Path = ROOT) -> Path:
    """A checkout-shaped directory under `root` with the tiny benchmark of
    the checkout at `source`: its `BENCHMARK.json`, metric readers, loops
    and architectures."""
    bench = root / "pf3bench"
    for d in ("configs", "traffic", "cells"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "loops", "architectures"):
        shutil.copytree(source / "pf3bench" / d, bench / d, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "tiny.json").write_text(json.dumps({"name": "tiny", "config": TINY}))
    data = json.loads((source / "BENCHMARK.json").read_text())
    data["configs"] = [{"name": "tiny", "source": "https://arxiv.org/abs/2410.22128",
                        "file": "pf3bench/configs/tiny.json", "reduced": [], "why": "tests"}]
    data["workloads"] = []
    for name, traffic in TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (bench / "cells" / f"tiny.{name}.json").write_text(json.dumps({"limits": LIMITS}))
        data["workloads"].append({"name": f"tiny.{name}", "config": "tiny", "traffic": name,
                                  "chips": 1, "why": "tests"})
    for m in data["end_to_end"] + data["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [t for w in m["workloads"] for t in TINY_OF.get(w, [])]
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return root
