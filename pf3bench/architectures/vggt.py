"""`vggt`: VGGT-1B (arXiv 2503.11651) — a DINOv2 ViT-L/14 patch embedding with
registers, 24 frame/global attention pairs over every frame's tokens, an adaLN
camera head and depth and point DPT heads; served only. The program is the
port's model as its entry point builds it (`model.architecture=vggt` in the
configuration's tree); the reference is `reference/models/vggt.py`."""

from __future__ import annotations

import torch

from pf3bench import check, harness
from pf3bench.reference.models.vggt import VGGT, VGGTCfg
from pf3bench.reference.precision import reference_precision  # noqa: F401 (exported)


def build_program(tree: dict, device) -> tuple:
    """(the port's config of `tree`, the port's model on `device` with its
    own initialisation, before the seed's weights are loaded)."""
    from pf3plat_tpu_torch.main import build_model
    from pf3plat_tpu_torch.utils.config import load_config

    cfg = load_config(None, harness.overrides(tree))
    with torch.device(device):
        return cfg, build_model(cfg, device=device)


def model_cfg(tree: dict) -> VGGTCfg:
    """The reference's VGGT widths from the tree's `vggt` section."""
    return check.fill(VGGTCfg, tree.get("vggt", {}))


def build_reference(tree: dict, device) -> VGGT:
    """The reference with its own default initialisation from a fixed seed
    (only the statistics of that draw are used: `inputs.leaf_statistics`),
    made on `device`."""
    with torch.random.fork_rng(devices=[] if torch.device(device).type == "cpu" else None):
        torch.manual_seed(0)
        with torch.device(device):
            return VGGT(model_cfg(tree))
