"""`noposplat`: NoPoSplat (arXiv 2410.24207) — a ViT-L/16 encoder with
RoPE-2D shared by two unposed views, two cross-view ViT-B decoders and DPT
heads to 3D Gaussians in the first view's frame, every parameter trained.
The program is the port's model as its entry point builds it
(`model.architecture=noposplat` in the configuration's tree); the reference
is `reference/models/noposplat.py`."""

from __future__ import annotations

import dataclasses

import torch

from pf3bench import check, harness
from pf3bench.reference.models.decoder import DecoderCfg
from pf3bench.reference.models.noposplat import AdapterCfg, NoPoSplatCfg, NoPoSplatTrainer
from pf3bench.reference.ops.rasterizer.types import RasterizeConfig
from pf3bench.reference.precision import reference_precision  # noqa: F401 (exported)


def build_program(tree: dict, device) -> tuple:
    """(the port's config of `tree`, the port's model on `device` with its
    own initialisation, before the seed's weights are loaded)."""
    from pf3plat_tpu_torch.main import build_model
    from pf3plat_tpu_torch.utils.config import load_config

    cfg = load_config(None, harness.overrides(tree))
    return cfg, build_model(cfg, device=device)


def model_cfg(tree: dict) -> NoPoSplatCfg:
    """The reference's NoPoSplat widths from the tree's `noposplat` section."""
    section = dict(tree.get("noposplat", {}))
    adapter = check.fill(AdapterCfg, section.pop("gaussian_adapter", {}))
    return dataclasses.replace(check.fill(NoPoSplatCfg, section), gaussian_adapter=adapter)


def decoder_cfg(tree: dict) -> DecoderCfg:
    decoder = dict(tree.get("decoder", {}))
    raster = decoder.pop("raster", None)
    dec = check.fill(DecoderCfg, decoder)
    return dec if raster is None else dataclasses.replace(
        dec, raster=check.fill(RasterizeConfig, raster))


def build_reference(tree: dict, device) -> NoPoSplatTrainer:
    """The reference with its own default initialisation from a fixed seed
    (only the statistics of that draw are used: `inputs.leaf_statistics`)."""
    with torch.random.fork_rng(devices=[] if torch.device(device).type == "cpu" else None):
        torch.manual_seed(0)
        return NoPoSplatTrainer(model_cfg(tree), decoder_cfg(tree)).to(device)
