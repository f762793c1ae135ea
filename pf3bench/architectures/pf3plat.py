"""`pf3plat`: PF3plat (arXiv 2410.22128) — frozen UniDepth-V2 ViT-L/14,
SuperPoint and LightGlue, the pose-free encoder and the streamed splat
decoder. The program is the port's model as its entry point builds it from
the port's config loader; the reference is `reference/models/pf3plat.py`.
The architecture of a configuration file with no `architecture` key."""

from __future__ import annotations

import dataclasses

import torch

from pf3bench import check, harness
from pf3bench.reference.models.backbones.unidepth import UniDepthCfg
from pf3bench.reference.models.decoder import DecoderCfg
from pf3bench.reference.models.encoder import EncoderCfg
from pf3bench.reference.models.gaussian_adapter import GaussianAdapterCfg
from pf3bench.reference.models.pf3plat import PF3plat, PF3platCfg
from pf3bench.reference.ops.rasterizer.types import RasterizeConfig
from pf3bench.reference.precision import reference_precision  # noqa: F401 (exported)


def build_program(tree: dict, device) -> tuple:
    """(the port's config of `tree`, the port's model on `device` with its
    own initialisation, before the seed's weights are loaded)."""
    from pf3plat_tpu_torch.main import build_model
    from pf3plat_tpu_torch.utils.config import load_config

    cfg = load_config(None, harness.overrides(tree))
    with torch.device(device):
        return cfg, build_model(cfg, device=device)


def model_cfg(tree: dict) -> PF3platCfg:
    """The reference's model configuration from a configuration file's
    `config` tree (the keys of the program's YAML configs)."""
    fill = check.fill
    model = tree.get("model", {})
    encoder = dict(tree.get("encoder", {}))
    adapter = fill(GaussianAdapterCfg, encoder.pop("gaussian_adapter", {}))
    decoder = dict(tree.get("decoder", {}))
    raster = decoder.pop("raster", None)
    dec = fill(DecoderCfg, decoder)
    if raster is not None:
        dec = dataclasses.replace(dec, raster=fill(RasterizeConfig, raster))
    return PF3platCfg(
        encoder=dataclasses.replace(fill(EncoderCfg, encoder), gaussian_adapter=adapter),
        decoder=dec,
        unidepth=UniDepthCfg.tiny_test() if model.get("tiny_backbones") else UniDepthCfg(),
        max_keypoints=model.get("max_keypoints", 1024),
        max_matches=model.get("max_matches", 512),
        lightglue_layers=model.get("lightglue_layers", 9),
        frozen_matmul_precision=model.get("frozen_matmul_precision", "bfloat16"),
    )


def build_reference(tree: dict, device) -> PF3plat:
    """The reference model with its own default initialisation from a fixed
    seed (only the statistics of that draw are used: `inputs.leaf_statistics`)."""
    with torch.random.fork_rng(devices=[] if torch.device(device).type == "cpu" else None):
        torch.manual_seed(0)
        return PF3plat(model_cfg(tree), device=device)
