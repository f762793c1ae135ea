"""Parity of the port's config loader (pf3plat_tpu_torch.utils.config) with
the JAX package's, on the CPU.

Every `configs/*.yaml` gives the port a `RootCfg` equal, field by field, to
the JAX `load_config`'s; overrides compose the same way, the encoder's
memory and precision knobs (remat, remat_mode, unet_dtype,
costvolume_dtype) included.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest
import torch

from pf3plat_tpu.utils import config as jconfig

from pf3plat_tpu_torch.models.noposplat import NoPoSplatCfg
from pf3plat_tpu_torch.models.vggt import VGGTCfg
from pf3plat_tpu_torch.utils import config as tconfig

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
CONFIGS = sorted(p.name for p in CONFIG_DIR.glob("*.yaml"))
# The encoder's memory and precision knobs at their defaults.
ENCODER_KNOBS = {"remat": True, "remat_mode": "selective", "unet_dtype": "float32",
                 "costvolume_dtype": "float32"}


def as_tree(cfg) -> dict:
    """A config as nested dicts. The port's own keys, which the JAX package
    has no twin of (`model.architecture` and the `noposplat` and `vggt`
    sections of the port's other architectures), must be at their defaults
    and are left out; every other field is compared."""
    tree = dataclasses.asdict(cfg)
    if "noposplat" in tree:
        assert tree["model"].pop("architecture") == "pf3plat"
        assert tree.pop("noposplat") == dataclasses.asdict(NoPoSplatCfg())
        assert tree.pop("vggt") == dataclasses.asdict(VGGTCfg())
    return tree


def test_every_config_is_listed():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    got = tconfig.load_config(CONFIG_DIR / name)
    want = jconfig.load_config(CONFIG_DIR / name)
    assert as_tree(got) == as_tree(want)
    assert tconfig.get_raw_cfg() == jconfig.get_raw_cfg()
    # every config runs the knobs' defaults
    assert {k: getattr(got.encoder, k) for k in ENCODER_KNOBS} == ENCODER_KNOBS


@pytest.mark.parametrize("overrides", [
    ['dataset.roots=["/x", "/y"]', "data_loader.batch_size=3", "max_steps=4"],
    ['checkpointing.directory="build/ck"', 'output_dir="out"', "checkpointing.keep=2",
     'test.output_path="o/t/x"', "train.val_check_interval=2"],
    ["encoder.gaussian_adapter.sh_degree=2", "decoder.raster.tile_size=12",
     'decoder.impl="pallas"', "optimizer.lr=1e-3", "model.frozen_matmul_precision=highest"],
    ["dataset.image_shape=[128, 128]", "weights=/w", "evaluation_index=/i.json",
     "train.tile_axis=2", "loss.lpips_weight=0.0"],
], ids=["data", "paths", "nested", "types"])
def test_overrides_match_jax(overrides):
    got = tconfig.load_config(CONFIG_DIR / "re10k.yaml", overrides)
    want = jconfig.load_config(CONFIG_DIR / "re10k.yaml", overrides)
    assert as_tree(got) == as_tree(want)
    assert isinstance(got.checkpointing.directory, Path)
    assert all(isinstance(r, Path) for r in got.dataset.roots)
    assert isinstance(got.dataset.image_shape, tuple)


def test_override_without_value_raises():
    with pytest.raises(ValueError):
        tconfig.load_config(None, ["max_steps"])


def test_unknown_key_raises():
    with pytest.raises(KeyError):
        tconfig.load_config(None, ["encoder.no_such_knob=1"])


@pytest.mark.parametrize("knob", sorted(ENCODER_KNOBS))
def test_encoder_knob_at_default_matches_jax(knob):
    value = ENCODER_KNOBS[knob]
    text = "true" if value is True else value
    ov = [f"encoder.{knob}={text}"]
    got = tconfig.load_config(CONFIG_DIR / "smoke.yaml", ov)
    assert as_tree(got) == as_tree(jconfig.load_config(CONFIG_DIR / "smoke.yaml", ov))


@pytest.mark.parametrize("override", [
    "encoder.remat=false", "encoder.remat_mode=full", "encoder.unet_dtype=bfloat16",
    "encoder.costvolume_dtype=bfloat16",
])
def test_encoder_knob_matches_jax(override):
    """Each knob off its default loads in both packages to equal configs;
    `remat_mode` other than "selective" reads as coarse in both (the JAX
    encoder remats the whole depth predictor then, encoder.py:215-226)."""
    got = tconfig.load_config(CONFIG_DIR / "smoke.yaml", [override])
    want = jconfig.load_config(CONFIG_DIR / "smoke.yaml", [override])
    assert as_tree(got) == as_tree(want)
    knob = override.split("=")[0].split(".")[1]
    assert getattr(got.encoder, knob) != ENCODER_KNOBS[knob]
    if knob == "remat_mode":
        assert want.encoder.remat and want.encoder.remat_mode != "selective"
        assert got.encoder.remat_policy == "coarse"
    # and reaches the model `main` builds
    from pf3plat_tpu_torch.main import build_model

    dp = build_model(got, device="cpu").encoder.depth_predictor
    assert dp.cfg.remat_unets == (got.encoder.remat_policy == "selective")
    assert dp.cv_unet.conv_in.compute_dtype == getattr(torch, got.encoder.unet_dtype)
    assert dp.cv_dtype == getattr(torch, got.encoder.costvolume_dtype)


def test_build_model_reads_the_config():
    """`main.build_model` carries the model section into `PF3platCfg`."""
    from pf3plat_tpu_torch.main import build_model
    from pf3plat_tpu_torch.models.backbones.unidepth import UniDepthCfg

    cfg = tconfig.load_config(CONFIG_DIR / "smoke.yaml",
                              ["model.frozen_matmul_precision=highest"])
    model = build_model(cfg, device="cpu")
    assert model.cfg.frozen_matmul_precision == "highest"
    assert model.cfg.encoder == cfg.encoder and model.cfg.decoder == cfg.decoder
    assert model.cfg.unidepth == UniDepthCfg.tiny_test()
    assert (model.cfg.max_keypoints, model.cfg.max_matches, model.cfg.lightglue_layers) == (
        64, 32, 2)
