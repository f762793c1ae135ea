"""Parity of the port's config loader (pf3plat_tpu_torch.utils.config) with
the JAX package's, on the CPU.

Every `configs/*.yaml` gives the port a `RootCfg` equal, field by field, to
the JAX `load_config`'s (the JAX-only encoder knobs aside); overrides
compose the same way; the JAX-only knobs are accepted at their JAX
defaults and raise on any other value.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest

from pf3plat_tpu.utils import config as jconfig

from pf3plat_tpu_torch.utils import config as tconfig

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
CONFIGS = sorted(p.name for p in CONFIG_DIR.glob("*.yaml"))
JAX_ONLY = {"remat": True, "remat_mode": "selective", "unet_dtype": "float32",
            "costvolume_dtype": "float32"}


def as_tree(cfg) -> dict:
    """A config as nested dicts, without the JAX-only encoder knobs."""
    tree = dataclasses.asdict(cfg)
    for k in JAX_ONLY:
        tree["encoder"].pop(k, None)
    return tree


def test_every_config_is_listed():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_jax(name):
    got = tconfig.load_config(CONFIG_DIR / name)
    want = jconfig.load_config(CONFIG_DIR / name)
    assert as_tree(got) == as_tree(want)
    assert tconfig.get_raw_cfg() == jconfig.get_raw_cfg()
    # the JAX package runs these configs at the knobs' defaults
    assert {k: getattr(want.encoder, k) for k in JAX_ONLY} == JAX_ONLY


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


@pytest.mark.parametrize("knob", sorted(JAX_ONLY))
def test_jax_only_knob_at_default_accepted(knob):
    value = JAX_ONLY[knob]
    text = "true" if value is True else value
    ov = [f"encoder.{knob}={text}"]
    got = tconfig.load_config(CONFIG_DIR / "smoke.yaml", ov)
    assert as_tree(got) == as_tree(jconfig.load_config(CONFIG_DIR / "smoke.yaml", ov))


@pytest.mark.parametrize("override", [
    "encoder.remat=false", "encoder.remat_mode=full", "encoder.unet_dtype=bfloat16",
    "encoder.costvolume_dtype=bfloat16",
])
def test_jax_only_knob_other_value_raises(override):
    jconfig.load_config(CONFIG_DIR / "smoke.yaml", [override])  # the JAX package takes it
    with pytest.raises(ValueError, match="JAX default"):
        tconfig.load_config(CONFIG_DIR / "smoke.yaml", [override])


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
