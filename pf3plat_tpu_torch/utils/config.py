"""Typed config tree + YAML overlays + CLI overrides.

Port of `pf3plat_tpu/utils/config.py`: the same dataclass tree over the
port's own config classes, read from the same `configs/*.yaml` with
`yaml.safe_load`.

Plays the role of the reference's Hydra + dacite stack (`src/config.py:38-90`,
`config/**/*.yaml`): a dataclass tree is the schema, YAML files provide
values, and `key.path=value` CLI overrides compose on top — the same
composition model without the Hydra dependency. A raw dict copy stays
accessible (`get_raw_cfg`, mirroring `src/global_cfg.py:8-16`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional, Sequence

from ..data.dataset import DatasetCfg
from ..data.view_samplers import BoundedSamplerCfg
from ..models.decoder import DecoderCfg
from ..models.encoder import EncoderCfg
from ..models.noposplat import NoPoSplatCfg
from ..models.vggt import VGGTCfg
from ..training.checkpoints import CheckpointCfg
from ..training.losses import LossCfg
from ..training.train import OptimizerCfg

_RAW: dict = {}


def set_raw_cfg(d: dict) -> None:
    global _RAW
    _RAW = d


def get_raw_cfg() -> dict:
    return _RAW


@dataclasses.dataclass
class DataLoaderCfg:
    batch_size: int = 4
    seed: int = 1234
    # Background JPEG-decode threads (0 = synchronous). The reference uses 16
    # DataLoader worker processes (config/main.yaml data_loader.train);
    # threads suffice here since libjpeg releases the GIL (data/prefetch.py).
    num_workers: int = 4
    prefetch: int = 16


@dataclasses.dataclass
class TrainCfg:
    print_log_every_n_steps: int = 1
    val_check_interval: int = 20
    # Run one validation pass before training starts (reference
    # config/main.yaml `num_sanity_val_steps: 2`; one pass suffices to
    # catch broken visualization/render paths up front).
    sanity_validation: bool = True
    # Rasterizer tile-axis size of the (data, tile) device mesh: >1 shards
    # each example's compositing rows across devices; 1 keeps the pure-DP
    # layout.
    tile_axis: int = 1


@dataclasses.dataclass
class TestCfg:
    output_path: Path = Path("outputs/test")
    compute_scores: bool = True
    eval_time_skip_steps: int = 5
    save_image: bool = True
    save_video: bool = False   # wobble/interpolation videos per test example
    video_frames: int = 30
    # Test-time view sampler: "evaluation" (JSON index / bounded fallback)
    # or "all" (every frame, for trajectory-video evaluation — reference
    # `view_sampler_all.py`). "all" caps at `all_sampler_max_views` frames.
    sampler: str = "evaluation"
    all_sampler_max_views: int = 12
    # Depth rendering mode for the saved depth panels (reference
    # `model_wrapper.py:269-278`); set null to skip the depth render.
    depth_mode: Optional[str] = "depth"


@dataclasses.dataclass
class ModelCfg:
    # The model the entry points build: "pf3plat" (`model`'s other keys,
    # `encoder`), "noposplat" (the `noposplat` section) or "vggt" (the
    # `vggt` section; served only).
    architecture: str = "pf3plat"
    tiny_backbones: bool = False   # tiny ViT for smoke tests / CI
    max_keypoints: int = 1024
    max_matches: int = 512
    lightglue_layers: int = 9
    # Frozen-perception matmul precision: "bfloat16" (bf16 autocast on the
    # card) or "highest" (full f32, for parity debugging).
    frozen_matmul_precision: str = "bfloat16"


@dataclasses.dataclass
class RootCfg:
    mode: str = "train"
    seed: int = 111123
    output_dir: Optional[Path] = None
    # Directory of converted pretrained frozen weights (`.pkl` trees of the
    # JAX package's weight converter); loaded into the frozen modules at
    # start-up (`training/pretrained.py`) — the reference's hub-checkpoint
    # loading (`superpoint.py:144-145`, `encoder_costvolume.py:81`).
    weights: Optional[Path] = None
    dataset: DatasetCfg = dataclasses.field(
        default_factory=lambda: DatasetCfg(roots=[Path("datasets/re10k")])
    )
    view_sampler: BoundedSamplerCfg = dataclasses.field(
        default_factory=BoundedSamplerCfg
    )
    evaluation_index: Optional[Path] = None
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    encoder: EncoderCfg = dataclasses.field(default_factory=EncoderCfg)
    noposplat: NoPoSplatCfg = dataclasses.field(default_factory=NoPoSplatCfg)
    vggt: VGGTCfg = dataclasses.field(default_factory=VGGTCfg)
    decoder: DecoderCfg = dataclasses.field(default_factory=DecoderCfg)
    loss: LossCfg = dataclasses.field(default_factory=LossCfg)
    optimizer: OptimizerCfg = dataclasses.field(default_factory=OptimizerCfg)
    checkpointing: CheckpointCfg = dataclasses.field(
        default_factory=CheckpointCfg
    )
    data_loader: DataLoaderCfg = dataclasses.field(default_factory=DataLoaderCfg)
    train: TrainCfg = dataclasses.field(default_factory=TrainCfg)
    test: TestCfg = dataclasses.field(default_factory=TestCfg)
    max_steps: int = 300_001


_PATH_FIELDS = {"roots", "output_dir", "directory", "output_path", "weights",
                "evaluation_index", "index_path"}


def _coerce(value: Any, field_type: Any, name: str) -> Any:
    if value is None:
        return None
    if name in _PATH_FIELDS:
        if isinstance(value, (list, tuple)):
            return [Path(v) for v in value]
        return Path(value)
    return value


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _build(cls, data: dict):
    """Recursively construct a dataclass tree from a plain dict, merging
    onto field defaults (unknown keys are errors, like dacite strict)."""
    import typing

    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key in data:
        if key not in fields:
            raise KeyError(f"unknown config key '{key}' for {cls.__name__}")
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    kwargs = {}
    for f in fields.values():
        t = _resolve(hints.get(f.name, f.type))
        default = _default_of(cls, f)
        if f.name in data:
            v = data[f.name]
            if dataclasses.is_dataclass(t) and isinstance(v, dict):
                base = dataclasses.asdict(default) if default is not None else {}
                kwargs[f.name] = _build(t, _deep_merge(base, v))
            else:
                v = _coerce(v, t, f.name)
                if isinstance(default, tuple) and isinstance(v, list):
                    v = tuple(v)
                kwargs[f.name] = v
        else:
            kwargs[f.name] = default
    return cls(**kwargs)


def _resolve(t):
    import typing

    origin = typing.get_origin(t)
    if origin is typing.Union:
        args = [a for a in typing.get_args(t) if a is not type(None)]
        return args[0] if args else t
    if isinstance(t, str):
        return object
    return t


def _default_of(cls, f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    return None


def _parse_value(s: str) -> Any:
    import json

    try:
        return json.loads(s)
    except (ValueError, TypeError):
        return s


def apply_overrides(data: dict, overrides: Sequence[str]) -> dict:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov}")
        key, value = ov.split("=", 1)
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return data


def load_config(
    yaml_path: Optional[Path] = None, overrides: Sequence[str] = ()
) -> RootCfg:
    data: dict = {}
    if yaml_path is not None:
        import yaml

        with Path(yaml_path).open() as f:
            data = yaml.safe_load(f) or {}
    data = apply_overrides(data, overrides)
    set_raw_cfg(data)
    return _build(RootCfg, data)
