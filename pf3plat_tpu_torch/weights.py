"""JAX parameter trees (numpy) -> the port's modules.

`load_jax_params(model, trainable, frozen)` fills a `PF3plat` from the JAX
package's `PF3platParams` trees given as nested dicts of numpy arrays:
`trainable` = the encoder's `{"params": ...}`, `frozen` =
`{"unidepth": {"params": ...}, "superpoint": {...}, "lightglue": {...},
"lpips": {...}}`.

Conventions: Dense kernel (in, out) -> Linear weight (out, in); Conv kernel
(kh, kw, in, out) -> (out, in, kh, kw); LayerNorm/GroupNorm `scale` ->
`weight`. The encoder's modules carry the Flax names, so its map is the
identity up to the LightGlue-style block names, and LPIPS carries the Flax
names as they are. The other backbones carry the
released torch state-dict names; their maps are the inverse of the JAX
package's `weight_convert.convert_superpoint` / `convert_lightglue` /
`convert_unidepth`, written out here as rename rules.

Every port parameter must find its JAX leaf with the same shape, and every
JAX leaf must be used; anything else raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_SELF = r"(depth_self_attn_\d+|pose_transformers_\d+|pose_self_attn_\d+|pose_trunk_\d+)"
_SELF_NAMES = (("Wqkv", "Dense_0"), ("out_proj", "Dense_1"), ("ffn.0", "Dense_2"),
               ("ffn.1", "LayerNorm_0"), ("ffn.3", "Dense_3"))
_CROSS_NAMES = (("ffn.0", "Dense_0"), ("ffn.1", "LayerNorm_0"), ("ffn.3", "Dense_1"))

ENCODER_RULES = (
    [(rf"^{_SELF}\.{re.escape(t)}\.", rf"\1.{f}.") for t, f in _SELF_NAMES]
    + [(rf"^(pose_cross_attn_\d+)\.{re.escape(t)}\.", rf"\1.{f}.") for t, f in _CROSS_NAMES]
    + [(r"^posenc\.Wr\.", "posenc.Dense_0.")]
)

LIGHTGLUE_RULES = (
    [(rf"^transformers\.(\d+)\.self_attn\.{re.escape(t)}\.", rf"self_\1.{f}.")
     for t, f in _SELF_NAMES]
    + [(rf"^transformers\.(\d+)\.cross_attn\.{re.escape(t)}\.", rf"cross_\1.{f}.")
       for t, f in _CROSS_NAMES]
    + [(r"^transformers\.(\d+)\.cross_attn\.", r"cross_\1."),
       (r"^posenc\.Wr\.", "posenc.Dense_0."),
       # released checkpoints carry one assignment head per layer; the
       # JAX tree keeps only the last (the one that runs)
       (r"^log_assignment\.\d+\.(final_proj|matchability)\.", r"\1.")]
)

UNIDEPTH_RULES = [
    (r"^pixel_encoder\.patch_embed\.proj\.", "backbone.patch_embed."),
    (r"^pixel_encoder\.blocks\.(\d+)\.attn\.(qkv|proj)\.", r"backbone.block_\1.attn_\2."),
    (r"^pixel_encoder\.blocks\.(\d+)\.mlp\.(fc1|fc2)\.", r"backbone.block_\1.mlp_\2."),
    (r"^pixel_encoder\.blocks\.(\d+)\.(ls[12])\.gamma$", r"backbone.block_\1.\2_gamma"),
    (r"^pixel_encoder\.blocks\.(\d+)\.", r"backbone.block_\1."),
    (r"^pixel_encoder\.", "backbone."),
    (r"^pixel_decoder\.", "decoder."),
    (r"\.(ls[12])\.gamma$", r".\1"),
    (r"\.input_adapters\.(\d+)\.0\.", r".ln_\1."),
    (r"\.input_adapters\.(\d+)\.1\.", r".fc_\1."),
    (r"\.level_embed_layer\.0\.", ".level_fc1."),
    (r"\.level_embed_layer\.2\.", ".level_fc2."),
    (r"\.level_embed_layer\.3\.", ".level_norm."),
    (r"\.process_layers\.(\d+)\.(\d+)\.", r".process_\1_\2."),
    (r"\.rays_layers\.(\d+)\.", r".rays_\1."),
    (r"\.ups\.(\d+)\.convs\.(\d+)\.", r".up_\1.conv_\2."),
    (r"\.ups\.(\d+)\.up\.1\.", r".up_\1.shuf_dw."),
    (r"\.ups\.(\d+)\.up\.3\.", r".up_\1.shuf_pw."),
    (r"\.ups\.(\d+)\.residual\.0\.", r".up_\1.res_conv."),
    (r"\.depth_mlp\.(\d+)\.", r".depth_mlp_\1."),
    (r"\.confidence_mlp\.(\d+)\.", r".conf_mlp_\1."),
]


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a.b.c": array}; Flax's remat class prefix
    ("CheckpointUNetModel") is dropped so names match the port's."""
    out = {}
    for k, v in tree.items():
        name = str(k).replace("CheckpointUNetModel", "UNetModel")
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def jax_leaf(flat: dict[str, np.ndarray], name: str, rules, what: str
             ) -> tuple[str, np.ndarray]:
    """The Flax key of port parameter `name` and its value in the port's
    layout."""
    path = name
    for pat, rep in rules:
        path = re.sub(pat, rep, path)
    base, _, leaf = path.rpartition(".")
    cands = {"weight": ("kernel", "scale"), "bias": ("bias",)}.get(leaf, (leaf,))
    for cand in cands:
        key = f"{base}.{cand}" if base else cand
        if key in flat:
            break
    else:
        raise KeyError(f"{what}: no JAX parameter for {name} (looked for {base}.{cands})")
    arr = flat[key]
    if cand == "kernel":
        if arr.ndim not in (2, 4):
            raise ValueError(f"{what}: {key} has shape {arr.shape}, not a dense or conv kernel")
        arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    return key, arr


def load_flat(module: nn.Module, flat: dict[str, np.ndarray], rules, what: str) -> None:
    """Load `flat` (Flax names) into `module` through rename `rules`."""
    state = module.state_dict()
    used = set()
    new = {}
    for name, cur in state.items():
        key, arr = jax_leaf(flat, name, rules, what)
        used.add(key)
        value = torch.tensor(np.array(arr), dtype=cur.dtype)
        if tuple(value.shape) != tuple(cur.shape):
            raise ValueError(f"{what}: {name} wants {tuple(cur.shape)}, "
                             f"JAX {key} gives {tuple(value.shape)}")
        new[name] = value
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"{what}: JAX parameters left unused: {unused[:8]}")
    module.load_state_dict(new)


def load_jax_params(model, trainable: dict, frozen: dict) -> None:
    """Fill a `models.pf3plat.PF3plat` from the JAX parameter trees."""
    load_flat(model.encoder, flatten(trainable["params"]), ENCODER_RULES, "encoder")
    load_flat(model.unidepth, flatten(frozen["unidepth"]["params"]), UNIDEPTH_RULES, "unidepth")
    load_flat(model.superpoint, flatten(frozen["superpoint"]["params"]), [], "superpoint")
    load_flat(model.lightglue, flatten(frozen["lightglue"]["params"]), LIGHTGLUE_RULES,
              "lightglue")
    load_flat(model.lpips, flatten(frozen["lpips"]["params"]), [], "lpips")
