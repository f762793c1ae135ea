"""Torch checkpoint -> Flax-layout parameter trees for the frozen backbones.

Port of `pf3plat_tpu/models/backbones/weight_convert.py` (the port's own
numpy copy): offline tool (CPU torch only to read the checkpoints) that
maps the reference's pretrained state_dicts into the JAX package's
parameter trees and writes them as the same `.pkl` artifacts, which
`pf3plat_tpu_torch.training.pretrained.load_pretrained_frozen` loads into
the port's modules. Usage:

    python -m pf3plat_tpu_torch.models.backbones.weight_convert \
        --superpoint superpoint_v1.pth --lightglue superpoint_lightglue.pth \
        --dinov2 dinov2_vitl14.pth --vgg lpips_vgg.pth --out weights/

Conversion rules:
  * torch Conv2d weight (O, I, kh, kw) -> flax Conv kernel (kh, kw, I, O)
  * torch Linear weight (O, I)         -> flax Dense kernel (I, O)
  * LayerNorm weight/bias              -> scale/bias

The checkpoints themselves ship with the reference's external deps
(torch hub; `superpoint.py:144-145`, `lightglue.py:409-415`,
`UniDepthV2.from_pretrained`, lpips); the tool is exercised by round-trip
tests on randomly initialized state dicts with the same layouts.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np


def conv_w(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def linear_w(w: np.ndarray) -> np.ndarray:
    """(O, I) -> (I, O)."""
    return np.transpose(w, (1, 0))


def convert_superpoint(sd: dict) -> dict:
    """SuperPoint state_dict -> flax params for `superpoint.SuperPoint`."""
    params = {}
    for name in [
        "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
        "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb",
    ]:
        params[name] = {
            "kernel": conv_w(np.asarray(sd[f"{name}.weight"])),
            "bias": np.asarray(sd[f"{name}.bias"]),
        }
    return {"params": params}


def _self_block(sd: dict, prefix: str) -> dict:
    return {
        "Dense_0": {  # Wqkv
            "kernel": linear_w(np.asarray(sd[f"{prefix}.Wqkv.weight"])),
            "bias": np.asarray(sd[f"{prefix}.Wqkv.bias"]),
        },
        "Dense_1": {  # out_proj
            "kernel": linear_w(np.asarray(sd[f"{prefix}.out_proj.weight"])),
            "bias": np.asarray(sd[f"{prefix}.out_proj.bias"]),
        },
        "Dense_2": {
            "kernel": linear_w(np.asarray(sd[f"{prefix}.ffn.0.weight"])),
            "bias": np.asarray(sd[f"{prefix}.ffn.0.bias"]),
        },
        "LayerNorm_0": {
            "scale": np.asarray(sd[f"{prefix}.ffn.1.weight"]),
            "bias": np.asarray(sd[f"{prefix}.ffn.1.bias"]),
        },
        "Dense_3": {
            "kernel": linear_w(np.asarray(sd[f"{prefix}.ffn.3.weight"])),
            "bias": np.asarray(sd[f"{prefix}.ffn.3.bias"]),
        },
    }


def _cross_block(sd: dict, prefix: str) -> dict:
    return {
        "to_qk": {
            "kernel": linear_w(np.asarray(sd[f"{prefix}.to_qk.weight"])),
            "bias": np.asarray(sd[f"{prefix}.to_qk.bias"]),
        },
        "to_v": {
            "kernel": linear_w(np.asarray(sd[f"{prefix}.to_v.weight"])),
            "bias": np.asarray(sd[f"{prefix}.to_v.bias"]),
        },
        "to_out": {
            "kernel": linear_w(np.asarray(sd[f"{prefix}.to_out.weight"])),
            "bias": np.asarray(sd[f"{prefix}.to_out.bias"]),
        },
        "Dense_0": {
            "kernel": linear_w(np.asarray(sd[f"{prefix}.ffn.0.weight"])),
            "bias": np.asarray(sd[f"{prefix}.ffn.0.bias"]),
        },
        "LayerNorm_0": {
            "scale": np.asarray(sd[f"{prefix}.ffn.1.weight"]),
            "bias": np.asarray(sd[f"{prefix}.ffn.1.bias"]),
        },
        "Dense_1": {
            "kernel": linear_w(np.asarray(sd[f"{prefix}.ffn.3.weight"])),
            "bias": np.asarray(sd[f"{prefix}.ffn.3.bias"]),
        },
    }


def convert_lightglue(sd: dict, n_layers: int | None = None) -> dict:
    if n_layers is None:
        # Infer from the release layout (9 for the published checkpoint).
        n_layers = 1 + max(
            int(k.split(".")[1]) for k in sd if k.startswith("transformers.")
        )
    params = {
        "input_proj": {
            "kernel": linear_w(np.asarray(sd["input_proj.weight"])),
            "bias": np.asarray(sd["input_proj.bias"]),
        },
        "posenc": {
            "Dense_0": {
                "kernel": linear_w(np.asarray(sd["posenc.Wr.weight"])),
            }
        },
        "final_proj": {
            "kernel": linear_w(
                np.asarray(sd[f"log_assignment.{n_layers - 1}.final_proj.weight"])
            ),
            "bias": np.asarray(
                sd[f"log_assignment.{n_layers - 1}.final_proj.bias"]
            ),
        },
        "matchability": {
            "kernel": linear_w(
                np.asarray(sd[f"log_assignment.{n_layers - 1}.matchability.weight"])
            ),
            "bias": np.asarray(
                sd[f"log_assignment.{n_layers - 1}.matchability.bias"]
            ),
        },
    }
    for i in range(n_layers):
        params[f"self_{i}"] = _self_block(
            sd, f"transformers.{i}.self_attn"
        )
        params[f"cross_{i}"] = _cross_block(
            sd, f"transformers.{i}.cross_attn"
        )
    return {"params": params}


def convert_dinov2(sd: dict, depth: int | None = None) -> dict:
    if depth is None:
        # Infer from the release layout (24 for ViT-L/14).
        depth = 1 + max(
            int(k.split(".")[1]) for k in sd if k.startswith("blocks.")
        )
    params = {
        "patch_embed": {
            "kernel": conv_w(np.asarray(sd["patch_embed.proj.weight"])),
            "bias": np.asarray(sd["patch_embed.proj.bias"]),
        },
        "cls_token": np.asarray(sd["cls_token"]),
        "pos_embed": np.asarray(sd["pos_embed"]),
    }
    for i in range(depth):
        p = f"blocks.{i}"
        params[f"block_{i}"] = {
            "norm1": {"scale": np.asarray(sd[f"{p}.norm1.weight"]),
                      "bias": np.asarray(sd[f"{p}.norm1.bias"])},
            "attn_qkv": {"kernel": linear_w(np.asarray(sd[f"{p}.attn.qkv.weight"])),
                         "bias": np.asarray(sd[f"{p}.attn.qkv.bias"])},
            "attn_proj": {"kernel": linear_w(np.asarray(sd[f"{p}.attn.proj.weight"])),
                          "bias": np.asarray(sd[f"{p}.attn.proj.bias"])},
            "ls1_gamma": np.asarray(sd[f"{p}.ls1.gamma"]),
            "norm2": {"scale": np.asarray(sd[f"{p}.norm2.weight"]),
                      "bias": np.asarray(sd[f"{p}.norm2.bias"])},
            "mlp_fc1": {"kernel": linear_w(np.asarray(sd[f"{p}.mlp.fc1.weight"])),
                        "bias": np.asarray(sd[f"{p}.mlp.fc1.bias"])},
            "mlp_fc2": {"kernel": linear_w(np.asarray(sd[f"{p}.mlp.fc2.weight"])),
                        "bias": np.asarray(sd[f"{p}.mlp.fc2.bias"])},
            "ls2_gamma": np.asarray(sd[f"{p}.ls2.gamma"]),
        }
    # final LayerNorm, applied per tapped layer when use_norm=True
    # (vendored `dinov2.py:250,327-331`; UniDepth's configuration)
    if "norm.weight" in sd:
        params["norm"] = {"scale": np.asarray(sd["norm.weight"]),
                          "bias": np.asarray(sd["norm.bias"])}
    return {"params": params}


# --------------------------------------------------------------------------
# UniDepth-V2 (pixel_encoder = DINOv2 + pixel_decoder; reference
# `src/model/unidepth/unidepthv2/{unidepthv2,decoder}.py`, `unidepth/layers/`)
# --------------------------------------------------------------------------


def _ln(sd: dict, p: str) -> dict:
    return {"scale": np.asarray(sd.pop(f"{p}.weight")),
            "bias": np.asarray(sd.pop(f"{p}.bias"))}


def _dense(sd: dict, p: str) -> dict:
    out = {"kernel": linear_w(np.asarray(sd.pop(f"{p}.weight")))}
    if f"{p}.bias" in sd:
        out["bias"] = np.asarray(sd.pop(f"{p}.bias"))
    return out


def _conv(sd: dict, p: str) -> dict:
    out = {"kernel": conv_w(np.asarray(sd.pop(f"{p}.weight")))}
    if f"{p}.bias" in sd:
        out["bias"] = np.asarray(sd.pop(f"{p}.bias"))
    return out


def _ud_mlp(sd: dict, p: str) -> dict:
    """`layers/mlp.py:MLP` (norm -> proj1 -> GELU -> proj2) -> `MLPF`."""
    return {"norm": _ln(sd, f"{p}.norm"),
            "proj1": _dense(sd, f"{p}.proj1"),
            "proj2": _dense(sd, f"{p}.proj2")}


def _ud_attn(sd: dict, p: str) -> dict:
    """`layers/attention.py:AttentionBlock` (also NystromBlock — the
    xformers attention_fn is parameter-free) -> `AttentionBlockF`."""
    return {
        "norm_attnx": _ln(sd, f"{p}.norm_attnx"),
        "norm_attnctx": _ln(sd, f"{p}.norm_attnctx"),
        "kv": _dense(sd, f"{p}.kv"),
        "q": _dense(sd, f"{p}.q"),
        "out": _dense(sd, f"{p}.out"),
        "ls1": np.asarray(sd.pop(f"{p}.ls1.gamma")),
        "ls2": np.asarray(sd.pop(f"{p}.ls2.gamma")),
        "mlp": _ud_mlp(sd, f"{p}.mlp"),
    }


def _ud_list_adapter(sd: dict, p: str) -> dict:
    """`decoder.py:ListAdapter` (input_adapters.{i} = LN -> Linear -> GELU)."""
    out = {}
    i = 0
    while f"{p}.input_adapters.{i}.0.weight" in sd:
        out[f"ln_{i}"] = _ln(sd, f"{p}.input_adapters.{i}.0")
        out[f"fc_{i}"] = _dense(sd, f"{p}.input_adapters.{i}.1")
        i += 1
    return out


def _ud_cvnxt(sd: dict, p: str) -> dict:
    """`layers/convnext.py:CvnxtBlock` -> `CvnxtBlockF`."""
    return {
        "dwconv": _conv(sd, f"{p}.dwconv"),
        "norm": _ln(sd, f"{p}.norm"),
        "pwconv1": _dense(sd, f"{p}.pwconv1"),
        "pwconv2": _dense(sd, f"{p}.pwconv2"),
        "gamma": np.asarray(sd.pop(f"{p}.gamma")),
    }


def _ud_upsample(sd: dict, p: str) -> dict:
    """`layers/upsample.py:ConvUpsampleShuffleResidual` ->
    `ConvUpsampleShuffleResidualF` (up.0 is a parameter-free PixelShuffle)."""
    out = {}
    j = 0
    while f"{p}.convs.{j}.dwconv.weight" in sd:
        out[f"conv_{j}"] = _ud_cvnxt(sd, f"{p}.convs.{j}")
        j += 1
    out["shuf_dw"] = _conv(sd, f"{p}.up.1")
    out["shuf_pw"] = _conv(sd, f"{p}.up.3")
    out["res_conv"] = _conv(sd, f"{p}.residual.0")
    return out


def convert_unidepth(sd: dict) -> tuple[dict, dict]:
    """Full UniDepthV2 state_dict (`pixel_encoder.*` + `pixel_decoder.*`)
    -> ({"params": {"backbone", "decoder"}}, inferred-config info).

    Maps 100% of the decoder parameters (asserts nothing is left over) and
    infers hidden_dim / camera_dim / expansion / stage depths / #resolutions
    from the checkpoint so config-side defaults never have to be trusted.
    """
    enc = {k[len("pixel_encoder."):]: v for k, v in sd.items()
           if k.startswith("pixel_encoder.")}
    dec = {k[len("pixel_decoder."):]: np.asarray(v) for k, v in sd.items()
           if k.startswith("pixel_decoder.")}

    depth_vit = 0
    while f"blocks.{depth_vit}.norm1.weight" in enc:
        depth_vit += 1
    backbone = convert_dinov2(enc, depth=depth_vit)["params"]

    r, hidden_dim = np.asarray(dec["level_embeds"]).shape
    camera_dim = np.asarray(
        dec["depth_layer.rays_layers.0.weight"]
    ).shape[1] - 3
    expansion = (
        np.asarray(dec["camera_layer.aggregate1.mlp.proj1.weight"]).shape[0]
        // hidden_dim
    )
    depths = []
    i = 0
    while f"depth_layer.rays_layers.{i}.weight" in dec:
        j = 0
        while f"depth_layer.process_layers.{i}.{j}.q.weight" in dec:
            j += 1
        depths.append(j)
        i += 1

    d = {}  # decoder flax params
    d["input_adapter"] = _ud_list_adapter(dec, "input_adapter")
    d["camera_token_adapter"] = _ud_list_adapter(dec, "camera_token_adapter")
    d["global_token_adapter"] = _ud_list_adapter(dec, "global_token_adapter")
    d["level_embeds"] = np.asarray(dec.pop("level_embeds"))
    d["level_fc1"] = _dense(dec, "level_embed_layer.0")
    d["level_fc2"] = _dense(dec, "level_embed_layer.2")
    d["level_norm"] = _ln(dec, "level_embed_layer.3")

    cam = {
        "latents_pos": np.asarray(dec.pop("camera_layer.latents_pos"))
    }
    cam["project_cls"] = _ud_mlp(dec, "camera_layer.project_cls")
    cam["in_features"] = _ud_mlp(dec, "camera_layer.in_features")
    cam["aggregate1"] = _ud_attn(dec, "camera_layer.aggregate1")
    cam["aggregate2"] = _ud_attn(dec, "camera_layer.aggregate2")
    cam["out"] = _ud_mlp(dec, "camera_layer.out")
    d["camera_layer"] = cam

    glob = {
        "project_cls": _ud_mlp(dec, "global_layer.project_cls"),
        "project_rays": _dense(dec, "global_layer.project_rays"),
        "in_features": _dense(dec, "global_layer.in_features"),
        "aggregate1": _ud_attn(dec, "global_layer.aggregate1"),
        "aggregate2": _ud_attn(dec, "global_layer.aggregate2"),
        "out": _ud_mlp(dec, "global_layer.out"),
    }
    d["global_layer"] = glob

    dh = {
        "features_channel_cat": _dense(dec, "depth_layer.features_channel_cat"),
        "to_latents": _ud_mlp(dec, "depth_layer.to_latents"),
        "aggregate_16": _ud_attn(dec, "depth_layer.aggregate_16"),
        "prompt_camera": _ud_attn(dec, "depth_layer.prompt_camera"),
        "to_depth": _conv(dec, "depth_layer.to_depth"),
        "to_confidence": _conv(dec, "depth_layer.to_confidence"),
    }
    for i, n_blocks in enumerate(depths):
        dh[f"rays_{i}"] = _dense(dec, f"depth_layer.rays_layers.{i}")
        dh[f"up_{i}"] = _ud_upsample(dec, f"depth_layer.ups.{i}")
        dh[f"depth_mlp_{i}"] = _ud_mlp(dec, f"depth_layer.depth_mlp.{i}")
        dh[f"conf_mlp_{i}"] = _ud_mlp(dec, f"depth_layer.confidence_mlp.{i}")
        for j in range(n_blocks):
            dh[f"process_{i}_{j}"] = _ud_attn(
                dec, f"depth_layer.process_layers.{i}.{j}"
            )
    d["depth_layer"] = dh

    leftover = [k for k in dec if not k.endswith("num_batches_tracked")]
    assert not leftover, f"unconverted decoder keys: {leftover[:10]}"

    info = {
        "hidden_dim": int(hidden_dim),
        "camera_dim": int(camera_dim),
        "expansion": int(expansion),
        "depths": tuple(depths),
        "num_resolutions": int(r),
        "vit_depth": int(depth_vit),
    }
    return {"params": {"backbone": backbone, "decoder": d}}, info


_VGG_TORCH_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_VGG_NAMES = [
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
    "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2",
    "conv5_3",
]


def convert_lpips_vgg(sd: dict) -> dict:
    """lpips package checkpoint (net.slice*/lin*) -> flax LPIPS params."""
    vgg = {}
    for idx, name in zip(_VGG_TORCH_IDX, _VGG_NAMES):
        # The lpips package stores the torchvision VGG features as
        # net.sliceK.<idx>; accept either flat `features.<idx>` or sliced keys.
        for key in (f"features.{idx}", f"net.features.{idx}"):
            if f"{key}.weight" in sd:
                vgg[name] = {
                    "kernel": conv_w(np.asarray(sd[f"{key}.weight"])),
                    "bias": np.asarray(sd[f"{key}.bias"]),
                }
                break
    lins = {
        f"lin{i}": {
            "kernel": conv_w(np.asarray(sd[f"lin{i}.model.1.weight"]))
        }
        for i in range(5)
        if f"lin{i}.model.1.weight" in sd
    }
    return {"params": {"vgg": vgg, **lins}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--superpoint", type=Path)
    ap.add_argument("--lightglue", type=Path)
    ap.add_argument("--dinov2", type=Path)
    ap.add_argument("--unidepth", type=Path,
                    help="full UniDepthV2 checkpoint (pixel_encoder+decoder)")
    ap.add_argument("--vgg", type=Path)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)

    import torch

    args.out.mkdir(parents=True, exist_ok=True)
    jobs = [
        ("superpoint", args.superpoint, convert_superpoint),
        ("lightglue", args.lightglue, convert_lightglue),
        ("dinov2", args.dinov2, convert_dinov2),
        ("unidepth", args.unidepth, lambda sd: convert_unidepth(sd)[0]),
        ("lpips_vgg", args.vgg, convert_lpips_vgg),
    ]
    for name, path, fn in jobs:
        if path is None:
            continue
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        params = fn({k: v.numpy() for k, v in sd.items()})
        with (args.out / f"{name}.pkl").open("wb") as f:
            pickle.dump(params, f)
        print(f"converted {name} -> {args.out / f'{name}.pkl'}")


if __name__ == "__main__":
    main()
