"""VGGT (Wang et al., "VGGT: Visual Geometry Grounded Transformer", CVPR
2025, arXiv 2503.11651; weights `facebook/VGGT-1B`): S unposed frames to
per-frame cameras, depth maps and point maps in one forward pass. Served
only (no train step).

  * input: frames (b, S, h, w, 3) in [0, 1], normalised by the ResNet mean
    and std; h and w multiples of 14;
  * patch embedding: DINOv2 ViT-L/14 with 4 registers
    (`backbones.dinov2.DINOv2`, its position table resized bicubically with
    antialiasing), run on the b S frames; its final norm's patch tokens;
  * aggregator: a frame's tokens are [camera (1), registers (4), patches];
    `camera_token` (1, 2, 1, C) and `register_token` (1, 2, 4, C) give index
    0 to frame 0 and index 1 to the rest. `depth` iterations of one frame
    block over (b S, P, C) and one global block over (b, S P, C). A block:
    x += ls1 proj(attn(LN1 x)); x += ls2 fc2(GELU_erf(fc1(LN2 x))), qkv with
    bias, LayerNorm eps 1e-5, LayerScale at `init_values`. Its attention
    puts q and k through a LayerNorm over the head dimension, then RoPE-2D
    at base `rope_freq` (`layers.rope_2d_tables`, `apply_rope_2d`) at each
    token's (row + 1, column + 1), the 5 special tokens at (0, 0), the same
    grid in every frame; softmax(q k^T / sqrt(d)) v through
    `layers.attention`. Pair i's output is concat(frame, global), (b, S, P,
    2C); only the pairs the heads read are kept (`hooks`, and the last);
  * camera head (float32): t = token_norm(the last pair's camera tokens);
    4 passes of u = embed_pose(empty_pose_tokens, or the previous encoding
    detached), (shift, scale, gate) = Linear(SiLU(u)), y = t + gate
    (LN(t) (1 + scale) + shift) (LN without affine, eps 1e-6), 4 blocks at
    width 2C (no q/k norm, no RoPE, LayerScale at `camera_init_values`),
    delta = pose_branch(trunk_norm(y)),
    the encoding summed over the passes; translation and quaternion
    linear, the field of view through ReLU (`absT_quaR_FoV`, 9 values);
  * DPT heads (float32, frames in chunks of `frames_chunk_size`): each
    hooked pair's patch tokens through LayerNorm(2C), a 1x1 projection to
    `dpt_out_channels`, plus 0.1 x the sin-cos embedding (omega_0 100) of
    the aspect-normalised uv grid, resized by ConvTranspose 4x, 2x,
    identity and a stride-2 3x3 convolution; 3x3 convolutions to
    `dpt_features`; RefineNet fusion from coarse to fine, each level
    resized to the next level's size (the finest by 2x); `output_conv1`,
    bilinear to the image, the uv embedding again, 3x3 to 32, ReLU, 1x1.
    Depth: exp(x) and 1 + exp(conf); points: sign(x) expm1(|x|) and 1 +
    exp(conf).

Precision: the patch embedding and the aggregator run under bf16 autocast
on the card, as the released inference runs on Hopper; the heads run with
autocast off at the port's float32 policy (TF32). The CPU runs float32.
The patch embedding (the port's DINOv2, shared with UniDepth) adds the
position table to the patch convolution's bf16 output in bf16, where the
released one promotes the sum to float32 before the first block.

Departures from the released code, kept the same in the plain reference
(`tests/vggt_reference.py`):

  * the camera head's attention runs through `layers.attention`, whose
    operands are bf16 on the card (the released head's SDPA is float32);
  * only the hooked pairs' outputs are kept (the released aggregator
    returns all of them; no head reads the others);
  * the track head is not built (it runs only on query points, and no
    request gives any), nor DINOv2's training-only `mask_token`.

Parameter names are the released state dict's (`aggregator.*`,
`camera_head.*`, `depth_head.*`, `point_head.*`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..utils.profiling import count, span, stage
from .backbones.dinov2 import DINOv2, ViTCfg
from .backbones.unidepth_layers import LayerScale
from .layers import apply_rope_2d, attention, rope_2d_tables
from .noposplat import FusionBlock, Mlp

VGGT_SPAN = "pf3.vggt."  # the span prefix of VGGT's stages
RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
POSE_DIM = 9  # translation 3, quaternion 4, field of view 2
DPT_LAST = 32  # the released DPT's second output convolution's width


@dataclasses.dataclass(frozen=True)
class VGGTCfg:
    """VGGT-1B's widths (the released `VGGT()` defaults)."""
    img_size: int = 518  # the patch embedding's position table: 518 / 14 = 37 a side
    patch_size: int = 14
    embed_dim: int = 1024
    patch_embed_depth: int = 24  # DINOv2 ViT-L's blocks
    depth: int = 24  # frame / global block pairs
    num_heads: int = 16
    mlp_ratio: int = 4
    num_register_tokens: int = 4
    rope_freq: float = 100.0
    init_values: float = 0.01  # the aggregator's blocks' LayerScale
    hooks: tuple[int, ...] = (4, 11, 17, 23)  # the pairs the DPT heads read
    camera_depth: int = 4
    camera_num_heads: int = 16
    camera_iterations: int = 4
    camera_init_values: float = 0.01  # the camera trunk's blocks' LayerScale
    dpt_features: int = 256
    dpt_out_channels: tuple[int, ...] = (256, 512, 1024, 1024)
    frames_chunk_size: int = 8


class VGGTOutput(NamedTuple):
    pose_enc_list: tuple  # each pass's activated encoding (b, S, 9); the last is the answer
    depth: torch.Tensor  # (b, S, h, w, 1)
    depth_conf: torch.Tensor  # (b, S, h, w)
    world_points: torch.Tensor  # (b, S, h, w, 3)
    world_points_conf: torch.Tensor  # (b, S, h, w)
    tokens: tuple  # the hooked pairs' outputs (b, S, P, 2C), in `hooks` order


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qk_norm: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = nn.LayerNorm(dim // num_heads) if qk_norm else None
        self.k_norm = nn.LayerNorm(dim // num_heads) if qk_norm else None
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, rope=None):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q, k = apply_rope_2d(q, rope), apply_rope_2d(k, rope)
        return self.proj(attention(q, k, v).transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    """VGGT's pre-LN block (LayerNorm eps 1e-5, LayerScale at `init_values`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, init_values: float,
                 qk_norm: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qk_norm)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.ls2 = LayerScale(dim)
        for ls in (self.ls1, self.ls2):
            nn.init.constant_(ls.gamma, init_values)

    def forward(self, x, rope=None):
        x = x + self.ls1(self.attn(self.norm1(x), rope))
        return x + self.ls2(self.mlp(self.norm2(x)))


def special_tokens(token: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(1, 2, k, C) -> (b S, k, C): index 0 for each sequence's first frame,
    index 1 for the rest."""
    first = token[:, :1].expand(b, 1, *token.shape[2:])
    rest = token[:, 1:].expand(b, s - 1, *token.shape[2:])
    return torch.cat([first, rest], dim=1).flatten(0, 1)


def token_positions(rows: int, cols: int, special: int, device) -> torch.Tensor:
    """(special + rows cols, 2) RoPE positions (y, x) of one frame's tokens:
    (0, 0) for the special tokens, then each patch's (row + 1, column + 1),
    row-major."""
    y, x = torch.meshgrid(torch.arange(rows, device=device), torch.arange(cols, device=device),
                          indexing="ij")
    pos = torch.stack([y.flatten(), x.flatten()], dim=-1) + 1
    return torch.cat([pos.new_zeros(special, 2), pos])


class Aggregator(nn.Module):
    """Frames (b, S, h, w, 3) normalised -> {pair: (b, S, P, 2C)} of the
    pairs in `keep`. `timer` is called with "patch" and "aggregator" as
    each ends."""

    def __init__(self, cfg: VGGTCfg):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.patch_embed = DINOv2(ViTCfg(
            patch_size=cfg.patch_size, embed_dim=c, depth=cfg.patch_embed_depth,
            num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
            pos_embed_size=cfg.img_size // cfg.patch_size,
            num_register_tokens=cfg.num_register_tokens, interpolate_antialias=True),
            out_layers=(cfg.patch_embed_depth - 1,))
        self.frame_blocks, self.global_blocks = (nn.ModuleList(
            Block(c, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, qk_norm=True)
            for _ in range(cfg.depth)) for _ in range(2))
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, c))
        self.register_token = nn.Parameter(torch.zeros(1, 2, cfg.num_register_tokens, c))

    def forward(self, frames: torch.Tensor, keep: set, timer=None) -> dict:
        cfg = self.cfg
        b, s, h, w, _ = frames.shape
        rows, cols = h // cfg.patch_size, w // cfg.patch_size
        with stage("patch", timer, prefix=VGGT_SPAN):
            patches = self.patch_embed(frames.flatten(0, 1))[0][0]
            tokens = torch.cat([special_tokens(self.camera_token, b, s),
                                special_tokens(self.register_token, b, s),
                                patches.flatten(1, 2)], dim=1)
        _, p, c = tokens.shape
        pos = token_positions(rows, cols, 1 + cfg.num_register_tokens, frames.device)
        head_dim = c // cfg.num_heads
        frame_rope = rope_2d_tables(pos, head_dim, cfg.rope_freq)
        global_rope = rope_2d_tables(pos.repeat(s, 1), head_dim, cfg.rope_freq)
        out = {}
        with stage("aggregator", timer, prefix=VGGT_SPAN):
            for i, (fb, gb) in enumerate(zip(self.frame_blocks, self.global_blocks)):
                tokens = fb(tokens.reshape(b * s, p, c), frame_rope)
                framed = tokens.reshape(b, s, p, c)
                count("vggt.global_tokens", s * p)
                tokens = gb(tokens.reshape(b, s * p, c), global_rope)
                if i in keep:
                    out[i] = torch.cat([framed, tokens.reshape(b, s, p, c)], dim=-1)
        return out


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTCfg):
        super().__init__()
        self.iterations = cfg.camera_iterations
        d = 2 * cfg.embed_dim
        self.trunk = nn.Sequential(*(
            Block(d, cfg.camera_num_heads, cfg.mlp_ratio, cfg.camera_init_values, qk_norm=False)
            for _ in range(cfg.camera_depth)))
        self.token_norm = nn.LayerNorm(d)
        self.trunk_norm = nn.LayerNorm(d)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, POSE_DIM))
        self.embed_pose = nn.Linear(POSE_DIM, d)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 3 * d))
        self.adaln_norm = nn.LayerNorm(d, elementwise_affine=False, eps=1e-6)
        self.pose_branch = Mlp(d, d // 2, POSE_DIM)

    def forward(self, camera_tokens: torch.Tensor) -> list[torch.Tensor]:
        """The last pair's camera tokens (b, S, 2C) -> each pass's activated
        encoding (b, S, 9)."""
        t = self.token_norm(camera_tokens)
        b, s, _ = t.shape
        enc, passes = None, []
        for _ in range(self.iterations):
            count("vggt.camera_passes", 1)
            u = self.embed_pose(self.empty_pose_tokens.expand(b, s, -1) if enc is None
                                else enc.detach())
            shift, scale, gate = self.poseLN_modulation(u).chunk(3, dim=-1)
            y = t + gate * (self.adaln_norm(t) * (1 + scale) + shift)
            delta = self.pose_branch(self.trunk_norm(self.trunk(y)))
            enc = delta if enc is None else enc + delta
            passes.append(torch.cat([enc[..., :7], F.relu(enc[..., 7:])], dim=-1))
        return passes


def uv_embedding(channels: int, rows: int, cols: int, aspect: float, device) -> torch.Tensor:
    """(channels, rows, cols): the sin-cos embedding (omega_0 100) of the uv
    grid spanning +-aspect / diag by +-1 / diag, computed in float64."""
    diag = (aspect**2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    x = torch.linspace(-sx * (cols - 1) / cols, sx * (cols - 1) / cols, cols, device=device)
    y = torch.linspace(-sy * (rows - 1) / rows, sy * (rows - 1) / rows, rows, device=device)
    u, v = torch.meshgrid(x, y, indexing="xy")
    quarter = channels // 4
    omega = 1.0 / 100.0 ** (torch.arange(quarter, dtype=torch.float64, device=device)
                            / (channels / 4))

    def sincos(p):
        out = p.reshape(-1).double()[:, None] * omega
        return torch.cat([out.sin(), out.cos()], dim=-1)

    emb = torch.cat([sincos(u), sincos(v)], dim=-1).float()
    return emb.reshape(rows, cols, channels).permute(2, 0, 1)


class _Scratch(nn.Module):
    def __init__(self, cfg: VGGTCfg, output_dim: int):
        super().__init__()
        f = cfg.dpt_features
        for i, oc in enumerate(cfg.dpt_out_channels, 1):
            setattr(self, f"layer{i}_rn", nn.Conv2d(oc, f, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FusionBlock(f, skip=i < 4, relu_skip=True))
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, DPT_LAST, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(DPT_LAST, output_dim, 1))


class DPTHead(nn.Module):
    """VGGT's DPT head over the hooked pairs' tokens -> (prediction (b, S,
    h, w, output_dim - 1), confidence (b, S, h, w))."""

    def __init__(self, cfg: VGGTCfg, output_dim: int, activation: str):
        super().__init__()
        self.cfg, self.activation = cfg, activation
        d, oc = 2 * cfg.embed_dim, cfg.dpt_out_channels
        self.norm = nn.LayerNorm(d)
        self.projects = nn.ModuleList(nn.Conv2d(d, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(cfg, output_dim)

    def forward(self, tokens, start: int, image_shape: tuple[int, int]):
        """tokens: the hooked pairs' (b, S, P, 2C); the patches from `start`."""
        cfg = self.cfg
        b, s = tokens[0].shape[:2]
        h, w = image_shape
        rows, cols = h // cfg.patch_size, w // cfg.patch_size
        preds, confs = [], []
        for lo in range(0, s, cfg.frames_chunk_size):
            hi = min(lo + cfg.frames_chunk_size, s)
            pred, conf = self._chunk([t[:, lo:hi, start:].flatten(0, 1) for t in tokens],
                                     rows, cols, (h, w))
            preds.append(pred.unflatten(0, (b, hi - lo)))
            confs.append(conf.unflatten(0, (b, hi - lo)))
        return torch.cat(preds, dim=1), torch.cat(confs, dim=1)

    def _chunk(self, tokens, rows: int, cols: int, image_shape: tuple[int, int]):
        h, w = image_shape
        aspect = w / h
        levels = []
        for x, project, resize in zip(tokens, self.projects, self.resize_layers):
            x = project(self.norm(x).transpose(1, 2).unflatten(-1, (rows, cols)))
            x = x + 0.1 * uv_embedding(x.shape[1], rows, cols, aspect, x.device)
            levels.append(resize(x))
        sc = self.scratch
        l1, l2, l3, l4 = (getattr(sc, f"layer{i}_rn")(x) for i, x in enumerate(levels, 1))
        out = sc.refinenet4(l4, size=l3.shape[2:])
        out = sc.refinenet3(out, l3, size=l2.shape[2:])
        out = sc.refinenet2(out, l2, size=l1.shape[2:])
        out = sc.output_conv1(sc.refinenet1(out, l1))
        out = F.interpolate(out, size=(h, w), mode="bilinear", align_corners=True)
        out = out + 0.1 * uv_embedding(out.shape[1], h, w, aspect, out.device)
        out = sc.output_conv2(out).permute(0, 2, 3, 1)
        x, conf = out[..., :-1], out[..., -1]
        x = torch.exp(x) if self.activation == "exp" else torch.sign(x) * torch.expm1(x.abs())
        return x, 1 + conf.exp()


class VGGT(nn.Module):
    """`forward(images)`: frames (b, S, h, w, 3) in [0, 1] -> `VGGTOutput`.
    On `device` (default `cuda`; without a GPU it raises unless "cpu")."""

    def __init__(self, cfg: VGGTCfg = VGGTCfg(), device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = DPTHead(cfg, 2, "exp")
        self.point_head = DPTHead(cfg, 4, "inv_log")
        self.register_buffer("_mean", torch.tensor(RESNET_MEAN), persistent=False)
        self.register_buffer("_std", torch.tensor(RESNET_STD), persistent=False)
        self.to(self.device)
        self.eval()

    def _trunk_precision(self):
        if self.device.type == "cuda":
            return torch.autocast("cuda", dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def forward(self, images: torch.Tensor, timer=None) -> VGGTOutput:
        """`timer`, if given, is called with "patch", "aggregator", "camera"
        and "dpt" as each stage ends."""
        cfg = self.cfg
        with span("pf3.forward"):
            count("forwards", 1)
            images = images.to(self.device, torch.float32)
            b, s, h, w, _ = images.shape
            count("vggt.frames", b * s)
            with self._trunk_precision():
                pairs = self.aggregator((images - self._mean) / self._std,
                                        {*cfg.hooks, cfg.depth - 1}, timer)
            tokens = tuple(pairs[i] for i in cfg.hooks)
            start = 1 + cfg.num_register_tokens  # the first patch token
            with torch.autocast(self.device.type, enabled=False):
                with stage("camera", timer, prefix=VGGT_SPAN):
                    passes = self.camera_head(pairs[cfg.depth - 1][:, :, 0])
                with stage("dpt", timer, prefix=VGGT_SPAN):
                    depth, depth_conf = self.depth_head(tokens, start, (h, w))
                    points, points_conf = self.point_head(tokens, start, (h, w))
            return VGGTOutput(tuple(passes), depth, depth_conf, points, points_conf, tokens)
