"""NoPoSplat (Ye et al., "No Pose, No Problem: Surprisingly Simple 3D
Gaussian Splats from Sparse Unposed Images", ICLR 2025, arXiv 2410.24207):
two unposed context views to 3D Gaussians in the first view's camera frame,
on MASt3R's (DUSt3R's) layout, every parameter trained.

  * encoder: CroCo's ViT-L/16 (24 pre-LN blocks, width 1,024, 16 heads of
    64, MLP 4,096 with the erf GELU, qkv bias, LayerNorm eps 1e-6, a final
    `enc_norm`), weights shared by both views, run as one batch of 2b. The
    normalised intrinsics (fx, fy, cx, cy) enter through a linear map as one
    extra token (NoPoSplat's "token" embedding): 257 tokens a view at 256 x
    256;
  * RoPE-2D (CroCo's `RoPE2D`, base 100) on q and k of every attention:
    the first half of a head rotates by the token's row, the second by its
    column (`layers.rope_2d_tables`, `layers.apply_rope_2d`);
  * cross-view decoders: a shared `decoder_embed` (1,024 -> 768), then
    DUSt3R's `dec_blocks` and `dec_blocks2` (12 blocks each, width 768, 12
    heads) in lockstep: at layer i view 1's block takes (f1, f2) of layer
    i - 1 and view 2's (f2, f1); a block is self-attention, cross-attention
    to the other view (RoPE at each side's own positions) and an MLP, each
    pre-LN; a final `dec_norm`;
  * DPT heads (DUSt3R's DPT), one set per view branch: the encoder output
    and decoder layers 6, 9 and 12 reassembled to 96 / 192 / 384 / 768
    channels at 4x, 2x, 1x and 1/2x of the token grid, 3x3 convolutions to
    256, RefineNet fusion with residual units and 2x bilinear upsampling,
    then a head up to the image. `downstream_head1` / `2` give each pixel's
    Gaussian centre through DUSt3R's exp mapping; `gaussian_param_head` /
    `2` give opacity, scale, rotation and harmonics, with an RGB shortcut
    from the input image;
  * the Gaussian adapter (`gaussian_adapter.adapt_canonical_gaussians`):
    one Gaussian a pixel of each view, 2 h w a scene.

Attention runs through `layers.attention` (on the card: bf16 SDPA at 257
tokens, forward and backward). In training on the card the trunk (the
encoder, `ViTTrunk`, and the lockstep decoders, `CrossViewTrunk`) runs as
CUDA graphs, forward and backward (`NoPoSplat._trunk`): the same kernels,
launched as four graphs a step in place of some 7,000 launches.
Departures from the paper's code, kept the same in the plain reference
(`tests/noposplat_reference.py`):

  * the intrinsics token sits at RoPE position (rows of the grid, 0), one
    row below the first column, and is dropped before the heads;
  * the centre heads give no confidence channel (no loss here reads one);
  * the RGB shortcut adds relu(conv7x7(image)) to the Gaussian heads' last
    hidden features at full resolution, before their 1x1 output;
  * the fusion block that takes the coarsest level alone builds no
    residual unit for a skip input it never gets;
  * scales: the port's shared rule, the centre's distance from the first
    camera in place of the depth (`adapt_canonical_gaussians`);
  * `centre_prior_depth` (0, NoPoSplat's own mapping, by default) adds a
    fronto-parallel plane at that depth through each pixel's ray to the
    centres. Random weights put every centre within ~0.3 of the first
    camera, behind the near plane, where nothing renders and no gradient
    flows; the plane stands in for the geometry that MASt3R's weights give.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..precision import exact
from ..utils.profiling import count, span, stage
from .backbones.vgg_lpips import LPIPS
from .decoder import DecoderCfg, decode
from .gaussian_adapter import GaussianAdapterCfg, adapt_canonical_gaussians
from .layers import apply_rope_2d, attention, gelu_exact, layer_norm, rope_2d_tables
from .remat import remat
from .types import DecoderOutput, Gaussians

NOPO = "pf3.nopo."  # the span prefix of NoPoSplat's own stages


@dataclasses.dataclass(frozen=True)
class NoPoSplatCfg:
    """NoPoSplat's widths (the paper's ViT-L encoder and ViT-B decoders)."""
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: int = 4
    rope_base: float = 100.0
    # the decoder layers the DPT heads read beside the encoder output
    dpt_hooks: tuple[int, ...] = (6, 9, 12)
    dpt_layer_dims: tuple[int, ...] = (96, 192, 384, 768)
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    centre_prior_depth: float = 0.0
    gaussian_adapter: GaussianAdapterCfg = dataclasses.field(default_factory=GaussianAdapterCfg)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(b, n, c) -> (b, h, n, c / h)."""
    return t.unflatten(-1, (h, -1)).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(1, 2).flatten(-2)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, rope):
        q, k, v = _heads(self.qkv(x), 3 * self.num_heads).chunk(3, dim=1)
        out = attention(apply_rope_2d(q, rope), apply_rope_2d(k, rope), v)
        return self.proj(_merge(out))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y, rope_x, rope_y):
        h = self.num_heads
        q = apply_rope_2d(_heads(self.projq(x), h), rope_x)
        k = apply_rope_2d(_heads(self.projk(y), h), rope_y)
        return self.proj(_merge(attention(q, k, _heads(self.projv(y), h))))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = SelfAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x, rope):
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """DUSt3R's decoder block: x attends to itself, then to the other
    view's y (normed by `norm_y`), then its MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = SelfAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.cross_attn = CrossAttention(dim, num_heads)
        self.norm_y = layer_norm(dim)
        self.norm3 = layer_norm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x, y, rope_x, rope_y):
        x = x + self.attn(self.norm1(x), rope_x)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), rope_x, rope_y)
        return x + self.mlp(self.norm3(x))


class ViTTrunk(nn.Module):
    """The encoder stage of a `NoPoSplat` over its own modules (shared, not
    copied): normalised images (n, 3, h, w) and normalised intrinsics (n,
    3, 3) -> tokens (n, rows * cols + 1, width) after `enc_norm`. The RoPE
    tables of the token positions `pos` are made once, here."""

    def __init__(self, model: "NoPoSplat", pos: torch.Tensor):
        super().__init__()
        cfg = model.cfg
        self.patch_embed, self.intrinsics_embed = model.patch_embed, model.intrinsics_embed
        self.enc_blocks, self.enc_norm = model.enc_blocks, model.enc_norm
        self.rope = rope_2d_tables(pos, cfg.enc_embed_dim // cfg.enc_num_heads, cfg.rope_base)

    def forward(self, x, intrinsics):
        tok = self.patch_embed(x).flatten(2).transpose(1, 2)
        k = torch.stack([intrinsics[:, 0, 0], intrinsics[:, 1, 1], intrinsics[:, 0, 2],
                         intrinsics[:, 1, 2]], dim=-1)
        tok = torch.cat([tok, self.intrinsics_embed(k)[:, None]], dim=1)
        for blk in self.enc_blocks:
            tok = blk(tok, self.rope)
        return self.enc_norm(tok)


class CrossViewTrunk(nn.Module):
    """The lockstep decoders of a `NoPoSplat` over its own modules (shared,
    not copied): tokens (b, 2, n, width) -> {layer: (view 1, view 2)} of
    each decoder layer that the DPT heads read (`dpt_hooks`, 1-based; the
    last layer after `dec_norm`). The RoPE tables of the token positions
    `pos` are made once, here."""

    def __init__(self, model: "NoPoSplat", pos: torch.Tensor):
        super().__init__()
        cfg = model.cfg
        self.decoder_embed, self.dec_norm = model.decoder_embed, model.dec_norm
        self.dec_blocks, self.dec_blocks2 = model.dec_blocks, model.dec_blocks2
        self.hooks = set(cfg.dpt_hooks)
        self.rope = rope_2d_tables(pos, cfg.dec_embed_dim // cfg.dec_num_heads, cfg.rope_base)

    def forward(self, tok):
        rope = self.rope
        f = self.decoder_embed(tok)
        f1, f2 = f[:, 0], f[:, 1]
        out = {}
        for i, (blk1, blk2) in enumerate(zip(self.dec_blocks, self.dec_blocks2), 1):
            f1, f2 = blk1(f1, f2, rope, rope), blk2(f2, f1, rope, rope)
            if i == len(self.dec_blocks):
                f1, f2 = self.dec_norm(f1), self.dec_norm(f2)
            if i in self.hooks:
                out[i] = (f1, f2)
        return out


def _replays(stage_fn):
    """`stage_fn` (a graphed stage) counted in `nopo.graph_replays` at each call."""
    def replay(*args):
        count("nopo.graph_replays", 1)
        return stage_fn(*args)
    return replay


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionBlock(nn.Module):
    """DPT's feature fusion: the skip input through a residual unit added,
    a residual unit, 2x bilinear upsampling, a 1x1 convolution."""

    def __init__(self, dim: int, skip: bool):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(dim) if skip else None
        self.resConfUnit2 = ResidualConvUnit(dim)
        self.out_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(_upsample2(self.resConfUnit2(x)))


class DPTHead(nn.Module):
    """DUSt3R's DPT head over four token maps (b, n, c_i) of one grid ->
    (b, out_channels, 16 x the grid's rows, 16 x its columns); with
    `image_shortcut`, relu(conv7x7(image)) joins the last hidden features."""

    def __init__(self, cfg: NoPoSplatCfg, in_dims: tuple[int, ...], out_channels: int,
                 image_shortcut: bool = False):
        super().__init__()
        dims, f, last = cfg.dpt_layer_dims, cfg.dpt_feature_dim, cfg.dpt_last_dim
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_dims[0], dims[0], 1),
                          nn.ConvTranspose2d(dims[0], dims[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(in_dims[1], dims[1], 1),
                          nn.ConvTranspose2d(dims[1], dims[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(in_dims[2], dims[2], 1)),
            nn.Sequential(nn.Conv2d(in_dims[3], dims[3], 1),
                          nn.Conv2d(dims[3], dims[3], 3, stride=2, padding=1)),
        ])
        self.layer_rn = nn.ModuleList(nn.Conv2d(d, f, 3, padding=1, bias=False) for d in dims)
        self.refinenet = nn.ModuleList(FusionBlock(f, skip=i < 3) for i in range(4))
        self.head = nn.Sequential(nn.Conv2d(f, f // 2, 3, padding=1), nn.Upsample(
            scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(f // 2, last, 3, padding=1), nn.ReLU())
        self.image_merger = nn.Sequential(nn.Conv2d(3, last, 7, padding=3), nn.ReLU()) \
            if image_shortcut else None
        self.out = nn.Conv2d(last, out_channels, 1)

    def forward(self, tokens, grid: tuple[int, int], image: Optional[torch.Tensor] = None):
        layers = [rn(post(t.transpose(1, 2).unflatten(-1, grid)))
                  for t, post, rn in zip(tokens, self.act_postprocess, self.layer_rn)]
        path = self.refinenet[3](layers[3])[..., :layers[2].shape[2], :layers[2].shape[3]]
        for i in (2, 1, 0):
            path = self.refinenet[i](path, layers[i])
        x = self.head(path)
        if self.image_merger is not None:
            x = x + self.image_merger(image)
        return self.out(x)


def token_positions(rows: int, cols: int, device) -> torch.Tensor:
    """(rows * cols + 1, 2) RoPE positions (y, x): the patches row-major,
    then the intrinsics token at (rows, 0)."""
    y, x = torch.meshgrid(torch.arange(rows, device=device), torch.arange(cols, device=device),
                          indexing="ij")
    pos = torch.stack([y.flatten(), x.flatten()], dim=-1)
    return torch.cat([pos, pos.new_tensor([[rows, 0]])])


def exp_centres(x: torch.Tensor) -> torch.Tensor:
    """DUSt3R's `exp` depth mode on (..., 3): the direction kept, the norm
    d mapped to exp(d) - 1."""
    d = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / d.clamp(min=1e-8) * torch.expm1(d)


def pixel_rays(intrinsics: torch.Tensor, image_shape: tuple[int, int]) -> torch.Tensor:
    """Normalised intrinsics (..., 3, 3) -> each pixel centre's ray at unit
    depth in its camera, (..., h w, 3), row-major."""
    h, w = image_shape
    dev = intrinsics.device
    y, x = torch.meshgrid((torch.arange(h, device=dev) + 0.5) / h,
                          (torch.arange(w, device=dev) + 0.5) / w, indexing="ij")
    k = intrinsics[..., None, :, :]
    x = (x.flatten() - k[..., 0, 2]) / k[..., 0, 0]
    y = (y.flatten() - k[..., 1, 2]) / k[..., 1, 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def canonical_poses(extrinsics: torch.Tensor) -> torch.Tensor:
    """c2w (b, v, 4, 4) of a view stack whose first and last views are the
    context -> the same cameras in the first view's frame, translations
    scaled so that the context views lie 1 apart (`make_baseline_1`), in
    exact float32."""
    with exact():
        rel = torch.linalg.inv(extrinsics[:, :1]) @ extrinsics
    baseline = torch.linalg.norm(rel[:, -1, :3, 3], dim=-1)
    rel[..., :3, 3] = rel[..., :3, 3] / baseline[:, None, None]
    return rel


class NoPoSplat(nn.Module):
    """`gaussians(images, intrinsics)` for two context views; `forward`
    also renders target cameras given in the first view's frame. On
    `device` (default `cuda`; without a GPU it raises unless "cpu"). The
    LPIPS VGG is frozen; every other parameter trains
    (`trainable_parameters`)."""

    def __init__(self, cfg: NoPoSplatCfg, decoder: DecoderCfg = DecoderCfg(),
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg, self.decoder_cfg = cfg, decoder
        self.device = resolve_device(device)
        e, d, r = cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.mlp_ratio
        self.patch_embed = nn.Conv2d(3, e, cfg.patch_size, stride=cfg.patch_size)
        self.intrinsics_embed = nn.Linear(4, e)
        self.enc_blocks = nn.ModuleList(
            EncoderBlock(e, cfg.enc_num_heads, r) for _ in range(cfg.enc_depth))
        self.enc_norm = layer_norm(e)
        self.decoder_embed = nn.Linear(e, d)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(d, cfg.dec_num_heads, r) for _ in range(cfg.dec_depth))
        self.dec_blocks2 = nn.ModuleList(
            DecoderBlock(d, cfg.dec_num_heads, r) for _ in range(cfg.dec_depth))
        self.dec_norm = layer_norm(d)
        dims = (e, d, d, d)
        n_raw = 1 + cfg.gaussian_adapter.d_in  # opacity, scale, rotation, harmonics
        self.downstream_head1 = DPTHead(cfg, dims, 3)
        self.downstream_head2 = DPTHead(cfg, dims, 3)
        self.gaussian_param_head = DPTHead(cfg, dims, n_raw, image_shortcut=True)
        self.gaussian_param_head2 = DPTHead(cfg, dims, n_raw, image_shortcut=True)
        self.lpips = LPIPS()
        self.lpips.requires_grad_(False)
        self.to(self.device)
        # the trunk's CUDA graphs by input shapes, dtypes and TF32 flags (`_trunk`)
        self._trunk_graphs: dict = {}

    def trainable_parameters(self) -> list[nn.Parameter]:
        return [p for n, p in self.named_parameters() if not n.startswith("lpips.")]

    def lpips_apply(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """Frozen LPIPS distance (b, h, w, 3) x2 -> (b,), its VGG recomputed
        in the backward (as PF3plat's)."""
        return remat(self.lpips, img0, img1)

    def _trunk(self, x: torch.Tensor, intrinsics: torch.Tensor, grid: tuple[int, int],
               views: tuple[int, int]):
        """The trunk's two stages (`ViTTrunk`, `CrossViewTrunk`) for `gaussians`'
        inputs x (b v, 3, h, w) and intrinsics (b v, 3, 3).

        Training on the card (CUDA inputs without a gradient of their own,
        grad mode on, training mode, no autocast) replays both as CUDA
        graphs, forward and backward (`torch.cuda.make_graphed_callables`):
        the trunk's ~2,800 forward launches and their backward's reach the
        card as four graph launches. The graphs are captured at the first
        call with these shapes, dtypes and TF32 flags (`nopo.graph_captures`)
        and kept, one memory pool for each such key. The parameters are
        graph inputs read where they lie, so a replay sees the optimizer's
        in-place updates. A replay's backward hands each gradient back as an
        alias of the backward graph's own buffer, and p.grad keeps it: that
        is safe while the train steps set p.grad to None before the next
        forward and the optimizer reads it before the next backward replay
        overwrites it. Everywhere else (the CPU, no_grad, eval mode) the
        stages run as modules."""
        if not (x.is_cuda and torch.is_grad_enabled() and self.training
                and not torch.is_autocast_enabled("cuda") and not x.requires_grad):
            pos = token_positions(*grid, x.device)
            return ViTTrunk(self, pos), CrossViewTrunk(self, pos)
        key = (x.shape, x.dtype, intrinsics.shape, intrinsics.dtype,
               torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        stages = self._trunk_graphs.get(key)
        if stages is None:
            count("nopo.graph_captures", 1)
            pos = token_positions(*grid, x.device)
            tok = torch.zeros((*views, pos.shape[0], self.cfg.enc_embed_dim), dtype=x.dtype,
                              device=x.device, requires_grad=True)
            captured = torch.cuda.make_graphed_callables(
                (ViTTrunk(self, pos), CrossViewTrunk(self, pos)),
                ((x.clone(), intrinsics.clone()), (tok,)))
            stages = self._trunk_graphs[key] = tuple(_replays(g) for g in captured)
        return stages

    def gaussians(self, images: torch.Tensor, intrinsics: torch.Tensor,
                  timer=None) -> Gaussians:
        """images (b, 2, h, w, 3) in [0, 1], normalised intrinsics (b, 2, 3,
        3) -> the scene's 2 h w Gaussians in the first view's camera frame.
        `timer` is called with "vit", "crossview" and "heads" as each ends."""
        cfg = self.cfg
        b, v, h, w, _ = images.shape
        grid = (h // cfg.patch_size, w // cfg.patch_size)
        x = (images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2) - 0.5) / 0.5
        k = intrinsics.reshape(b * v, 3, 3)
        vit, crossview = self._trunk(x, k, grid, (b, v))
        with stage("vit", timer, prefix=NOPO):
            tok = vit(x, k).unflatten(0, (b, v))
        with stage("crossview", timer, prefix=NOPO):
            layers = {0: (tok[:, 0], tok[:, 1]), **crossview(tok)}
        with stage("heads", timer, prefix=NOPO):
            x = x.unflatten(0, (b, v))
            centres, raw = [], []
            heads = ((self.downstream_head1, self.gaussian_param_head),
                     (self.downstream_head2, self.gaussian_param_head2))
            for i, (centre_head, param_head) in enumerate(heads):
                tokens = [layers[j][i][:, :-1] for j in (0, *cfg.dpt_hooks)]
                centres.append(centre_head(tokens, grid))
                raw.append(param_head(tokens, grid, x[:, i]))
            means = exp_centres(torch.stack(centres, 1).permute(0, 1, 3, 4, 2).flatten(2, 3))
            if cfg.centre_prior_depth:
                means = means + cfg.centre_prior_depth * pixel_rays(intrinsics, (h, w))
            raw = torch.stack(raw, 1).permute(0, 1, 3, 4, 2).flatten(2, 3)
            means, covs, harmonics, opacities, _, _ = adapt_canonical_gaussians(
                cfg.gaussian_adapter, intrinsics[:, :, None], means, torch.sigmoid(raw[..., 0]),
                raw[..., 1:], (h, w))
            return Gaussians(means.flatten(1, 2), covs.flatten(1, 2), harmonics.flatten(1, 2),
                             opacities.flatten(1, 2))

    def forward(self, images, intrinsics, target_extrinsics=None, target_intrinsics=None,
                near=None, far=None, timer=None) -> tuple[Gaussians, Optional[DecoderOutput]]:
        """The Gaussians of the two context views (`gaussians`) and, given
        target cameras (c2w (b, t, 4, 4) in the first view's frame, their
        intrinsics, near and far (b, t)), their renders ("decoder" stage)."""
        with span("pf3.forward"):
            count("forwards", 1)
            images, intrinsics = (x.to(self.device, torch.float32) for x in (images, intrinsics))
            g = self.gaussians(images, intrinsics, timer)
            out = None
            if target_extrinsics is not None:
                with stage("decoder", timer):
                    out = decode(self.decoder_cfg, g, target_extrinsics, target_intrinsics,
                                 near, far, tuple(images.shape[2:4]))
            return g, out
