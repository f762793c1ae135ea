"""NoPoSplat's reference for the benchmark: the model part is a copy of the
repository's plain float32 reference (`tests/noposplat_reference.py`, which
states the equations and every departure; a tier-1 test holds the two to the
same Gaussians bit for bit), and below it the training step, on the
benchmark's reference renderer (`decoder.decode`), LPIPS VGG and optimizer
(`training/train.py`).

Training follows the port's `make_noposplat_train_step`: the batch's view
stack has the context views first and last, the targets between them,
rendered at their poses in the first view's frame with the context baseline
scaled to 1; the loss is MSE plus LPIPS over the targets, each at its
weight. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .backbones.vgg_lpips import LPIPS
from .decoder import DecoderCfg, decode
from .types import Gaussians


@contextlib.contextmanager
def fp32():
    """TF32 off for cuBLAS and cuDNN and autocast off inside; the previous
    flags come back on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast("cuda", enabled=False), torch.autocast("cpu", enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@dataclasses.dataclass(frozen=True)
class AdapterCfg:
    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4


@dataclasses.dataclass(frozen=True)
class NoPoSplatCfg:
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: int = 4
    rope_base: float = 100.0
    dpt_hooks: tuple[int, ...] = (6, 9, 12)
    dpt_layer_dims: tuple[int, ...] = (96, 192, 384, 768)
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    centre_prior_depth: float = 0.0
    gaussian_adapter: AdapterCfg = dataclasses.field(default_factory=AdapterCfg)


# ---- RoPE-2D ---------------------------------------------------------------


def rope_1d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """t (b, h, n, d) rotated by the integer positions pos (n,)."""
    d = t.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, device=t.device).float() / d))
    steps = torch.arange(int(pos.max()) + 1, device=t.device, dtype=inv_freq.dtype)
    freqs = torch.einsum("i,j->ij", steps, inv_freq)
    freqs = torch.cat((freqs, freqs), dim=-1)
    cos = F.embedding(pos, freqs.cos())[None, None]
    sin = F.embedding(pos, freqs.sin())[None, None]
    x1, x2 = t[..., : d // 2], t[..., d // 2:]
    return t * cos + torch.cat((-x2, x1), dim=-1) * sin


def rope_2d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """t (b, h, n, d); pos (n, 2) = (y, x)."""
    y, x = t.chunk(2, dim=-1)
    return torch.cat((rope_1d(y, pos[:, 0], base), rope_1d(x, pos[:, 1], base)), dim=-1)


def positions(rows: int, cols: int, device) -> torch.Tensor:
    """The patches' (y, x), row-major, then the intrinsics token's (rows, 0)."""
    pos = [(y, x) for y in range(rows) for x in range(cols)] + [(rows, 0)]
    return torch.tensor(pos, dtype=torch.long, device=device)


# ---- transformer -------------------------------------------------------------


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def sdpa(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in float32."""
    return F.scaled_dot_product_attention(q.float(), k.float(), v.float())


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos, base):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        out = sdpa(rope_2d(q, pos, base), rope_2d(k, pos, base), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y, xpos, ypos, base):
        b, n, c = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(b, -1, h, c // h).permute(0, 2, 1, 3)

        q = rope_2d(heads(self.projq(x)), xpos, base)
        k = rope_2d(heads(self.projk(y)), ypos, base)
        out = sdpa(q, k, heads(self.projv(y)))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = SelfAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x, pos, base):
        x = x + self.attn(self.norm1(x), pos, base)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = SelfAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.cross_attn = CrossAttention(dim, num_heads)
        self.norm_y = layer_norm(dim)
        self.norm3 = layer_norm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x, y, xpos, ypos, base):
        x = x + self.attn(self.norm1(x), xpos, base)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, xpos, ypos, base)
        return x + self.mlp(self.norm3(x))


# ---- DPT -------------------------------------------------------------------


def upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        out = self.conv1(F.relu(x))
        out = self.conv2(F.relu(out))
        return out + x


class FusionBlock(nn.Module):
    def __init__(self, dim: int, skip: bool):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(dim) if skip else None
        self.resConfUnit2 = ResidualConvUnit(dim)
        self.out_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        return self.out_conv(upsample2(x))


class DPTHead(nn.Module):
    def __init__(self, cfg: NoPoSplatCfg, in_dims, out_channels: int,
                 image_shortcut: bool = False):
        super().__init__()
        d, f, last = cfg.dpt_layer_dims, cfg.dpt_feature_dim, cfg.dpt_last_dim
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_dims[0], d[0], 1), nn.ConvTranspose2d(d[0], d[0], 4, 4)),
            nn.Sequential(nn.Conv2d(in_dims[1], d[1], 1), nn.ConvTranspose2d(d[1], d[1], 2, 2)),
            nn.Sequential(nn.Conv2d(in_dims[2], d[2], 1)),
            nn.Sequential(nn.Conv2d(in_dims[3], d[3], 1), nn.Conv2d(d[3], d[3], 3, 2, 1)),
        ])
        self.layer_rn = nn.ModuleList(nn.Conv2d(c, f, 3, padding=1, bias=False) for c in d)
        self.refinenet = nn.ModuleList(FusionBlock(f, skip=i < 3) for i in range(4))
        self.head = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(f // 2, last, 3, padding=1), nn.ReLU())
        self.image_merger = nn.Sequential(nn.Conv2d(3, last, 7, padding=3), nn.ReLU()) \
            if image_shortcut else None
        self.out = nn.Conv2d(last, out_channels, 1)

    def forward(self, tokens, rows: int, cols: int, image=None):
        layers = []
        for t, post, rn in zip(tokens, self.act_postprocess, self.layer_rn):
            b, n, c = t.shape
            x = t.permute(0, 2, 1).reshape(b, c, rows, cols)
            layers.append(rn(post(x)))
        path = self.refinenet[3](layers[3])
        path = path[:, :, :layers[2].shape[2], :layers[2].shape[3]]
        path = self.refinenet[2](path, layers[2])
        path = self.refinenet[1](path, layers[1])
        path = self.refinenet[0](path, layers[0])
        x = self.head(path)
        if self.image_merger is not None:
            x = x + self.image_merger(image)
        return self.out(x)


# ---- the model ----------------------------------------------------------------


def quaternion_xyzw_to_matrix(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def pixel_rays(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(b, v, 3, 3) normalised intrinsics -> (b, v, h w, 3) rays at unit depth."""
    ys = (torch.arange(h, device=k.device) + 0.5) / h
    xs = (torch.arange(w, device=k.device) + 0.5) / w
    y = ys[:, None].expand(h, w).reshape(-1)
    x = xs[None, :].expand(h, w).reshape(-1)
    fx, fy = k[..., 0, 0, None], k[..., 1, 1, None]
    cx, cy = k[..., 0, 2, None], k[..., 1, 2, None]
    rx, ry = (x - cx) / fx, (y - cy) / fy
    return torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)


class NoPoSplat(nn.Module):
    def __init__(self, cfg: NoPoSplatCfg):
        super().__init__()
        self.cfg = cfg
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
        n_raw = 1 + 7 + 3 * (cfg.gaussian_adapter.sh_degree + 1) ** 2
        self.downstream_head1 = DPTHead(cfg, dims, 3)
        self.downstream_head2 = DPTHead(cfg, dims, 3)
        self.gaussian_param_head = DPTHead(cfg, dims, n_raw, image_shortcut=True)
        self.gaussian_param_head2 = DPTHead(cfg, dims, n_raw, image_shortcut=True)

    def encode(self, images, intrinsics):
        """images (b, 2, h, w, 3), intrinsics (b, 2, 3, 3) -> the decoder's
        layer list [(view 1, view 2)], the encoder output first."""
        cfg = self.cfg
        b, v, h, w, _ = images.shape
        rows, cols = h // cfg.patch_size, w // cfg.patch_size
        pos = positions(rows, cols, images.device)
        x = images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2)
        x = (x - 0.5) / 0.5
        tok = self.patch_embed(x).flatten(2).transpose(1, 2)
        k = intrinsics.reshape(b * v, 3, 3)
        kvec = torch.stack([k[:, 0, 0], k[:, 1, 1], k[:, 0, 2], k[:, 1, 2]], dim=-1)
        tok = torch.cat([tok, self.intrinsics_embed(kvec)[:, None]], dim=1)
        for blk in self.enc_blocks:
            tok = blk(tok, pos, cfg.rope_base)
        tok = self.enc_norm(tok)
        tok = tok.reshape(b, v, *tok.shape[1:])
        enc1, enc2 = tok[:, 0], tok[:, 1]
        f1, f2 = self.decoder_embed(enc1), self.decoder_embed(enc2)
        out = [(enc1, enc2)]
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            g1 = blk1(f1, f2, pos, pos, cfg.rope_base)
            g2 = blk2(f2, f1, pos, pos, cfg.rope_base)
            f1, f2 = g1, g2
            out.append((f1, f2))
        out[-1] = (self.dec_norm(f1), self.dec_norm(f2))
        return out

    def gaussians(self, images, intrinsics):
        """-> (means (b, 2 h w, 3), covariances (..., 3, 3), harmonics (...,
        3, d_sh), opacities (b, 2 h w)) in the first view's frame."""
        with fp32():
            return self._gaussians(images.float(), intrinsics.float())

    def _gaussians(self, images, intrinsics):
        cfg, ad = self.cfg, self.cfg.gaussian_adapter
        b, v, h, w, _ = images.shape
        rows, cols = h // cfg.patch_size, w // cfg.patch_size
        layers = self.encode(images, intrinsics)
        x = (images.permute(0, 1, 4, 2, 3) - 0.5) / 0.5
        centres, raws = [], []
        heads = ((self.downstream_head1, self.gaussian_param_head),
                 (self.downstream_head2, self.gaussian_param_head2))
        for i, (centre_head, param_head) in enumerate(heads):
            tokens = [layers[j][i][:, :-1] for j in (0, *cfg.dpt_hooks)]
            centres.append(centre_head(tokens, rows, cols))
            raws.append(param_head(tokens, rows, cols, x[:, i]))
        pts = torch.stack(centres, 1).permute(0, 1, 3, 4, 2).reshape(b, v, h * w, 3)
        dist = torch.linalg.norm(pts, dim=-1, keepdim=True)
        means = pts / dist.clamp(min=1e-8) * torch.expm1(dist)
        if cfg.centre_prior_depth:
            means = means + cfg.centre_prior_depth * pixel_rays(intrinsics, h, w)
        raw = torch.stack(raws, 1).permute(0, 1, 3, 4, 2).reshape(b, v, h * w, -1)
        opacities = torch.sigmoid(raw[..., 0])
        scales, quats, sh = raw[..., 1:4], raw[..., 4:8], raw[..., 8:]
        k = intrinsics[:, :, None]
        fx, fy, s = k[..., 0, 0], k[..., 1, 1], k[..., 0, 1]
        footprint = 0.1 * (1 / (fx * w) - s / (fx * fy * h) + 1 / (fy * h))
        depth = torch.linalg.norm(means, dim=-1)
        scales = ad.gaussian_scale_min + (ad.gaussian_scale_max - ad.gaussian_scale_min) \
            * torch.sigmoid(scales)
        scales = scales * depth[..., None] * footprint[..., None]
        d_sh = (ad.sh_degree + 1) ** 2
        mask = torch.ones(d_sh, device=raw.device)
        for degree in range(1, ad.sh_degree + 1):
            mask[degree ** 2:(degree + 1) ** 2] = 0.1 * 0.25 ** degree
        harmonics = sh.reshape(*sh.shape[:-1], 3, d_sh) * mask
        rs = quaternion_xyzw_to_matrix(quats) * scales[..., None, :]
        covariances = rs @ rs.transpose(-1, -2)
        return (means.reshape(b, v * h * w, 3), covariances.reshape(b, v * h * w, 3, 3),
                harmonics.reshape(b, v * h * w, 3, d_sh), opacities.reshape(b, v * h * w))


def canonical_poses(extrinsics: torch.Tensor) -> torch.Tensor:
    """c2w (b, v, 4, 4), the first and last views the context -> in the
    first view's frame, the context baseline scaled to 1."""
    with fp32():
        rel = torch.linalg.inv(extrinsics[:, :1]) @ extrinsics
    baseline = torch.linalg.norm(rel[:, -1, :3, 3], dim=-1)
    rel[..., :3, 3] = rel[..., :3, 3] / baseline[:, None, None]
    return rel


# ---- training --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RenderLossCfg:
    mse_weight: float = 1.0
    lpips_weight: float = 0.05
    lpips_apply_after_step: int = 0


class NoPoSplatTrainer(NoPoSplat):
    """The reference with the frozen LPIPS VGG (`lpips.*`, as the port's
    model holds it) and the splat decoder's configuration."""

    def __init__(self, cfg: NoPoSplatCfg, decoder: DecoderCfg = DecoderCfg()):
        super().__init__(cfg)
        self.decoder_cfg = decoder
        self.lpips = LPIPS()
        self.lpips.requires_grad_(False)

    def trainable(self) -> list[tuple[str, nn.Parameter]]:
        return [(n, p) for n, p in self.named_parameters() if not n.startswith("lpips.")]


def render_loss(model: NoPoSplatTrainer, gaussians: Gaussians, batch: dict,
                cfg: RenderLossCfg, step: int) -> tuple[torch.Tensor, dict]:
    """The targets of a batch (image (b, v, h, w, 3), intrinsics, extrinsics
    c2w, near, far of the view stack) rendered from the scenes' Gaussians,
    and the loss -> (loss, parts)."""
    images, intr, extr, near, far = (batch[k].float() for k in
                                     ("image", "intrinsics", "extrinsics", "near", "far"))
    b, v, h, w, _ = images.shape
    targets = list(range(1, v - 1)) if v > 2 else [0, v - 1]
    poses = canonical_poses(extr)
    color = decode(model.decoder_cfg, gaussians, poses[:, targets], intr[:, targets],
                   near[:, targets], far[:, targets], (h, w)).color
    target = images[:, targets]
    parts = {"mse": cfg.mse_weight * torch.mean((color - target) ** 2)}
    if cfg.lpips_weight > 0:
        lp = model.lpips(color.reshape(-1, h, w, 3), target.reshape(-1, h, w, 3)).mean() \
            if step >= cfg.lpips_apply_after_step else color.new_zeros(())
        parts["lpips"] = cfg.lpips_weight * lp
    return sum(parts.values()), parts


def context_gaussians(model: NoPoSplatTrainer, batch: dict, rows: slice = slice(None)):
    """The Gaussians of the batch's `rows` from their context views (the
    first and last of each stack)."""
    images, intr = batch["image"][rows].float(), batch["intrinsics"][rows].float()
    v = images.shape[1]
    return model.gaussians(images[:, [0, v - 1]], intr[:, [0, v - 1]])


def step_loss(model: NoPoSplatTrainer, batch: dict, cfg: RenderLossCfg, step: int
              ) -> tuple[torch.Tensor, dict]:
    """One step's loss on a batch -> (loss, parts)."""
    return render_loss(model, Gaussians(*context_gaussians(model, batch)), batch, cfg, step)
