"""The benchmark's plain float32 reference of VGGT (Wang et al., CVPR 2025,
arXiv 2503.11651; code github.com/facebookresearch/vggt, weights
`facebook/VGGT-1B`): a copy of the port's test reference
(`tests/vggt_reference.py`), held to it bit for bit by
`tests/test_torch_vggt.py`. It imports nothing of the port and nothing of
JAX, computes with TF32 off and autocast off (`fp32()`), and carries the
port's (the released) parameter names.

  * frames (b, S, h, w, 3) in [0, 1], (x - mean) / std with the ResNet mean
    (0.485, 0.456, 0.406) and std (0.229, 0.224, 0.225);
  * patch embedding: DINOv2 ViT-L/14 with registers on the b S frames: a
    14 x 14 stride-14 convolution, the cls token prepended, the position
    table (37 x 37 + 1) added with its patch part resized in float32 to
    (h / 14, w / 14) bicubically with antialiasing, then the 4 register
    tokens inserted after the cls token; 24 pre-LN blocks (LayerNorm eps
    1e-6, LayerScale, erf GELU, no q/k norm, no RoPE) and the final norm;
    its patch tokens;
  * aggregator: per frame [camera (1), registers (4), patches], the first
    frame taking index 0 of `camera_token` / `register_token` and the rest
    index 1; 24 pairs of a frame block over (b S, P, C) and a global block
    over (b, S P, C); a block x += ls1 proj(attn(LN1 x)), x += ls2
    fc2(GELU(fc1(LN2 x))) with LayerNorm eps 1e-5; attention q, k each
    through LayerNorm(head dim, eps 1e-5), then RoPE-2D (base 100: the
    first half of a head rotated by the row, the second by the column, each
    half t cos + rotate_half(t) sin, rotate_half(a, b) = (-b, a), angles p
    base^(-2i / (d / 2))) at (row + 1, column + 1) for patches and (0, 0)
    for the special tokens, then softmax(q k^T / sqrt(d)) v; pair i's
    output concat(frame, global);
  * camera head: token_norm of the last pair's camera tokens; 4 passes of
    adaLN modulation from embed_pose(empty, or the previous encoding), 4
    blocks at width 2C (16 heads, no q/k norm, no RoPE), pose_branch on
    trunk_norm; the encoding summed; field of view through ReLU;
  * DPT heads at pairs (4, 11, 17, 23): LayerNorm, 1x1 projections to (256,
    512, 1024, 1024), + 0.1 sin-cos uv embedding (omega_0 100, in float64),
    ConvTranspose 4x / 2x / identity / stride-2 conv, 3x3 convs to 256 (no
    bias), fusion from coarse to fine (residual units whose first ReLU is
    in place, so the residual adds relu(x); bilinear with aligned corners
    to the next level's size, the finest 2x; 1x1), output_conv1, bilinear
    to the image, the uv embedding again, 3x3 to 32, ReLU, 1x1; frames in
    chunks of 8. Depth exp, points sign expm1(|.|), confidences 1 + exp.

Departures from the released code (the port keeps the same): only the
hooked pairs are kept; no track head and no DINOv2 `mask_token`; the
camera head's attention is float32 here, as released, and bf16 on the
card in the port (a stated precision, not a departure of the reference).
The global attention runs in blocks of `ROWS` query rows (the same
arithmetic: each row's softmax is over all keys) so that its logits fit
the card.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# query rows an attention call takes at a time
ROWS = 4096


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
class VGGTCfg:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    patch_embed_depth: int = 24
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    num_register_tokens: int = 4
    rope_freq: float = 100.0
    init_values: float = 0.01
    hooks: tuple[int, ...] = (4, 11, 17, 23)
    camera_depth: int = 4
    camera_num_heads: int = 16
    camera_iterations: int = 4
    camera_init_values: float = 0.01
    dpt_features: int = 256
    dpt_out_channels: tuple[int, ...] = (256, 512, 1024, 1024)
    frames_chunk_size: int = 8


# ---- attention ---------------------------------------------------------------


def sdpa(q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in float32, `ROWS` query rows a call."""
    q, k, v = q.float(), k.float(), v.float()
    return torch.cat([F.scaled_dot_product_attention(q[..., lo:lo + ROWS, :], k, v)
                      for lo in range(0, q.shape[-2], ROWS)], dim=-2)


def rope_1d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """t (b, h, n, d) rotated by the integer positions pos (n,)."""
    d = t.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, device=t.device).float() / d))
    steps = torch.arange(int(pos.max()) + 1, device=t.device, dtype=inv_freq.dtype)
    angles = torch.einsum("i,j->ij", steps, inv_freq)
    angles = torch.cat((angles, angles), dim=-1)
    cos = F.embedding(pos, angles.cos())[None, None]
    sin = F.embedding(pos, angles.sin())[None, None]
    a, b = t[..., : d // 2], t[..., d // 2:]
    return t * cos + torch.cat((-b, a), dim=-1) * sin


def rope_2d(t: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """t (b, h, n, d); pos (n, 2) = (y, x): y rotates the first half."""
    y, x = t.chunk(2, dim=-1)
    return torch.cat((rope_1d(y, pos[:, 0], base), rope_1d(x, pos[:, 1], base)), dim=-1)


def positions(rows: int, cols: int, special: int, device) -> torch.Tensor:
    """A frame's (y, x): the special tokens at (0, 0), the patches at (row
    + 1, column + 1), row-major."""
    pos = [(0, 0)] * special + [(y + 1, x + 1) for y in range(rows) for x in range(cols)]
    return torch.tensor(pos, dtype=torch.long, device=device)


# ---- transformer ---------------------------------------------------------------


class LayerScale(nn.Module):
    def __init__(self, dim: int, value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(value)))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qk_norm: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(dim // num_heads, eps=1e-5)
            self.k_norm = nn.LayerNorm(dim // num_heads, eps=1e-5)
        self.qk_norm = qk_norm
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, pos=None, base: float = 100.0):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if pos is not None:
            q, k = rope_2d(q, pos, base), rope_2d(k, pos, base)
        out = sdpa(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, ls: float, eps: float,
                 qk_norm: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, qk_norm)
        self.ls1 = LayerScale(dim, ls)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.ls2 = LayerScale(dim, ls)

    def forward(self, x, pos=None, base: float = 100.0):
        x = x + self.ls1(self.attn(self.norm1(x), pos, base))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, p: int, d: int):
        super().__init__()
        self.proj = nn.Conv2d(3, d, p, stride=p)


class DINOv2(nn.Module):
    """DINOv2 with registers: normalised frames (n, 3, h, w) -> the final
    norm's patch tokens (n, h w / 14^2, C)."""

    def __init__(self, cfg: VGGTCfg):
        super().__init__()
        d, self.p = cfg.embed_dim, cfg.patch_size
        self.side = cfg.img_size // cfg.patch_size
        self.patch_embed = PatchEmbed(self.p, d)
        self.cls_token = nn.Parameter(torch.randn(1, 1, d) * 1e-6)
        self.pos_embed = nn.Parameter(torch.randn(1, self.side**2 + 1, d) * 0.02)
        self.register_tokens = nn.Parameter(torch.randn(1, cfg.num_register_tokens, d) * 1e-6)
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, 1.0, 1e-6, qk_norm=False)
            for _ in range(cfg.patch_embed_depth))
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, x):
        n, _, h, w = x.shape
        rows, cols = h // self.p, w // self.p
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(n, -1, -1), x], dim=1)
        pos = self.pos_embed.float()
        grid = pos[:, 1:].reshape(1, self.side, self.side, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(rows, cols), mode="bicubic", antialias=True)
        pos = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, rows * cols, -1)], 1)
        x = x + pos
        x = torch.cat([x[:, :1], self.register_tokens.expand(n, -1, -1), x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.register_tokens.shape[1]:]


def first_and_rest(token: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """(1, 2, k, C) -> (b S, k, C): index 0 for frame 0, 1 for the others."""
    return torch.cat([token[:, :1].expand(b, 1, -1, -1),
                      token[:, 1:].expand(b, s - 1, -1, -1)], dim=1).reshape(
        b * s, token.shape[2], token.shape[3])


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTCfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = DINOv2(cfg)

        def blocks():
            return nn.ModuleList(
                Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, 1e-5, qk_norm=True)
                for _ in range(cfg.depth))

        self.frame_blocks, self.global_blocks = blocks(), blocks()
        self.camera_token = nn.Parameter(torch.randn(1, 2, 1, d) * 1e-6)
        self.register_token = nn.Parameter(torch.randn(1, 2, cfg.num_register_tokens, d) * 1e-6)

    def forward(self, frames, keep) -> dict:
        """frames (b, S, h, w, 3) normalised -> {pair: (b, S, P, 2C)}."""
        cfg = self.cfg
        b, s, h, w, _ = frames.shape
        patches = self.patch_embed(frames.reshape(b * s, h, w, 3).permute(0, 3, 1, 2))
        x = torch.cat([first_and_rest(self.camera_token, b, s),
                       first_and_rest(self.register_token, b, s), patches], dim=1)
        p, c = x.shape[1:]
        pos = positions(h // cfg.patch_size, w // cfg.patch_size,
                        1 + cfg.num_register_tokens, frames.device)
        out = {}
        for i in range(cfg.depth):
            x = self.frame_blocks[i](x.reshape(b * s, p, c), pos, cfg.rope_freq)
            frame = x.reshape(b, s, p, c)
            x = self.global_blocks[i](x.reshape(b, s * p, c), pos.repeat(s, 1), cfg.rope_freq)
            if i in keep:
                out[i] = torch.cat([frame, x.reshape(b, s, p, c)], dim=-1)
        return out


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTCfg):
        super().__init__()
        d = 2 * cfg.embed_dim
        self.iterations = cfg.camera_iterations
        self.trunk = nn.Sequential(*(
            Block(d, cfg.camera_num_heads, cfg.mlp_ratio, cfg.camera_init_values, 1e-5,
                  qk_norm=False)
            for _ in range(cfg.camera_depth)))
        self.token_norm = nn.LayerNorm(d, eps=1e-5)
        self.trunk_norm = nn.LayerNorm(d, eps=1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, d)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 3 * d))
        self.pose_branch = Mlp(d, d // 2, 9)

    def forward(self, camera_tokens) -> list[torch.Tensor]:
        tokens = self.token_norm(camera_tokens)
        b, s, d = tokens.shape
        enc, out = None, []
        for _ in range(self.iterations):
            if enc is None:
                u = self.embed_pose(self.empty_pose_tokens.expand(b, s, -1))
            else:
                u = self.embed_pose(enc.detach())
            shift, scale, gate = self.poseLN_modulation(u).chunk(3, dim=-1)
            normed = F.layer_norm(tokens, (d,), eps=1e-6)
            y = gate * (normed * (1 + scale) + shift) + tokens
            for blk in self.trunk:
                y = blk(y)
            delta = self.pose_branch(self.trunk_norm(y))
            enc = delta if enc is None else enc + delta
            out.append(torch.cat([enc[..., :3], enc[..., 3:7], F.relu(enc[..., 7:])], dim=-1))
        return out


# ---- DPT -------------------------------------------------------------------------


def uv_embed(channels: int, rows: int, cols: int, aspect: float, device) -> torch.Tensor:
    """(channels, rows, cols): sin-cos embedding of the uv grid (u over
    columns, v over rows), the x half then the y half, each [sin, cos]."""
    diag = (aspect**2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (cols - 1) / cols, span_x * (cols - 1) / cols, steps=cols,
                        device=device)
    ys = torch.linspace(-span_y * (rows - 1) / rows, span_y * (rows - 1) / rows, steps=rows,
                        device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")

    def embed(dim, p):
        omega = torch.arange(dim // 2, dtype=torch.float64, device=device) / (dim / 2.0)
        omega = 1.0 / 100.0**omega
        ang = p.reshape(-1).to(torch.float64)[:, None] * omega[None]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float()

    emb = torch.cat([embed(channels // 2, uu), embed(channels // 2, vv)], dim=-1)
    return emb.view(rows, cols, channels).permute(2, 0, 1)


class ResidualConvUnit(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        x = F.relu(x)  # the released unit's in-place ReLU: the residual is relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class FusionBlock(nn.Module):
    def __init__(self, dim: int, residual: bool):
        super().__init__()
        if residual:
            self.resConfUnit1 = ResidualConvUnit(dim)
        self.residual = residual
        self.resConfUnit2 = ResidualConvUnit(dim)
        self.out_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x, skip=None, size=None):
        if self.residual:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        if size is None:
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        else:
            x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.out_conv(x)


class Scratch(nn.Module):
    def __init__(self, cfg: VGGTCfg, output_dim: int):
        super().__init__()
        f, oc = cfg.dpt_features, cfg.dpt_out_channels
        self.layer1_rn = nn.Conv2d(oc[0], f, 3, padding=1, bias=False)
        self.layer2_rn = nn.Conv2d(oc[1], f, 3, padding=1, bias=False)
        self.layer3_rn = nn.Conv2d(oc[2], f, 3, padding=1, bias=False)
        self.layer4_rn = nn.Conv2d(oc[3], f, 3, padding=1, bias=False)
        self.refinenet1 = FusionBlock(f, True)
        self.refinenet2 = FusionBlock(f, True)
        self.refinenet3 = FusionBlock(f, True)
        self.refinenet4 = FusionBlock(f, False)
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(),
                                          nn.Conv2d(32, output_dim, 1))


class DPTHead(nn.Module):
    def __init__(self, cfg: VGGTCfg, output_dim: int, activation: str):
        super().__init__()
        self.cfg, self.activation = cfg, activation
        d, oc = 2 * cfg.embed_dim, cfg.dpt_out_channels
        self.norm = nn.LayerNorm(d, eps=1e-5)
        self.projects = nn.ModuleList(nn.Conv2d(d, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = Scratch(cfg, output_dim)

    def forward(self, tokens, start: int, h: int, w: int):
        """tokens: the hooked pairs' (b, S, P, 2C) -> (b, S, h, w, k), (b, S, h, w)."""
        b, s = tokens[0].shape[:2]
        chunk = self.cfg.frames_chunk_size
        preds, confs = [], []
        for lo in range(0, s, chunk):
            pred, conf = self.frames([t[:, lo:lo + chunk, start:] for t in tokens], h, w)
            preds.append(pred)
            confs.append(conf)
        return torch.cat(preds, dim=1), torch.cat(confs, dim=1)

    def frames(self, tokens, h: int, w: int):
        b, s = tokens[0].shape[:2]
        rows, cols = h // self.cfg.patch_size, w // self.cfg.patch_size
        feats = []
        for t, project, resize in zip(tokens, self.projects, self.resize_layers):
            x = self.norm(t.reshape(b * s, rows * cols, -1))
            x = x.permute(0, 2, 1).reshape(b * s, -1, rows, cols)
            x = project(x)
            x = x + 0.1 * uv_embed(x.shape[1], rows, cols, w / h, x.device)[None]
            feats.append(resize(x))
        sc = self.scratch
        l1, l2, l3, l4 = sc.layer1_rn(feats[0]), sc.layer2_rn(feats[1]), \
            sc.layer3_rn(feats[2]), sc.layer4_rn(feats[3])
        out = sc.refinenet4(l4, size=l3.shape[2:])
        out = sc.refinenet3(out, l3, size=l2.shape[2:])
        out = sc.refinenet2(out, l2, size=l1.shape[2:])
        out = sc.refinenet1(out, l1)
        out = sc.output_conv1(out)
        out = F.interpolate(out, size=(h, w), mode="bilinear", align_corners=True)
        out = out + 0.1 * uv_embed(out.shape[1], h, w, w / h, out.device)[None]
        out = sc.output_conv2(out).permute(0, 2, 3, 1)
        x, conf = out[..., :-1], out[..., -1]
        if self.activation == "exp":
            x = torch.exp(x)
        else:
            x = torch.sign(x) * torch.expm1(torch.abs(x))
        return x.reshape(b, s, h, w, -1), (1 + torch.exp(conf)).reshape(b, s, h, w)


# ---- the model ----------------------------------------------------------------------


class VGGT(nn.Module):
    """The stages the check follows one by one: `pairs` (frames to the
    hooked pairs' tokens and the last pair's), `poses` (the camera head's
    passes from the last pair), `maps` (the DPT heads from the hooked
    pairs); `forward` chains them."""

    def __init__(self, cfg: VGGTCfg = VGGTCfg()):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = DPTHead(cfg, 2, "exp")
        self.point_head = DPTHead(cfg, 4, "inv_log")

    def pairs(self, images) -> dict:
        cfg = self.cfg
        with fp32():
            mean = torch.tensor(MEAN, device=images.device)
            std = torch.tensor(STD, device=images.device)
            return self.aggregator((images.float() - mean) / std, {*cfg.hooks, cfg.depth - 1})

    def poses(self, last) -> list[torch.Tensor]:
        with fp32():
            return self.camera_head(last[:, :, 0].float())

    def maps(self, tokens, h: int, w: int) -> dict:
        start = 1 + self.cfg.num_register_tokens
        tokens = [t.float() for t in tokens]
        with fp32():
            depth, depth_conf = self.depth_head(tokens, start, h, w)
            points, points_conf = self.point_head(tokens, start, h, w)
        return {"depth": depth, "depth_conf": depth_conf, "points": points,
                "points_conf": points_conf}

    def forward(self, images) -> dict:
        cfg = self.cfg
        h, w = images.shape[2:4]
        pairs = self.pairs(images)
        tokens = [pairs[i] for i in cfg.hooks]
        return {"tokens": tokens, "poses": self.poses(pairs[cfg.depth - 1]),
                **self.maps(tokens, h, w)}
