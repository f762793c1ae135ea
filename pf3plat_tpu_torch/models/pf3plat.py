"""PF3plat model: frozen perception + matcher + encoder + splat decoder.

Port of `pf3plat_tpu/models/pf3plat.py` (`perceive`, `forward`; LPIPS and
parameter init by example batch are not ported in this slice). `PF3plat`
is an `nn.Module` placed on `device` (default `cuda`; without a GPU it
raises unless `device="cpu"`). `forward` is the serving path: images in,
poses, Gaussians and rendered views out, under `torch.no_grad()`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from .backbones.lightglue import LightGlue
from .backbones.matching import match_context_views
from .backbones.superpoint import SuperPoint
from .backbones.unidepth import UniDepth, UniDepthCfg
from .decoder import DecoderCfg, decode
from .encoder import Correspondences, EncoderCfg, EncoderOutput, FrozenInputs, PoseFreeEncoder
from .types import DecoderOutput


@dataclasses.dataclass(frozen=True)
class PF3platCfg:
    encoder: EncoderCfg = EncoderCfg()
    decoder: DecoderCfg = DecoderCfg()
    unidepth: UniDepthCfg = UniDepthCfg()
    max_keypoints: int = 1024
    max_matches: int = 512
    lightglue_layers: int = 9
    # Precision of the frozen perception stage. "bfloat16": on the card it
    # runs under torch.autocast(bfloat16) (the JAX package's one-pass bf16
    # matmuls); "highest": full float32. The CPU always runs float32.
    frozen_matmul_precision: str = "bfloat16"


class PF3plat(nn.Module):
    def __init__(self, cfg: PF3platCfg, device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.encoder = PoseFreeEncoder(cfg.encoder)
        self.unidepth = UniDepth(cfg.unidepth)
        self.superpoint = SuperPoint(max_num_keypoints=cfg.max_keypoints)
        self.lightglue = LightGlue(n_layers=cfg.lightglue_layers)
        self.to(self.device)
        self.eval()

    def _frozen_precision(self):
        if self.device.type == "cuda" and self.cfg.frozen_matmul_precision == "bfloat16":
            return torch.autocast("cuda", dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def perceive(self, images: torch.Tensor, intrinsics: torch.Tensor
                 ) -> tuple[FrozenInputs, Correspondences]:
        """Frozen stage: monocular depth + features + correspondences."""
        b, v, h, w, _ = images.shape
        with self._frozen_precision():
            out = self.unidepth(images.reshape(b * v, h, w, 3), intrinsics.reshape(b * v, 3, 3))
            corr = match_context_views(self.superpoint, self.lightglue, images,
                                       max_matches=self.cfg.max_matches)
        depth = out.depth.float().reshape(b, v, h, w)
        feats = out.features.float()
        feats = feats.reshape(b, v, *feats.shape[1:])
        corr = Correspondences(corr.kpts0.float(), corr.kpts1.float(),
                               corr.scores.float(), corr.valid)
        return FrozenInputs(depth=depth, features=feats), corr

    @torch.no_grad()
    def forward(
        self,
        images: torch.Tensor,       # (b, v, h, w, 3) context stack
        intrinsics: torch.Tensor,   # (b, v, 3, 3) normalized
        near: torch.Tensor,         # (b, v)
        far: torch.Tensor,          # (b, v)
        global_step: int = 0,
        render_views: bool = True,
        depth_mode=None,
        ransac_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        timer=None,
    ) -> tuple[EncoderOutput, Optional[DecoderOutput]]:
        """`timer`, if given, is called with a stage name ("perceive",
        "encoder", "decoder") as each stage ends."""
        images, intrinsics, near, far = (
            t.to(self.device, torch.float32) for t in (images, intrinsics, near, far))
        h, w = images.shape[2:4]
        frozen, corr = self.perceive(images, intrinsics)
        if timer:
            timer("perceive")
        enc = self.encoder(images, intrinsics, near, far, frozen, corr, global_step,
                           ransac_noise=ransac_noise, generator=generator)
        if timer:
            timer("encoder")
        out = None
        if render_views:
            c2w = torch.linalg.inv(enc.refined_poses)
            out = decode(self.cfg.decoder, enc.gaussians, c2w, intrinsics, near, far,
                         (h, w), depth_mode=depth_mode)
            if timer:
                timer("decoder")
        return enc, out
