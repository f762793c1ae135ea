"""PF3plat model: frozen perception + matcher + encoder + splat decoder.

Port of `pf3plat_tpu/models/pf3plat.py` (`perceive`, `forward`,
`lpips_apply`; parameter init by example batch is not ported). `PF3plat`
is an `nn.Module` placed on `device` (default `cuda`; without a GPU it
raises unless `device="cpu"`). `forward` serves (callers wrap it in
`torch.no_grad()`) and trains: `perceive` always runs without gradients
(the JAX package's stop-gradients, `pf3plat.py:117-125`), so gradients
reach only the encoder. The frozen modules (UniDepth, SuperPoint,
LightGlue, the LPIPS VGG) never require gradients.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..utils.profiling import count, span, stage, tracing
from .backbones.lightglue import LightGlue
from .backbones.matching import match_context_views
from .backbones.superpoint import SuperPoint
from .backbones.unidepth import UniDepth, UniDepthCfg
from .backbones.vgg_lpips import LPIPS
from .decoder import DecoderCfg, decode
from .remat import remat
from ..geometry.procrustes import gumbel_noise
from .encoder import (
    Correspondences, EncoderCfg, EncoderOutput, FrozenInputs, PoseFreeEncoder, view_pairs)
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
        self.lpips = LPIPS()
        for frozen in (self.unidepth, self.superpoint, self.lightglue, self.lpips):
            frozen.requires_grad_(False)
        self.to(self.device)
        self.eval()

    def trainable_parameters(self) -> list[nn.Parameter]:
        """The encoder's parameters: perception and LPIPS stay frozen."""
        return list(self.encoder.parameters())

    def _frozen_precision(self):
        if self.device.type == "cuda" and self.cfg.frozen_matmul_precision == "bfloat16":
            return torch.autocast("cuda", dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def perceive(self, images: torch.Tensor, intrinsics: torch.Tensor
                 ) -> tuple[FrozenInputs, Correspondences]:
        """Frozen stage: monocular depth + features + correspondences."""
        b, v, h, w, _ = images.shape
        with torch.no_grad(), self._frozen_precision():
            with span("pf3.perceive.unidepth"):
                out = self.unidepth(images.reshape(b * v, h, w, 3),
                                    intrinsics.reshape(b * v, 3, 3))
            corr = match_context_views(self.superpoint, self.lightglue, images,
                                       max_matches=self.cfg.max_matches)
        if tracing():
            count("matches.valid", corr.valid.sum())
            count("matches.slots", corr.valid.numel())
        depth = out.depth.float().reshape(b, v, h, w)
        feats = out.features.float()
        feats = feats.reshape(b, v, *feats.shape[1:])
        corr = Correspondences(corr.kpts0.float(), corr.kpts1.float(),
                               corr.scores.float(), corr.valid)
        return FrozenInputs(depth=depth, features=feats), corr

    def lpips_apply(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """Frozen LPIPS distance (b, h, w, 3) x2 -> (b,); the gradient flows
        to the images, not to the VGG (`pf3plat.py:128-138`). Its VGG
        feature pyramid is recomputed in the backward, not held across the
        step."""
        return remat(self.lpips, img0, img1)

    def ransac_noise(self, b: int, v: int, generator: torch.Generator) -> torch.Tensor:
        """The encoder's RANSAC draws for `b` stacks of `v` views, as
        `forward` draws them from `generator` when it is given none: a
        caller that holds some rows of a larger batch draws the whole batch's
        and passes its own rows, as the JAX package's per-example keys split
        from the global batch do."""
        shape = (b, len(view_pairs(v)[0]), self.cfg.encoder.ransac_samples,
                 self.cfg.max_matches)
        return gumbel_noise(shape, generator, self.device, torch.float32)

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
        mesh=None,
    ) -> tuple[EncoderOutput, Optional[DecoderOutput]]:
        """`timer`, if given, is called with a stage name ("perceive",
        "encoder", "decoder") as each stage ends (`utils.profiling.stage`).
        `mesh` (`parallel.Mesh`) is handed to the decoder's renders."""
        with span("pf3.forward"):
            count("forwards", 1)
            images, intrinsics, near, far = (
                t.to(self.device, torch.float32) for t in (images, intrinsics, near, far))
            h, w = images.shape[2:4]
            with stage("perceive", timer):
                frozen, corr = self.perceive(images, intrinsics)
            with stage("encoder", timer):
                enc = self.encoder(images, intrinsics, near, far, frozen, corr, global_step,
                                   ransac_noise=ransac_noise, generator=generator)
            out = None
            if render_views:
                with stage("decoder", timer):
                    c2w = torch.linalg.inv(enc.refined_poses)
                    out = decode(self.cfg.decoder, enc.gaussians, c2w, intrinsics, near, far,
                                 (h, w), depth_mode=depth_mode, mesh=mesh)
        return enc, out
