"""Tile-binned rasterizer in plain PyTorch under autograd: the `tiled`
backend.

Port of `pf3plat_tpu/ops/rasterizer/tiled.py`. Composites the dense per-tile
gaussian tables of `binning.bin_gaussians` chunk by chunk with the cumsum
formulation of `compositing.py`. It launches no hand-written kernel: it is
the plain reference path of the binned backends, and the backend
`configs/smoke.yaml` selects. Across chunks T carries the product of the
alive gaussians' factors, so a pixel that saturates inside one chunk
composites again from the next chunk on: the chunk reset of the `streamed`
and `pallas` kernels, where the brute-force oracle (one chunk over all
gaussians) stops for good. Gradients reach every gaussian attribute through
the feature gather.
"""

from __future__ import annotations

import torch

from ...models.remat import remat
from .binning import BinnedTiles
from .compositing import composite_chunk, gaussian_alpha
from .types import RasterizeConfig, ScreenGaussians


def pack_features(screen: ScreenGaussians) -> torch.Tensor:
    """Per-gaussian feature rows [x, y, conic(3), color(c), opacity]."""
    return torch.cat(
        [screen.xy, screen.conic, screen.color, screen.opacity[..., None]], dim=-1
    )


def tile_pixel_coords(tiles_x: int, num_tiles: int, ts: int, dtype, device=None):
    """Pixel-center coordinates for each tile: (tiles, ts*ts) px, py."""
    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=device)
    tx = tile_ids % tiles_x
    ty = tile_ids // tiles_x
    local = torch.arange(ts * ts, dtype=torch.int32, device=device)
    px = (tx[:, None] * ts + (local % ts)[None, :]).to(dtype) + 0.5
    py = (ty[:, None] * ts + (local // ts)[None, :]).to(dtype) + 0.5
    return px, py


def composite_tables(
    gathered: torch.Tensor,    # (tiles, cap, f) gathered features
    slot_valid: torch.Tensor,  # (tiles, cap) bool
    px: torch.Tensor,          # (tiles, p) pixel x coords
    py: torch.Tensor,          # (tiles, p)
    background: torch.Tensor,  # (c,)
    channels: int,
    config: RasterizeConfig,
) -> torch.Tensor:
    """Composite dense tile tables chunk by chunk -> (tiles, p, c)."""
    num_tiles, cap, _ = gathered.shape
    chunk = config.chunk
    if cap % chunk:
        raise ValueError("tile_capacity must be divisible by chunk")

    def body(t_carry, accum, data, valid):
        alpha = gaussian_alpha(
            px, py, data[..., 0:2], data[..., 2:5], data[..., 5 + channels], valid, config
        )
        return composite_chunk(alpha, data[..., 5 : 5 + channels], t_carry, accum, config)

    t_carry = gathered.new_ones((num_tiles, px.shape[-1]))
    accum = gathered.new_zeros((num_tiles, px.shape[-1], channels))
    for i in range(cap // chunk):
        t_carry, accum = remat(body, t_carry, accum, gathered[:, i * chunk : (i + 1) * chunk],
                               slot_valid[:, i * chunk : (i + 1) * chunk])
    return accum + t_carry[..., None] * background[None, None, :]


def composite_tiles(
    screen: ScreenGaussians,
    binned: BinnedTiles,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (c,)
    config: RasterizeConfig,
) -> torch.Tensor:
    """Single-camera compositing over binned tiles -> (h, w, c) image."""
    h, w = image_shape
    ts = config.tile_size
    tiles_x, tiles_y = binned.num_tiles_x, binned.num_tiles_y
    num_tiles = tiles_x * tiles_y
    channels = screen.color.shape[-1]

    # Culled gaussians never enter a table but may carry inf/NaN from the
    # projection; zero them so the gather's backward meets no inf * 0.
    visible = (screen.valid & (screen.radius > 0))[..., None]
    feat = pack_features(screen)
    feat = torch.where(visible, feat, torch.zeros_like(feat))
    slot_valid = binned.indices >= 0
    gathered = feat[torch.clamp(binned.indices, min=0).to(torch.int64)]  # (tiles, cap, f)
    px, py = tile_pixel_coords(tiles_x, num_tiles, ts, feat.dtype, feat.device)

    out = composite_tables(gathered, slot_valid, px, py, background, channels, config)
    out = out.reshape(tiles_y, tiles_x, ts, ts, channels)
    out = out.permute(0, 2, 1, 3, 4).reshape(tiles_y * ts, tiles_x * ts, channels)
    return out[:h, :w]
