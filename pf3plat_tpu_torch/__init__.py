"""PyTorch + CUDA port of pf3plat_tpu for one NVIDIA H100.

The JAX package `pf3plat_tpu` stays the reference; this package mirrors its
layout (`geometry/`, `ops/rasterizer/`, `models/`, `models/backbones/`) and
public layouts (channel-last images, normalized intrinsics, c2w/w2c exactly
where the JAX functions use them). It imports torch, numpy and scipy only.

Entry points (`models.pf3plat.PF3plat`, `ops.rasterizer.render`) run on
`cuda` by default and raise without a GPU unless `device="cpu"` is passed.
"""
