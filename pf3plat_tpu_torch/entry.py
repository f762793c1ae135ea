"""Entry points: a forward check of the small model and a multi-shard dry
run of one training step.

Port of the JAX package's `__graft_entry__.py`. `entry()` returns a forward
step on the flagship model (the full PF3plat pipeline: frozen perception,
matcher, pose-free encoder, splatting decoder) at reduced dimensions, plus
example arguments. `dryrun_multichip(n)` builds an n-shard `(data, tile)`
mesh and runs ONE full training step (encoder forward, render, photometric
and pose loss, backward, Adam update) through it: the decoder's streamed
rasterizer splits its (batch * view * tile) rows over both mesh axes, and
the scene is large enough to engage the shard-local pipeline
(`ops/rasterizer/shard_local.py`). Both run on the card unless
`device="cpu"`, under the declared precision policy
(`precision.apply_policy`).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.backbones.unidepth import UniDepthCfg
from .models.decoder import DecoderCfg
from .models.encoder import EncoderCfg
from .models.gaussian_adapter import GaussianAdapterCfg
from .models.pf3plat import PF3plat, PF3platCfg
from .ops.rasterizer import RasterizeConfig
from .parallel import MeshCfg, make_mesh, replicate, shard_batch, shard_train_step
from .precision import apply_policy
from .training.losses import LossCfg, total_loss


def small_model(impl: str = "streamed", device=None) -> PF3plat:
    """The dry run's model: every stage present, every width reduced;
    weights drawn from seed 0."""
    cfg = PF3platCfg(
        encoder=EncoderCfg(
            d_feature=32, d_backbone=128, num_depth_candidates=16,
            multiview_trans_attn_split=2, n_attn_layers=2, d_pose=32,
            ransac_samples=32,
            gaussian_adapter=GaussianAdapterCfg(sh_degree=1),
            costvolume_unet_feat_dim=16,
            costvolume_unet_channel_mult=(1, 1),
            costvolume_unet_attn_res=(2,), depth_unet_feat_dim=8,
            depth_unet_attn_res=(4,), depth_unet_channel_mult=(1, 1, 1),
        ),
        decoder=DecoderCfg(
            impl=impl,
            # The production pair-compaction factor: under a multi-shard
            # mesh the dry run's scene has at least `compact_min_pairs`
            # candidates, so it takes the shard-local pipeline.
            raster=RasterizeConfig(tile_capacity=256, chunk=128, pairs_budget_factor=0.48),
        ),
        unidepth=UniDepthCfg.tiny_test(),
        max_keypoints=64, max_matches=32, lightglue_layers=2,
    )
    torch.manual_seed(0)
    return PF3plat(cfg, device=device)


def example_inputs(b: int, v: int, h: int, w: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(rng.uniform(0, 1, (b, v, h, w, 3)).astype(np.float32))
    intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]).expand(b, v, 3, 3)
    near = torch.ones((b, v))
    far = torch.full((b, v), 100.0)
    return images, intr.contiguous(), near, far


def entry(device=None):
    """Returns (fn, example_args): the full model's forward render."""
    h = w = 56  # a multiple of the ViT patch (14); the raster tiles (16) pad
    model = small_model(device=device)
    apply_policy(model.device)
    args = example_inputs(1, 2, h, w)
    gen = torch.Generator(device=model.device).manual_seed(1)

    def fn(images, intr, near, far):
        with torch.no_grad():
            _, out = model(images, intr, near, far, 0, generator=gen)
        return out.color

    return fn, args


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Run one sharded full-model training step on an n-shard mesh
    (`tile_axis = 2` for even n, `b = n`, `v = 2`, 56x56) and return its
    loss; raises if the loss is not finite."""
    h = w = 56
    tile_axis = 2 if n_devices % 2 == 0 else 1
    b, v = n_devices, 2
    model = small_model(impl="streamed", device=device)
    apply_policy(model.device)
    images, intr, near, far = example_inputs(b, v, h, w)
    mesh = make_mesh(MeshCfg(data_axis=n_devices // tile_axis, tile_axis=tile_axis),
                     device=model.device)
    params = replicate(mesh, list(model.encoder.parameters()))
    opt = torch.optim.Adam(params, lr=1e-4)
    gen = torch.Generator(device=model.device).manual_seed(2)

    def train_step(state, batch, grad_sync=None):
        opt.zero_grad(set_to_none=True)
        enc, out = model(batch["images"], batch["intr"], batch["near"], batch["far"], 0,
                         generator=gen, mesh=mesh)
        loss, _ = total_loss(LossCfg(ssim_weight=0.0), out.color, batch["images"], enc,
                             batch["intr"], 0)
        loss.backward()
        if grad_sync is not None:
            grad_sync([p.grad for p in state if p.grad is not None])
        opt.step()
        return state, loss.detach()

    batch = shard_batch(mesh, {"images": images, "intr": intr, "near": near, "far": far})
    step = shard_train_step(train_step, mesh)
    _, loss = step(params, batch)
    loss = float(loss)
    assert np.isfinite(loss), f"loss not finite: {loss}"
    return loss
