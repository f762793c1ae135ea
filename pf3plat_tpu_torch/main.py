"""CLI entry point: `python -m pf3plat_tpu_torch.main [config.yaml] key=value ...`.

Port of `pf3plat_tpu/main.py` (the reference's `src/main.py:37-155`: typed
config, model + data pipeline, the training loop with checkpoints, periodic
logging and validation artifacts, and the evaluation protocol). Runs on the
card unless the caller asks otherwise (`main(argv, device="cpu")`), under
the declared precision policy (`precision.apply_policy`).

Modes:
  mode=train   train on chunk datasets under dataset.roots
  mode=test    run the evaluation protocol over the test split
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .utils.profiling import span

# `run_validation`'s step offset for its random draws, the JAX package's
# fold_in(rng, 2**30 + step).
VALIDATION_STREAM = 2**30


def model_config(cfg):
    """The `PF3platCfg` of a config tree's model sections."""
    from .models.backbones.unidepth import UniDepthCfg
    from .models.pf3plat import PF3platCfg

    unidepth = (
        UniDepthCfg.tiny_test() if cfg.model.tiny_backbones else UniDepthCfg()
    )
    return PF3platCfg(
        encoder=cfg.encoder,
        decoder=cfg.decoder,
        unidepth=unidepth,
        max_keypoints=cfg.model.max_keypoints,
        max_matches=cfg.model.max_matches,
        lightglue_layers=cfg.model.lightglue_layers,
        frozen_matmul_precision=cfg.model.frozen_matmul_precision,
    )


@dataclasses.dataclass(frozen=True)
class Architecture:
    """What the entry points do with one `model.architecture`: `build(cfg,
    device)` makes the model from its config sections; `train_step(cfg,
    model, mesh)` makes its train step (None: the model is served through
    its forward alone, and `mode=train` and `mode=test` refuse it);
    `validates`: training renders the validation panels (they read PF3plat's
    encoder outputs)."""
    build: Callable
    train_step: Optional[Callable]
    validates: bool


def _build_pf3plat(cfg, device):
    from .models.pf3plat import PF3plat

    return PF3plat(model_config(cfg), device=device)


def _build_noposplat(cfg, device):
    from .models.noposplat import NoPoSplat

    return NoPoSplat(cfg.noposplat, cfg.decoder, device=device)


def _build_vggt(cfg, device):
    from .models.vggt import VGGT

    return VGGT(cfg.vggt, device=device)


def _pf3plat_step(cfg, model, mesh):
    from .training.train import make_model_train_step

    return make_model_train_step(model, cfg.loss, cfg.optimizer, mesh=mesh)


def _noposplat_step(cfg, model, mesh):
    from .training.train import make_noposplat_train_step

    if mesh is not None:
        raise ValueError("model.architecture=noposplat trains on one device")
    return make_noposplat_train_step(model, cfg.loss, cfg.optimizer)


# PF3plat from the `model` and `encoder` sections, NoPoSplat from `noposplat`
# (both render with `decoder`), VGGT from `vggt`
ARCHITECTURES = {
    "pf3plat": Architecture(_build_pf3plat, _pf3plat_step, validates=True),
    "noposplat": Architecture(_build_noposplat, _noposplat_step, validates=False),
    "vggt": Architecture(_build_vggt, None, validates=False),
}


def architecture(cfg) -> Architecture:
    """The entry of `model.architecture` in `ARCHITECTURES`."""
    name = cfg.model.architecture
    if name not in ARCHITECTURES:
        raise ValueError(f"model.architecture: {name!r} is none of {tuple(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def build_model(cfg, device=None):
    """The model `model.architecture` names."""
    return architecture(cfg).build(cfg, device)


def trained(cfg) -> Architecture:
    """`architecture(cfg)`, refused where it has no train step."""
    arch = architecture(cfg)
    if arch.train_step is None:
        raise ValueError(f"model.architecture={cfg.model.architecture} is served through its "
                         "forward alone: it has no train step, nor checkpoints to test")
    return arch


def train_step_for(cfg, model, mesh=None):
    """The train step of the model's architecture."""
    return trained(cfg).train_step(cfg, model, mesh)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s random draws (the RANSAC noise): seeded
    from (seed, step) alone, as the JAX loop's fold_in(PRNGKey(seed), step),
    so a resumed run draws the same noise at a given step."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def batch_iterator(cfg, stage, host_id, num_hosts, get_step, batch_size=None):
    """Yield fixed-shape numpy batches, grouping examples by view count;
    `batch_size` examples a training batch (default
    `data_loader.batch_size`), one at test.

    JPEG decode runs on a background thread pool (`data/prefetch.py`) —
    the reference's multi-worker DataLoader equivalent
    (`src/dataset/data_module.py:90-110`). Waiting on the pipeline for
    each example is the span `pf3.data.wait`, stacking a batch
    `pf3.data.collate`; neither stays open across a `yield`.
    """
    from .data.dataset import ChunkDataset, batch_examples
    from .data.prefetch import ExamplePipeline
    from .data.view_samplers import (
        AllViewSampler,
        BoundedViewSampler,
        EvaluationViewSampler,
    )

    if stage == "test" and cfg.test.sampler == "all":
        # Trajectory-video evaluation: every (subsampled) frame is context
        # and target (reference `view_sampler_all.py`).
        sampler = AllViewSampler(max_views=cfg.test.all_sampler_max_views)
    elif cfg.evaluation_index is not None and stage == "test":
        sampler = EvaluationViewSampler(cfg.evaluation_index)
    else:
        sampler = BoundedViewSampler(cfg.view_sampler, stage=stage)
    ds = ChunkDataset(
        cfg.dataset, sampler, stage=stage, host_id=host_id,
        num_hosts=num_hosts, seed=cfg.data_loader.seed,
    )
    pipeline = ExamplePipeline(
        ds, get_step,
        num_workers=cfg.data_loader.num_workers,
        prefetch=cfg.data_loader.prefetch,
    )
    target_bs = (batch_size or cfg.data_loader.batch_size) if stage == "train" else 1
    pending: dict[int, list] = {}
    try:
        while True:
            produced = False
            examples = iter(pipeline)
            while True:
                with span("pf3.data.wait"):
                    ex = next(examples, None)
                if ex is None:
                    break
                produced = True
                v = ex["context"]["image"].shape[0]
                pending.setdefault(v, []).append(ex)
                if len(pending[v]) == target_bs:
                    with span("pf3.data.collate"):
                        batch = batch_examples(pending.pop(v))
                    yield batch
            if stage != "train" or not produced:
                return
    finally:
        pipeline.close()


def run_train(cfg, device=None) -> None:
    from .device import resolve_device
    from .parallel import (
        MeshCfg,
        broadcast_from_rank0,
        initialize_multihost,
        make_mesh,
        shard_batch,
        shard_train_step,
    )
    from .parallel.mesh import _world, all_reduce_mean, local_devices, world_device_count
    from .training.checkpoints import CheckpointManager, frozen_state, load_frozen_state
    from .training.train import init_train_state
    from .utils.logging import LocalLogger

    arch = trained(cfg)
    initialize_multihost()  # from a torchrun-style environment, where there is one
    dev = resolve_device(device)
    rank, world = _world()
    tile = max(1, cfg.train.tile_axis)
    # The world's devices, as the JAX main's len(jax.devices()): each
    # rank's own (one CPU a process off the card), summed over the ranks.
    local = local_devices(dev)
    n_dev = world_device_count(local)
    n_data = max(1, min(n_dev // tile, cfg.data_loader.batch_size))
    batch_size, mesh = cfg.data_loader.batch_size, None
    if world > 1 or n_data * tile > 1:
        # one shard per device where there are enough, else all on the first
        per = n_data * tile // world
        mesh = make_mesh(MeshCfg(data_axis=n_data, tile_axis=tile),
                         devices=local[:per] if per <= len(local) else local[:1])
        if batch_size % n_data:
            raise ValueError(f"batch size {batch_size} not divisible by the data axis {n_data}")
        # this process loads the examples of its data rows (JAX's host-local
        # batch); the ranks of one tile group load the same ones
        batch_size = batch_size // n_data * len(mesh.data_rows)
    host_id, num_hosts = (0, 1) if mesh is None else mesh.loader_shard
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"mesh: data={n_data} tile={tile} hosts={world}", flush=True)

    step_holder = {"step": 0}
    batches = batch_iterator(
        cfg, "train", host_id, num_hosts, lambda: step_holder["step"], batch_size
    )
    first = next(batches)

    log("initializing model...", flush=True)
    torch.manual_seed(cfg.seed)
    model = build_model(cfg, dev)
    state = init_train_state(model)
    log(f"model initialized: {cfg.model.architecture}, "
        f"{sum(p.numel() for p in state.params)} trainable parameters", flush=True)
    if cfg.weights is not None:
        from .training.pretrained import load_pretrained_frozen

        load_pretrained_frozen(cfg.weights, model)

    # rank 0 writes, every rank restores
    ckpt = CheckpointManager(cfg.checkpointing, writer=rank == 0)
    # restore_latest may warm-start from checkpointing.load, which also
    # carries that run's frozen/ dir — so resolve state BEFORE deciding
    # whether frozen weights exist.
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
        log(f"resumed from step {int(state.step)}")
    had_frozen = ckpt.has_frozen()
    ckpt.save_frozen(frozen_state(model))
    # decided once, by the writer, after its write
    had_frozen = broadcast_from_rank0(had_frozen)
    if had_frozen:
        # Resume must reuse the run's frozen perception weights (converted
        # or first-init), not a fresh re-init — otherwise a resumed run
        # silently trains against different frozen features.
        load_frozen_state(model, ckpt.restore_frozen())

    step_fn = train_step_for(cfg, model, mesh=mesh)
    if mesh is not None:
        step_fn = shard_train_step(step_fn, mesh)

    def to_device(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    def to_batch(raw):
        b = {
            "context": {
                k: to_device(v) for k, v in raw["context"].items() if k != "index"
            },
            "target": {"image": to_device(raw["target"]["image"])},
        }
        return b  # with a mesh: this process's rows, already on its device

    def next_batch():
        nonlocal batches
        try:
            return to_batch(next(batches))
        except StopIteration:
            batches = batch_iterator(
                cfg, "train", host_id, num_hosts, lambda: step_holder["step"], batch_size
            )
            return to_batch(next(batches))

    # Scalar stream (the reference's wandb.log equivalent): one JSONL row
    # per log step under the run directory, written by rank 0.
    log_dir = cfg.output_dir or Path(cfg.test.output_path).parent / "logs"
    logger = LocalLogger(log_dir) if rank == 0 else None

    def step_kwargs(step: int, batch) -> dict:
        gen = step_generator(cfg.seed, step, dev)
        if mesh is None:
            return dict(generator=gen)
        # the host batch's RANSAC draws, this rank's rows of them
        views = batch["context"]["image"].shape[1]
        return dict(generator=gen, ransac_noise=shard_batch(
            mesh, model.ransac_noise(cfg.data_loader.batch_size, views, gen)))

    # The step counter lives on the host; batch N+1 is decoded by the data
    # workers while step N runs and moved to the device from pinned memory.
    t0 = time.time()
    batch = to_batch(first)
    step = int(state.step)
    validate = rank == 0 and arch.validates
    if cfg.train.sanity_validation and step == 0 and validate:
        # Reference `num_sanity_val_steps` — fail fast on broken
        # visualization/render paths before hours of training.
        run_validation(cfg, model, batch, step_generator(cfg.seed, VALIDATION_STREAM, dev),
                       step)
    while step < cfg.max_steps:
        state, aux = step_fn(state, batch, **step_kwargs(step, batch))
        step += 1
        step_holder["step"] = step
        if step < cfg.max_steps:
            batch = next_batch()
        if step % cfg.train.print_log_every_n_steps == 0:
            scalars = {k: v for k, v in aux.items() if v.dim() == 0}
            values = torch.stack([v.float() for v in scalars.values()])
            if mesh is not None:
                # the global batch's values, as the JAX step reports them
                all_reduce_mean([values], mesh)
            a = dict(zip(scalars, values.tolist()))  # one transfer
            dt = time.time() - t0
            t0 = time.time()
            parts = " ".join(
                f"{k}={v:.5f}" for k, v in sorted(a.items())
                if k not in ("loss", "psnr", "mse")
            )
            log(
                f"step {step}: loss={a['loss']:.5f} psnr={a['psnr']:.2f} "
                f"mse={a['mse']:.5f} {parts} {dt:.2f}s",
                flush=True,
            )
            if logger is not None:
                logger.log_scalars(step, a | {"seconds": dt, "world_size": world})
        if step % cfg.train.val_check_interval == 0 and validate:
            run_validation(cfg, model, batch,
                           step_generator(cfg.seed, VALIDATION_STREAM + step, dev), step)
        final = step >= cfg.max_steps
        if step % cfg.checkpointing.every_n_steps == 0 or final:
            # an off-interval last step must be forced, or short runs end
            # checkpoint-less
            ckpt.maybe_save(state, force=final)
    if logger is not None:
        logger.close()


def run_validation(cfg, model, batch, generator, step) -> None:
    """Periodic holdout visualization — the reference's rank-0
    `validation_step` (`src/model/model_wrapper.py:416-596`): render the
    current batch's first example, save GT/pred comparison + depth panels,
    the encoder's internals and a wobble trajectory video under the run
    directory.
    """
    from .models.decoder import decode
    from .visualization.encoder_vis import encoder_internals_panels
    from .visualization.layout import save_video
    from .visualization.trajectories import generate_wobble
    from .visualization.validation import comparison_panel

    def host(x: torch.Tensor) -> np.ndarray:
        return x.detach().float().cpu().numpy()

    out_dir = Path(cfg.test.output_path).parent / "validation" / f"step_{step:07}"
    try:
        ctx = batch["context"]
        images, intr, near, far = (ctx[k][:1] for k in ("image", "intrinsics", "near", "far"))
        with torch.no_grad():
            enc, out = model(images, intr, near, far, step, generator=generator)
            comparison_panel(
                host(images[0]),
                host(batch["target"]["image"][:1][0]),
                host(out.color[0]),
                depth=host(enc.depths[0]),
                path=out_dir / "comparison.png",
            )
            encoder_internals_panels(host(images[0]), enc, out_dir)
            c2w = torch.linalg.inv(enc.refined_poses)[0]
            t = torch.linspace(0.0, 1.0, 24, device=c2w.device)
            delta = 0.25 * torch.linalg.norm(c2w[-1, :3, 3] - c2w[0, :3, 3]) + 1e-3
            traj = generate_wobble(c2w[0], delta, t)[None]
            f = traj.shape[1]
            vid = decode(
                model.cfg.decoder, enc.gaussians, traj,
                intr[:, :1].expand(1, f, 3, 3).to(traj),
                near[:, :1].expand(1, f).to(traj),
                far[:, :1].expand(1, f).to(traj),
                tuple(cfg.dataset.image_shape),
            )
        save_video([host(fr) for fr in vid.color[0]], out_dir / "wobble.mp4")
        print(f"validation artifacts -> {out_dir}", flush=True)
    except Exception as e:  # validation must never kill training
        print(f"validation at step {step} failed: {e}", flush=True)


def run_test(cfg, device=None) -> None:
    """The evaluation protocol over the test split: the model from
    `cfg.seed`, converted frozen weights (`weights=`) and the latest
    checkpoint of `checkpointing.directory` (with its `frozen/`), then one
    `Evaluator.run_example` per streamed batch."""
    from .device import resolve_device
    from .evaluation.evaluator import EvalCfg, Evaluator
    from .training.checkpoints import CheckpointManager, load_frozen_state
    from .training.train import init_train_state

    trained(cfg)
    dev = resolve_device(device)
    batches = batch_iterator(cfg, "test", 0, 1, lambda: 0)
    first = next(batches)
    torch.manual_seed(cfg.seed)
    model = build_model(cfg, dev)
    if cfg.weights is not None:
        from .training.pretrained import load_pretrained_frozen

        load_pretrained_frozen(cfg.weights, model)

    ckpt = CheckpointManager(cfg.checkpointing)
    state = ckpt.restore_latest(init_train_state(model))
    if state is not None:
        load_frozen_state(model, ckpt.restore_frozen())
        print(f"loaded checkpoint at step {int(state.step)}")

    evaluator = Evaluator(
        EvalCfg(
            output_path=Path(cfg.test.output_path),
            eval_time_skip_steps=cfg.test.eval_time_skip_steps,
            save_image=cfg.test.save_image,
            compute_scores=cfg.test.compute_scores,
            save_video=cfg.test.save_video,
            video_frames=cfg.test.video_frames,
            depth_mode=cfg.test.depth_mode,
        ),
        model, dev, lpips_apply=model.lpips_apply,
    )
    # Stream examples — materializing the whole split up front would hold
    # the full test set (tens of GB on real RE10K) in host memory.
    for idx, raw in enumerate(itertools.chain([first], batches)):
        rec = evaluator.run_example(raw, step_generator(cfg.seed, idx, dev), idx)
        print(f"[{idx}] {rec}", flush=True)
    print(json.dumps(evaluator.finalize(), indent=2))


def main(argv=None, device=None) -> None:
    from .device import resolve_device
    from .precision import apply_policy
    from .utils.config import load_config

    argv = list(sys.argv[1:] if argv is None else argv)
    yaml_path = None
    if argv and argv[0].endswith((".yaml", ".yml")):
        yaml_path = Path(argv.pop(0))
    cfg = load_config(yaml_path, argv)
    apply_policy(resolve_device(device))

    if cfg.mode == "train":
        run_train(cfg, device)
    elif cfg.mode == "test":
        run_test(cfg, device)
    else:
        raise ValueError(f"unknown mode {cfg.mode}")


if __name__ == "__main__":
    main()
