"""CLI entry point: `python -m pf3plat_tpu_torch.main [config.yaml] key=value ...`.

Port of `pf3plat_tpu/main.py` (the reference's `src/main.py:37-155`: typed
config, model + data pipeline, the training loop with checkpoints, periodic
logging and validation artifacts, and the evaluation protocol). Runs on the
card unless the caller asks otherwise (`main(argv, device="cpu")`).

Modes:
  mode=train   train on chunk datasets under dataset.roots
  mode=test    run the evaluation protocol over the test split
"""

from __future__ import annotations

import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

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


def build_model(cfg, device=None):
    from .models.pf3plat import PF3plat

    return PF3plat(model_config(cfg), device=device)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s random draws (the RANSAC noise): seeded
    from (seed, step) alone, as the JAX loop's fold_in(PRNGKey(seed), step),
    so a resumed run draws the same noise at a given step."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def batch_iterator(cfg, stage, host_id, num_hosts, get_step):
    """Yield fixed-shape numpy batches, grouping examples by view count.

    JPEG decode runs on a background thread pool (`data/prefetch.py`) —
    the reference's multi-worker DataLoader equivalent
    (`src/dataset/data_module.py:90-110`).
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
    target_bs = cfg.data_loader.batch_size if stage == "train" else 1
    pending: dict[int, list] = {}
    try:
        while True:
            produced = False
            for ex in pipeline:
                produced = True
                v = ex["context"]["image"].shape[0]
                pending.setdefault(v, []).append(ex)
                if len(pending[v]) == target_bs:
                    yield batch_examples(pending.pop(v))
            if stage != "train" or not produced:
                return
    finally:
        pipeline.close()


def _world() -> tuple[int, int]:
    """(rank, world size) of torch.distributed when it is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_train(cfg, device=None) -> None:
    from .device import resolve_device
    from .parallel import MeshCfg, make_mesh, shard_batch, shard_train_step
    from .training.checkpoints import CheckpointManager, frozen_state, load_frozen_state
    from .training.train import init_train_state, make_model_train_step
    from .utils.logging import LocalLogger

    dev = resolve_device(device)
    tile = max(1, cfg.train.tile_axis)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_data = max(1, min(n_dev // tile, cfg.data_loader.batch_size))
    mesh = None
    if n_data * tile > 1:
        # one shard per card where there are enough, else every shard on `dev`
        devices = ([torch.device("cuda", i) for i in range(n_data * tile)]
                   if n_dev >= n_data * tile else None)
        mesh = make_mesh(MeshCfg(data_axis=n_data, tile_axis=tile), devices=devices,
                         device=dev)
    host_id, num_hosts = _world()
    print(f"mesh: data={n_data} tile={tile} hosts={num_hosts}", flush=True)

    step_holder = {"step": 0}
    batches = batch_iterator(
        cfg, "train", host_id, num_hosts, lambda: step_holder["step"]
    )
    first = next(batches)

    print("initializing model...", flush=True)
    torch.manual_seed(cfg.seed)
    model = build_model(cfg, dev)
    print("model initialized", flush=True)
    if cfg.weights is not None:
        from .training.pretrained import load_pretrained_frozen

        load_pretrained_frozen(cfg.weights, model)

    state = init_train_state(model)
    ckpt = CheckpointManager(cfg.checkpointing)
    # restore_latest may warm-start from checkpointing.load, which also
    # carries that run's frozen/ dir — so resolve state BEFORE deciding
    # whether frozen weights exist.
    restored = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
        print(f"resumed from step {int(state.step)}")
    had_frozen = ckpt.has_frozen()
    ckpt.save_frozen(frozen_state(model))
    if had_frozen:
        # Resume must reuse the run's frozen perception weights (converted
        # or first-init), not a fresh re-init — otherwise a resumed run
        # silently trains against different frozen features.
        load_frozen_state(model, ckpt.restore_frozen())

    step_fn = make_model_train_step(model, cfg.loss, cfg.optimizer, mesh=mesh)
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
        return b if mesh is None else shard_batch(mesh, b)

    def next_batch():
        nonlocal batches
        try:
            return to_batch(next(batches))
        except StopIteration:
            batches = batch_iterator(
                cfg, "train", host_id, num_hosts, lambda: step_holder["step"]
            )
            return to_batch(next(batches))

    # Scalar stream (the reference's wandb.log equivalent): one JSONL row
    # per log step under the run directory.
    log_dir = cfg.output_dir or Path(cfg.test.output_path).parent / "logs"
    logger = LocalLogger(log_dir)

    # The step counter lives on the host; batch N+1 is decoded by the data
    # workers while step N runs and moved to the device from pinned memory.
    t0 = time.time()
    batch = to_batch(first)
    step = int(state.step)
    if cfg.train.sanity_validation and step == 0:
        # Reference `num_sanity_val_steps` — fail fast on broken
        # visualization/render paths before hours of training.
        run_validation(cfg, model, batch, step_generator(cfg.seed, VALIDATION_STREAM, dev),
                       step)
    while step < cfg.max_steps:
        state, aux = step_fn(state, batch, generator=step_generator(cfg.seed, step, dev))
        step += 1
        step_holder["step"] = step
        if step < cfg.max_steps:
            batch = next_batch()
        if step % cfg.train.print_log_every_n_steps == 0:
            scalars = {k: v for k, v in aux.items() if v.dim() == 0}
            a = dict(zip(scalars, torch.stack(
                [v.float() for v in scalars.values()]).tolist()))  # one transfer
            dt = time.time() - t0
            t0 = time.time()
            parts = " ".join(
                f"{k}={v:.5f}" for k, v in sorted(a.items())
                if k not in ("loss", "psnr", "mse")
            )
            print(
                f"step {step}: loss={a['loss']:.5f} psnr={a['psnr']:.2f} "
                f"mse={a['mse']:.5f} {parts} {dt:.2f}s",
                flush=True,
            )
            logger.log_scalars(step, a | {"seconds": dt})
        if step % cfg.train.val_check_interval == 0:
            run_validation(cfg, model, batch,
                           step_generator(cfg.seed, VALIDATION_STREAM + step, dev), step)
        final = step >= cfg.max_steps
        if step % cfg.checkpointing.every_n_steps == 0 or final:
            # an off-interval last step must be forced, or short runs end
            # checkpoint-less
            ckpt.maybe_save(state, force=final)
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
    from .utils.config import load_config

    argv = list(sys.argv[1:] if argv is None else argv)
    yaml_path = None
    if argv and argv[0].endswith((".yaml", ".yml")):
        yaml_path = Path(argv.pop(0))
    cfg = load_config(yaml_path, argv)

    if cfg.mode == "train":
        run_train(cfg, device)
    elif cfg.mode == "test":
        run_test(cfg, device)
    else:
        raise ValueError(f"unknown mode {cfg.mode}")


if __name__ == "__main__":
    main()
