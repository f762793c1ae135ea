"""The port's meshes over several processes, on the CPU with gloo.

  * `main` in two processes on `configs/smoke.yaml` (one device a
    process; a (2, 1) world mesh, and a (1, 2) one with the `pallas`
    decoder): both ranks hold the same parameters after every step, each
    trained on the examples of its own loader shard (its host-local
    batch), and step 1 equals one process stepping on the same global
    rows;
  * `render(..., mesh=)` on a world mesh of two processes, one shard each,
    in the three sharded pipelines: the image and every gradient bit-equal
    to the same mesh in one process (itself held to JAX's sharded render by
    tests/test_torch_parallel.py); a (1, 2) mesh per pipeline and a (2, 1)
    mesh where each rank renders only its own data row;
  * `initialize_multihost` with no arguments reads a torchrun-style
    environment (the render workers start that way).

The workers are subprocesses; this module imports no JAX, so they can
import it.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pf3plat_tpu_torch.ops.rasterizer import RasterizeConfig, render
from pf3plat_tpu_torch.parallel import MeshCfg, initialize_multihost, make_mesh, shard_batch
from pf3plat_tpu_torch.parallel.mesh import local_devices, world_device_count

from test_torch_helpers import make_scene_np, one_thread, t  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

# The pipelines of tests/test_torch_parallel.py's MESH_CASES on the same
# scene, with the mesh shape each runs on here.
_BLOCKS = dict(pairs_budget_factor=0.0, compact_window=512, compact_min_pairs=0)
_SHARD_LOCAL = dict(pairs_budget_factor=1.0, compact_window=512, compact_min_pairs=0)
RENDER_CASES = {
    "streamed-blocks": ("streamed", _BLOCKS, (1, 2)),
    "streamed-shard-local": ("streamed", _SHARD_LOCAL, (1, 2)),
    "pallas": ("pallas", dict(chunk=64), (1, 2)),
    "streamed-shard-local-data-rows": ("streamed", _SHARD_LOCAL, (2, 1)),
}
DIFFERENTIABLE = ("means", "covariances", "sh", "opacities", "background")


def render_rows(case: str, mesh) -> dict:
    """The two-camera scene of test_torch_parallel's mesh tests through
    `render(..., mesh=mesh)`: the image and d(input) of every differentiable
    input, for the cameras (data rows) this process holds."""
    impl, kw, _ = RENDER_CASES[case]
    config = RasterizeConfig(**{**dict(tile_size=16, tile_capacity=256, chunk=128), **kw})
    scene = make_scene_np(np.random.default_rng(4), n=64, b=2)
    leaves = shard_batch(mesh, {k: t(v) for k, v in scene.items()})
    for k in DIFFERENTIABLE:
        leaves[k].requires_grad_(True)
    img = render(**leaves, image_shape=(32, 32), impl=impl, config=config, device="cpu",
                 mesh=mesh)
    (img**2).sum().backward()
    return {"image": img.detach(), **{k: leaves[k].grad for k in DIFFERENTIABLE}}


RENDER_WORKER = textwrap.dedent(
    """
    import sys
    out, repo, tests = sys.argv[1:4]
    sys.path[:0] = [repo, tests]
    import torch
    torch.set_num_threads(1)
    from pf3plat_tpu_torch.parallel import MeshCfg, initialize_multihost, make_mesh
    from pf3plat_tpu_torch.parallel.mesh import local_devices, world_device_count
    from test_torch_multiproc import RENDER_CASES, render_rows

    initialize_multihost()  # RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT
    rank = torch.distributed.get_rank()
    assert world_device_count(local_devices("cpu")) == 2  # one CPU a process
    results = {}
    for case, (_, _, shape) in RENDER_CASES.items():
        mesh = make_mesh(MeshCfg(*shape), device="cpu")
        results[case] = dict(render_rows(case, mesh), local_shards=list(mesh.local_shards),
                             row_shards=list(mesh.row_shards))
    torch.save(results, f"{out}/render{rank}.pt")
    torch.distributed.destroy_process_group()
    """
)

MAIN_WORKER = textwrap.dedent(
    """
    import sys
    rank, coord, out, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    argv = sys.argv[5:]
    sys.path.insert(0, repo)
    import torch
    torch.set_num_threads(1)
    from pf3plat_tpu_torch import main as tmain
    from pf3plat_tpu_torch.parallel import initialize_multihost
    from pf3plat_tpu_torch.training import train as ttrain

    initialize_multihost(coordinator=coord, num_processes=2, process_id=rank)
    make_step = ttrain.make_model_train_step

    def recording(*args, **kwargs):  # run_train looks it up when it runs
        step = make_step(*args, **kwargs)

        def wrapped(state, batch, **kw):
            if state.step == 0:
                torch.save(batch, f"{out}/batch{rank}.pt")
            state, aux = step(state, batch, **kw)
            torch.save([p.detach().clone() for p in state.params],
                       f"{out}/params{rank}_{state.step}.pt")
            return state, aux
        return wrapped

    ttrain.make_model_train_step = recording
    tmain.main(argv, device="cpu")
    torch.distributed.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(script: Path, args, env=None, timeout: int = 120) -> None:
    """Two worker processes; fails with their output if one fails."""
    procs = [subprocess.Popen([sys.executable, str(script), *a], env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a, e in zip(args, env or [None, None])]
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    finally:
        for p in procs:  # leave no worker behind if one timed out
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def world_renders(tmp_path_factory):
    """Every case of RENDER_CASES rendered by two gloo processes started
    from a torchrun-style environment."""
    out = tmp_path_factory.mktemp("renders")
    script = out / "render_worker.py"
    script.write_text(RENDER_WORKER)
    port = str(_free_port())
    env = [dict(os.environ, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="localhost",
                MASTER_PORT=port) for r in range(2)]
    _run_workers(script, [[str(out), str(REPO), str(TESTS)]] * 2, env)
    return [torch.load(out / f"render{r}.pt", weights_only=True) for r in range(2)]


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_world_mesh_render_equals_one_process_mesh(world_renders, case, one_thread):
    """Each rank runs only its own shard; the image and every gradient of
    the cameras it holds equal the one-process mesh's bit for bit (the
    exchanges are broadcasts, the sums are taken in shard order)."""
    shape = RENDER_CASES[case][2]
    ref = render_rows(case, make_mesh(MeshCfg(*shape), device="cpu"))
    assert float(ref["means"].abs().max()) > 0
    for rank, got in enumerate(world_renders):
        got = got[case]
        assert got["local_shards"] == [rank]
        # (1, 2): both ranks hold the one data row; (2, 1): rank r holds row r
        rows = slice(None) if shape[0] == 1 else slice(rank, rank + 1)
        assert got["row_shards"] == ([0, 1] if shape[0] == 1 else [rank])
        for name in ("image", *DIFFERENTIABLE):
            assert torch.equal(got[name], ref[name][rows]), (rank, name)


def test_initialize_multihost_reads_a_torchrun_environment(monkeypatch):
    """No arguments and no environment: nothing (one process). A
    torchrun-style environment: the process group of that world, on gloo
    without a card; `main` then builds no mesh for a world of one."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    initialize_multihost()
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        initialize_multihost()
        assert dist.is_initialized()
        assert (dist.get_rank(), dist.get_world_size(), dist.get_backend()) == (0, 1, "gloo")
        initialize_multihost()  # kept, not made twice
        assert world_device_count(local_devices("cpu")) == 1
        mesh = make_mesh(MeshCfg(data_axis=1, tile_axis=2), device="cpu")
        assert mesh.owners == (0, 0) and list(mesh.row_shards) == [0, 1]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# main's world mesh by its overrides: (2, 1) = one example a rank, each its
# own data row; (1, 2) = the one example on both ranks, its render's tile
# rows split between them (`pallas`: the table exchanges in training).
MAIN_CASES = {
    "data-2x1": ("data_loader.batch_size=2",),
    "tile-1x2": ("data_loader.batch_size=1", "train.tile_axis=2", 'decoder.impl="pallas"'),
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_in_two_processes_trains_one_model(tmp_path, case, one_thread):
    """`main` in two gloo processes with one device each builds a mesh over
    both: the ranks hold the same parameters bit for bit after both steps;
    on (2, 1) rank r loaded one example, the first of its own loader shard
    r of 2 (its host-local batch: the global batch of 2 is one example a
    data row), on (1, 2) both ranks the first of the one loader shard;
    step 1's loss and gradient norm, as rank 0 logs them, are within 1e-5
    of one process stepping on the same rows with the same generator; the
    log is written once."""
    from pf3plat_tpu_torch import main as tmain
    from pf3plat_tpu_torch.training.train import init_train_state, make_model_train_step
    from pf3plat_tpu_torch.utils.config import load_config

    from test_data import make_chunk

    (tmp_path / "data" / "train").mkdir(parents=True)
    for c in range(2):  # one chunk for each rank's loader shard
        make_chunk(tmp_path / "data" / "train" / f"{c:06}.torch", n_scenes=2, n_frames=20,
                   seed=c)
    argv = [str(REPO / "configs" / "smoke.yaml"), f'dataset.roots=["{tmp_path / "data"}"]',
            f'checkpointing.directory="{tmp_path / "ckpt"}"', f'output_dir="{tmp_path / "logs"}"',
            f'test.output_path="{tmp_path / "out" / "test"}"', *MAIN_CASES[case],
            "max_steps=2", "train.sanity_validation=false", "train.val_check_interval=100",
            "data_loader.num_workers=1",
            # targets strictly between the context views: every example has
            # v = 3, so the two ranks' rows stack into one batch
            "view_sampler.min_distance_to_context_views=1"]
    script = tmp_path / "main_worker.py"
    script.write_text(MAIN_WORKER)
    coord = f"localhost:{_free_port()}"
    _run_workers(script, [[str(r), coord, str(tmp_path), str(REPO), *argv] for r in range(2)])

    for step in (1, 2):
        p0, p1 = (torch.load(tmp_path / f"params{r}_{step}.pt", weights_only=True)
                  for r in range(2))
        assert all(torch.equal(a, b) for a, b in zip(p0, p1)), f"ranks differ after step {step}"

    cfg = load_config(Path(argv[0]), argv[1:])
    by_rows = cfg.data_loader.batch_size == 2
    batches = [torch.load(tmp_path / f"batch{r}.pt", weights_only=True) for r in range(2)]
    firsts = []
    for r, got in enumerate(batches):
        it = tmain.batch_iterator(cfg, "train", r if by_rows else 0, 2 if by_rows else 1,
                                  lambda: 0, batch_size=1)
        first = next(it)
        it.close()
        firsts.append(first["context"]["image"])
        assert got["context"]["image"].shape[0] == 1
        assert torch.equal(got["context"]["image"], torch.from_numpy(first["context"]["image"]))
    # (2, 1): the two loader shards hold different examples
    assert by_rows != bool(np.array_equal(firsts[0], firsts[1]))

    rows = (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()
    logged = [json.loads(r) for r in rows]
    assert [r["step"] for r in logged] == [1, 2] and logged[0]["world_size"] == 2

    held = batches if by_rows else batches[:1]
    glob = {part: {k: torch.cat([b[part][k] for b in held]) for k in held[0][part]}
            for part in ("context", "target")}
    torch.manual_seed(cfg.seed)
    model = tmain.build_model(cfg, "cpu")
    step = make_model_train_step(model, cfg.loss, cfg.optimizer)
    _, aux = step(init_train_state(model), glob,
                  generator=tmain.step_generator(cfg.seed, 0, "cpu"))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(logged[0][key], float(aux[key]), rtol=1e-5, err_msg=key)
