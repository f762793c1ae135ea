"""Device mesh and sharding for multi-shard rendering and training.

Port of `pf3plat_tpu/parallel/mesh.py`. The JAX package builds one global
`(data, tile)` mesh and lets one controller program drive all its shards
(`shard_map`, XLA-inserted all-reduces). The port keeps that model: `Mesh`
names one `torch.device` per shard, ONE process drives every shard, a
shard's work runs on its device, and the results are brought to the first
device and merged in shard order, so every sum has a fixed order. The shard
count is a parameter of the mesh, not of the machine: with `devices=None`
every shard lives on the one device the caller names, and the shards run one
after another (no threads, no side streams). That exercises every sharded
code path and kernel on a single card; it shows no speed-up.

  * parameters are replicated, the batch belongs to the `data` axis, the
    rasterizer's (batch * tile) rows are split over ALL axes
    (`ops/rasterizer`: `mesh=` of `render`);
  * with one process the global batch stays whole: the sharded train step
    equals the single-device step, as JAX's SPMD step does;
  * several processes (`initialize_multihost`, one per host or per card):
    `shard_batch` gives each rank its slice of the batch and
    `shard_train_step` averages the gradients with one all-reduce before the
    optimizer update. Tile sharding across processes is not implemented.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

AXIS_NAMES = ("data", "tile")


@dataclasses.dataclass(frozen=True)
class MeshCfg:
    data_axis: int = -1   # -1: all shards not taken by the tile axis
    tile_axis: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, tile) grid of shards, row-major: shard k = data index *
    tile size + tile index lives on `devices[k]`."""

    shape: dict
    devices: tuple

    @property
    def axis_names(self) -> tuple:
        return AXIS_NAMES

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(cfg: MeshCfg = MeshCfg(), devices: Optional[Sequence] = None,
              device: str | torch.device | None = None) -> Mesh:
    """`devices`: one device per shard (shard k on `devices[k]`). With
    `devices=None` the shard count comes from `cfg` (`data_axis=-1` then
    means one data row) and every shard lives on `device` (default `cuda`)."""
    if devices is None:
        n = max(cfg.data_axis, 1) * cfg.tile_axis
        devices = [resolve_device(device)] * n
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    data = n // cfg.tile_axis if cfg.data_axis == -1 else cfg.data_axis
    assert data * cfg.tile_axis == n, (
        f"{n} devices cannot form mesh ({data}, {cfg.tile_axis})"
    )
    return Mesh({"data": data, "tile": cfg.tile_axis}, devices)


def initialize_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-process setup (call once per process before `shard_batch`).

    `coordinator` "host:port", the world size and this process's rank are
    given explicitly; the backend is `nccl` with a GPU, else `gloo`. With
    no arguments (a single process) it does nothing."""
    if coordinator is None and num_processes is None:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id,
    )


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """Put a batch on the mesh's first device. One process: the batch stays
    whole (its `data` shards run in the one program). Several processes:
    each keeps its contiguous slice of the leading axis."""
    rank, world = _world()
    dev = mesh.devices[0]

    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        if world > 1 and x.dim() >= 1:
            if x.shape[0] % world:
                raise ValueError(f"batch axis {x.shape[0]} not divisible by {world} processes")
            per = x.shape[0] // world
            x = x[rank * per:(rank + 1) * per]
        return x.to(dev)

    return _tree_map(put, batch)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Replicate a tree of tensors (parameters, optimizer state): with one
    controller that is one copy on the mesh's first device; the same tensor
    comes back when it already lives there, so in-place updates stay
    visible to the caller."""
    dev = mesh.devices[0]
    return _tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)


def all_reduce_mean(tensors) -> None:
    """Average tensors over the processes, in place (one all-reduce of the
    flattened set); nothing to do for a single process."""
    _, world = _world()
    if world == 1:
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= world
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def shard_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """The train step for execution on the mesh. The mesh itself reaches the
    renders through `make_model_train_step(..., mesh=mesh)`, as in the JAX
    package. One process: the step is returned as it is (the global batch is
    whole, so it equals the single-device step). Several processes: the
    step is called with `grad_sync=all_reduce_mean`, which it applies to the
    gradients before the optimizer update (the data-parallel all-reduce)."""
    if _world()[1] == 1:
        return train_step

    def step(state, batch, *args, **kwargs):
        return train_step(state, batch, *args, grad_sync=all_reduce_mean, **kwargs)

    return step
