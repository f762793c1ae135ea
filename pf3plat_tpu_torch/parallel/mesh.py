"""Device mesh and sharding for multi-shard rendering and training.

Port of `pf3plat_tpu/parallel/mesh.py`. The JAX package builds one global
`(data, tile)` mesh over the devices of every process and lets XLA insert
the collectives. The port names the same grid: shard k = data index * tile
size + tile index, owned by rank k // (shards per rank) and placed on that
rank's local device k % (shards per rank), JAX's device order (processes
first, then local ids).

  * One process (the default) owns every shard. With `devices=None` every
    shard lives on the one device the caller names and the shards run one
    after another (no threads, no side streams): every sharded code path
    and kernel runs on a single card, with no speed-up.
  * Several processes (`initialize_multihost`, one a card or a host): each runs
    only the shards it owns. Two process groups follow from the mesh: the
    tile group (the ranks that share a data index: the rasterizer's
    exchanges, `collectives.py`) and the data group (the ranks that hold the
    same tile shards of other data rows: the gradient all-reduce).
  * Parameters are replicated, the batch belongs to the `data` axis (a
    process loads the examples of its data rows, `Mesh.loader_shard`;
    `shard_batch` keeps them from a global batch), and a process's (batch *
    tile) rows split over the shards of its data rows (`ops/rasterizer`:
    `mesh=` of `render`).
"""

from __future__ import annotations

import dataclasses
import math
import os
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
    tile size + tile index. `devices`: the devices of the shards this
    process owns, in shard order; `owners`: the rank owning each shard;
    `tile_ranks` / `data_ranks`: the ranks of this process's tile and data
    groups, whose process groups (where they hold more than one rank) are
    `groups["tile"]` / `groups["data"]`."""

    shape: dict
    devices: tuple
    owners: tuple
    rank: int = 0
    tile_ranks: tuple = (0,)
    data_ranks: tuple = (0,)
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def axis_names(self) -> tuple:
        return AXIS_NAMES

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def home(self) -> torch.device:
        """This process's first device: where its replicated tensors live."""
        return self.devices[0]

    @property
    def local_shards(self) -> range:
        """The shards this process owns."""
        first = self.owners.index(self.rank)
        return range(first, first + len(self.devices))

    @property
    def row_shards(self) -> range:
        """The shards over which this process's batch rows split: every
        shard of the data rows it holds (all shards with one process)."""
        tile = self.shape["tile"]
        own = self.local_shards
        return range(own.start // tile * tile, -(-own.stop // tile) * tile)

    @property
    def data_rows(self) -> range:
        """The data indices this process holds (all with one process)."""
        tile = self.shape["tile"]
        return range(self.row_shards.start // tile, self.row_shards.stop // tile)

    @property
    def loader_shard(self) -> tuple[int, int]:
        """(index, count) of this process's part of the data: the ranks of
        one tile group load the same examples."""
        rows = len(self.data_rows)
        return self.data_rows.start // rows, self.shape["data"] // rows

    def owner(self, shard: int) -> int:
        return self.owners[shard]

    def device(self, shard: int) -> torch.device:
        return self.devices[shard - self.local_shards.start]


def _world() -> tuple[int, int]:
    """(rank, world size) of torch.distributed when it is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_devices(device: str | torch.device | None = None) -> list:
    """This process's devices: the CPU alone off the card; on the card, the
    one `device` names or, for plain `cuda`, the card `LOCAL_RANK` chose
    (torchrun's layout, one process a card) or, without it, every visible
    card (one process a host, JAX's layout)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    if "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def world_device_count(local: Sequence) -> int:
    """The world's devices (JAX's `len(jax.devices())`): each rank's
    `local` devices, summed over the ranks."""
    world = _world()[1]
    if world == 1:
        return len(local)
    counts = [None] * world
    dist.all_gather_object(counts, len(local))
    return sum(counts)


def make_mesh(cfg: MeshCfg = MeshCfg(), devices: Optional[Sequence] = None,
              device: str | torch.device | None = None) -> Mesh:
    """A mesh over the world: with `torch.distributed` initialised every
    rank calls this, else the one process owns every shard.

    `devices` are this process's own devices (default: `device` alone, on
    the card its current one): one a shard it owns, or one that runs all its
    shards one after another (no threads, no side streams). `data_axis=-1`
    takes the world's devices not used by the tile axis, at least one data
    row. Each rank owns size / world consecutive shards, which lie in one
    data row or hold whole data rows. The tile and data process groups of
    more than one rank are created here, by every rank in the same order."""
    rank, world = _world()
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devices = [dev]
    local = tuple(torch.device(d) for d in devices)
    tile = cfg.tile_axis
    data = max(1, world * len(local) // tile) if cfg.data_axis == -1 else cfg.data_axis
    n = data * tile
    per = n // world
    if per == 0 or per * world != n:
        raise ValueError(f"a mesh of {n} shards cannot span {world} processes")
    if tile % per and per % tile:
        raise ValueError(f"{per} shards a process neither lie in one data row of "
                         f"{tile} nor hold whole data rows")
    assert len(local) in (1, per), (
        f"{len(local) * world} devices cannot form mesh ({data}, {tile})"
    )
    owners = tuple(k // per for k in range(n))
    block = max(per, tile)  # the shards of one tile group
    tile_sets = [tuple(sorted(set(owners[lo:lo + block]))) for lo in range(0, n, block)]
    data_sets = [tuple(g[i] for g in tile_sets) for i in range(len(tile_sets[0]))]
    groups, mine = {}, {}
    for kind, sets in (("tile", tile_sets), ("data", data_sets)):
        for ranks in sets:
            # every rank creates every group, in the same order
            group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                mine[kind], groups[kind] = ranks, group
    return Mesh({"data": data, "tile": tile}, local if len(local) == per else local * per,
                owners, rank, mine["tile"], mine["data"], groups)


def initialize_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Multi-process setup (call before `make_mesh`; a process group that
    exists already is kept).

    The world comes from the arguments (`coordinator` "host:port", the world
    size and this process's rank) or, with none given, from a torchrun-style
    environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`), the
    counterpart of JAX's cluster auto-detection; without either it does
    nothing (one process). `LOCAL_RANK`, where set, chooses the card.
    `backend`: `nccl` with a card (one card a rank), `gloo` without; ranks
    that share one card pass `gloo` themselves (NCCL refuses two ranks on
    one card). Nothing falls back to another backend after a failure."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator is None and num_processes is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if "LOCAL_RANK" in env and torch.cuda.is_available():
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id,
    )


def broadcast_from_rank0(value):
    """`value` as rank 0 has it, on every rank (a decision taken once for
    all ranks); the value itself with one process."""
    if _world()[1] == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """Put a global batch (the rows of the whole mesh) on this process's
    first device, keeping the rows of the data indices it holds: one process
    holds every data row, so the batch stays whole; over several processes a
    rank holding data rows [d0, d1) keeps rows [d0 * per, d1 * per), per =
    batch / data axis. (`main` loads only its rows, JAX's host-local batch,
    and does not call this for them.)"""
    n_data, rows = mesh.shape["data"], mesh.data_rows

    def put(x):
        if not isinstance(x, torch.Tensor):
            return x
        if len(rows) != n_data and x.dim() >= 1:
            if x.shape[0] % n_data:
                raise ValueError(f"batch axis {x.shape[0]} not divisible by the data "
                                 f"axis {n_data}")
            per = x.shape[0] // n_data
            x = x[rows.start * per:rows.stop * per]
        return x.to(mesh.home)

    return _tree_map(put, batch)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Replicate a tree of tensors (parameters, optimizer state): one copy
    on this process's first device; the same tensor comes back when it
    already lives there, so in-place updates stay visible to the caller."""
    return _tree_map(lambda x: x.to(mesh.home) if isinstance(x, torch.Tensor) else x, tree)


def _flat_collective(tensors, fn) -> None:
    """Apply `fn` in place to the tensors flattened into one buffer."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    fn(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_mean(tensors, mesh: Mesh) -> None:
    """Average tensors over the mesh's data group, in place: one all-reduce
    of the flattened set, divided by the group's size (averaging over the
    whole world would give other bits where tile ranks hold equal values).
    Nothing to do for a group of one."""
    n = len(mesh.data_ranks)
    if n == 1:
        return

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.groups["data"])
        flat /= n

    _flat_collective(tensors, mean)


def sync_gradients(grads, mesh: Mesh) -> None:
    """The data-parallel gradient sync: the mean over the data group, then
    the tile group's first rank's values on all its ranks (tile ranks
    compute the same gradients, but a card need not sum them in the same
    order twice, and their parameters must stay equal)."""
    all_reduce_mean(grads, mesh)
    if len(mesh.tile_ranks) > 1:
        _flat_collective(grads, lambda flat: dist.broadcast(
            flat, src=mesh.tile_ranks[0], group=mesh.groups["tile"]))


def shard_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """The train step for execution on the mesh. The mesh itself reaches the
    renders through `make_model_train_step(..., mesh=mesh)`, as in the JAX
    package. One process: the step is returned as it is (the global batch is
    whole, so it equals the single-device step). Several processes: the
    step is called with `grad_sync`, which `sync_gradients` the gradients
    before the optimizer update (the data-parallel all-reduce)."""
    if len(mesh.data_ranks) == len(mesh.tile_ranks) == 1:
        return train_step

    def step(state, batch, *args, **kwargs):
        return train_step(state, batch, *args,
                          grad_sync=lambda grads: sync_gradients(grads, mesh), **kwargs)

    return step
