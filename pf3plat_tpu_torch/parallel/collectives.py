"""The rasterizer's exchanges between the shards of a mesh, in shard order.

A process runs only the shards it owns (`Mesh.local_shards`). Its batch
rows split evenly over the shards of the data rows it holds
(`Mesh.row_shards`); where some of those belong to other ranks of its tile
group, their outputs come from those ranks. Every sum over shards is taken
after the exchange, on every rank, in shard order, so a render over several
processes gives the same bits as the same mesh in one process (an NCCL
`all_reduce` would sum in its own order).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def shard_rows(rows: int, mesh) -> list:
    """This process's shards as (shard, first row, end row, device) over its
    `rows` (batch * tile) rows, which split evenly over `mesh.row_shards`
    (every shard of the mesh with one process)."""
    shards = mesh.row_shards
    if rows % len(shards):
        raise ValueError(f"{rows} tile rows not divisible by mesh size {len(shards)}")
    rps = rows // len(shards)
    return [(k, (k - shards.start) * rps, (k - shards.start + 1) * rps, mesh.device(k))
            for k in mesh.local_shards]


def mesh_batch(b: int, mesh) -> int:
    """The cameras of the whole mesh when this process renders `b` of them:
    its rows are `len(mesh.row_shards)` of the mesh's shards. Sizes that
    the JAX package takes from the global batch use it."""
    return b * mesh.size // len(mesh.row_shards)


def _pack(tensors) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, like) -> list:
    out, offset = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        # the clone starts the slice at an aligned address for the view
        out.append(buf[offset:offset + nbytes].clone().view(t.dtype).view(t.shape))
        offset += nbytes
    return out


def gather_in_shard_order(outputs: dict, mesh) -> list:
    """Every row shard's outputs, in shard order, on this process's first
    device: a list with one list of tensors per shard of `mesh.row_shards`.

    `outputs` maps each shard this process ran (`shard_rows`) to its list of
    tensors. The shards of other ranks of the tile group come from them, one
    broadcast per shard from its owner in shard order (NCCL and gloo both
    take CUDA tensors in a broadcast); each arrives with the shapes and
    dtypes of this process's own outputs. With one process this only moves
    the outputs to the first device."""
    home = mesh.home
    like = next(iter(outputs.values()))
    shared = len(mesh.tile_ranks) > 1
    gathered = []
    for k in mesh.row_shards:
        mine = k in outputs
        tensors = [t.to(home) for t in outputs[k]] if mine else None
        if shared:
            if mine:
                buf = _pack(tensors)
            else:
                nbytes = sum(t.numel() * t.element_size() for t in like)
                buf = torch.empty(nbytes, dtype=torch.uint8, device=home)
            dist.broadcast(buf, src=mesh.owner(k), group=mesh.groups["tile"])
            if not mine:
                tensors = _unpack(buf, like)
        gathered.append(tensors)
    return gathered
