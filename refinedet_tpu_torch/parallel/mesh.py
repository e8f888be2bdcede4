"""What the JAX package's ``data`` and ``("data", "space")`` meshes mean
when each device is a process of its own.

Port of ``refinedet_tpu/parallel/mesh.py``. There a ``jax.sharding.Mesh``
lays the batch over the devices (``P("data")``), replicates the state
(``P()``), and XLA SPMD inserts the gradient all-reduce. Here each rank
holds its contiguous rows of the global batch (``shard_batch``) and its
own copy of the state, made equal by a broadcast from rank 0
(``replicate``) and kept equal by the all-reduced gradients
(``train/train_step.py``, ``DistributedDataParallel``).

With ``--spatial_shards S`` the W ranks form the JAX package's
``("data", "space")`` mesh of shape ``(W // S, S)`` (``make_grid``): rank
r sits at data index ``r // S`` and space index ``r % S``, holds its data
group's rows of the batch and, of each image, the band of rows
``image_band`` gives it (``image_sharding``'s ``P("data", "space")``).
The halo exchanges XLA SPMD inserted are ``parallel/spatial.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn


def shard_batch(batch, rank: int, world: int):
    """The rank's contiguous rows ``[rank * per, (rank + 1) * per)``, per =
    rows // world, of a tensor or array, or of each field of a tuple
    (a ``NamedTuple`` keeps its type). Every field needs the same number
    of rows, a multiple of ``world``."""
    def rows(x):
        n = x.shape[0]
        if n % world:
            raise ValueError(f"{n} rows do not divide over {world} ranks")
        per = n // world
        return x[rank * per:(rank + 1) * per]

    if isinstance(batch, tuple):
        parts = [rows(x) for x in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") \
            else tuple(parts)
    return rows(batch)


def replicate(tree: Union[nn.Module, Iterable[torch.Tensor]],
              group: Optional[dist.ProcessGroup] = None) -> None:
    """Make every rank's copy equal to rank 0's, in place: a module's
    parameters and buffers, or the given tensors (in the same order on
    every rank)."""
    if isinstance(tree, nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = list(tree)
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def check_grid(world: int, shards: int,
               batch_size: Optional[int] = None) -> None:
    """Raise the JAX Trainer's errors for a grid of ``world`` ranks with
    ``shards`` space shards (below 1 counts as 1, as there), and a global
    batch that does not divide over its ``world // shards`` data-parallel
    ranks."""
    shards = max(1, shards)
    if world % shards:
        raise ValueError(f"{world} devices not divisible by "
                         f"spatial_shards={shards}")
    data = world // shards
    if batch_size is not None and batch_size % data:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"{data} data-parallel devices")


def grid_position(rank: int, shards: int) -> Tuple[int, int]:
    """(data index, space index) of ``rank``: the row-major place of the
    JAX package's ``devices.reshape(W // S, S)``."""
    return rank // shards, rank % shards


def band(height: int, index: int, shards: int) -> Tuple[int, int]:
    """Rows ``[index * height / shards, (index + 1) * height / shards)``
    of a height that splits evenly."""
    if height % shards:
        raise ValueError(f"{height} rows do not split into {shards} bands")
    per = height // shards
    return index * per, (index + 1) * per


def image_band(images, index: int, shards: int):
    """The space rank ``index``'s rows of NHWC images (the counterpart of
    ``image_sharding``'s ``P("data", "space")`` on this rank's rows)."""
    start, stop = band(images.shape[1], index, shards)
    return images[:, start:stop]


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a ``(data, space)`` grid of ranks, and its
    groups: ``group`` holds every rank of the grid, ``data_group`` the
    ranks of this space index (one per data index), ``space_group`` the
    ranks of this data index (one per space index, in band order)."""

    group: dist.ProcessGroup
    shards: int
    data_index: int
    space_index: int
    data_size: int
    data_group: dist.ProcessGroup
    space_group: dist.ProcessGroup


def make_grid(shards: int, group: Optional[dist.ProcessGroup] = None
              ) -> Grid:
    """The ``(W // shards, shards)`` grid over the ranks of ``group``
    (the default group when None; W ranks, none without a process
    group). Every rank must call it, in the same order as its other
    group creations: each rank creates every data and space group."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    check_grid(world, shards)
    ranks = dist.get_process_group_ranks(group)
    data_index, space_index = grid_position(dist.get_rank(group), shards)
    rows = world // shards
    data_groups = [dist.new_group([ranks[d * shards + k]
                                   for d in range(rows)])
                   for k in range(shards)]
    space_groups = [dist.new_group([ranks[d * shards + k]
                                    for k in range(shards)])
                    for d in range(rows)]
    return Grid(group, shards, data_index, space_index, rows,
                data_groups[space_index], space_groups[data_index])
