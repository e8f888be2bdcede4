"""What the JAX package's 1-D ``data`` mesh means when each device is a
process of its own.

Port of ``refinedet_tpu/parallel/mesh.py``. There a ``jax.sharding.Mesh``
lays the batch over the devices (``P("data")``), replicates the state
(``P()``), and XLA SPMD inserts the gradient all-reduce. Here each rank
holds its contiguous rows of the global batch (``shard_batch``) and its
own copy of the state, made equal by a broadcast from rank 0
(``replicate``) and kept equal by the all-reduced gradients
(``train/train_step.py``, ``DistributedDataParallel``).

``image_sharding`` and the ``space`` axis belong to ``--spatial_shards``
(the image height over devices, with conv halo exchanges), which is not
ported: the port refuses it.
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

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
