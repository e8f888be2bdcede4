"""Multi-process runtime: one process per device, ``torch.distributed``.

Port of ``refinedet_tpu/parallel/distributed.py``. The JAX package runs
one process per host and lets XLA insert the collectives over a device
mesh; here every device has a process of its own (a *rank*), and the
collectives are explicit: NCCL between cards, gloo on the CPU (gloo also
takes CUDA tensors, so several ranks may share one card over it).

Usage (the same program in every rank)::

    from refinedet_tpu_torch.parallel import distributed
    distributed.maybe_initialize()   # no-op without a rendezvous
    device = distributed.local_device("cuda")
    loader = DataLoader(..., shard_id=distributed.process_index(),
                        num_shards=distributed.process_count())

Ranks come from ``torchrun`` (its ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``MASTER_ADDR``/``MASTER_PORT``), from explicit arguments, or from
``spawn``, which starts them on localhost.
"""

from __future__ import annotations

import os
import socket
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

# torchrun's rendezvous: all of them set means a launcher started us.
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def env_rendezvous() -> bool:
    """True when a launcher (torchrun) set the rendezvous variables."""
    return all(os.environ.get(k) for k in RENDEZVOUS_ENV)


def maybe_initialize(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Initialise the default process group when running multi-process.

    Returns True if it is initialised (now or by an earlier call), False
    for the plain single-process case: no ``init_method`` and no
    launcher's environment. ``init_method`` (``tcp://host:port``) needs
    ``world_size`` and ``rank``. ``backend`` defaults to NCCL when a card
    is visible and gloo otherwise; ask for gloo to run on the CPU, or to
    share one card between ranks. A failed NCCL initialisation raises: it
    never falls back to gloo. Under NCCL the current CUDA device becomes
    ``local_device("cuda")``."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not env_rendezvous():
            return False
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    return True


def process_index() -> int:
    """This rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def default_group() -> Optional[dist.ProcessGroup]:
    """The initialised default group, or None."""
    return dist.group.WORLD if dist.is_initialized() else None


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (the rank itself when no
    launcher set ``LOCAL_RANK``), or the CPU when ``device_type`` is
    "cpu". Raises when the card it names is not visible."""
    if device_type == "cpu":
        return torch.device("cpu")
    index = int(os.environ.get("LOCAL_RANK", process_index()))
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= visible:
        raise RuntimeError(f"rank {process_index()} wants {device_type}:"
                           f"{index}, but {visible} card(s) are visible")
    return torch.device(device_type, index)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, as a new tensor that
    autograd differentiates through."""
    return _AllReduceSum.apply(x, group)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def file_rendezvous(folder: str) -> str:
    """An ``init_method`` for ranks of this host: a file in ``folder``
    (which must hold none of that name). Unlike a free TCP port, which
    another process can take between its choice and rank 0's bind (gloo
    ranks listen on ephemeral ports), nothing else can take it."""
    return "file://" + os.path.join(os.path.abspath(folder), "rendezvous")


def _spawned(rank: int, fn: Callable, world: int, init_method: str,
             backend: str, args: Sequence) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    maybe_initialize(init_method, world, rank, backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          backend: Optional[str] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes on this host, rank i
    with ``LOCAL_RANK`` i, each inside an initialised process group that
    is torn down after it. ``fn`` must be picklable (a module-level
    function). Raises when a rank fails."""
    with tempfile.TemporaryDirectory() as folder:
        torch.multiprocessing.spawn(
            _spawned, args=(fn, nprocs, file_rendezvous(folder), backend,
                            tuple(args)),
            nprocs=nprocs, join=True)
