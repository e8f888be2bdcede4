"""Data-parallel checks: N ranks, each on its contiguous rows of a global
batch, against one process on the whole batch.

Used by ``tests/test_torch_port_parallel.py`` (gloo ranks on the CPU) and
``chip_smoke.py`` phases 12 and 15 (gloo ranks sharing one card). A check is a
list of jobs, each a dict with a ``kind`` and a ``name``; ``run_jobs``
runs them in this process, as a rank of ``group`` or, with ``group=None``,
as the one process that takes each global batch whole. ``start`` spawns
the ranks of one process group and any number of reference processes
(no group), without waiting for them; each process saves its results,
``{job name: result}``, to ``<out>/rank<i>.pt`` or
``<out>/reference<i>.pt``.

Jobs:

  * ``steps``: a train-phase RefineDet (``size``, ``classes``, ``bn``,
    ``dtype`` "float32", "bfloat16" or "float64", weights from ``seed`` or
    the state_dict file ``init``) takes ``steps`` SGD steps at constant
    ``lr`` with global-norm clip ``clip``, on ``global_batch(data_seed +
    t, batch, ...)`` (``batch`` is the global batch; the rows
    ``empty_rows`` carry no GT box), or with ``staging`` on the staged
    ``StagedSyntheticDetection(batch, staging, classes, data_seed + t)``
    through the on-device augmentation (draws keyed by ``seed``, as the
    Trainer's). ``spatial_shards`` S lays the ranks out as a
    ``(world // S, S)`` grid: each rank takes its data group's rows.
    Result: each step's metrics and host ms (a correctness run's,
    synchronised), the state's digest, the peak bytes the card held (None
    on the CPU), the halo and gather bytes a step (S > 1), the
    hand-written kernels' launches (``kernel_launches``), and after each
    step listed in ``save`` (rank 0 and the reference only) the
    parameters' ``summaries``, the buffers (BN's running statistics) and
    the momentum buffers, by name; with ``checkpoint`` (a folder) rank 0
    writes the final train state there. A step's momentum buffer is its
    update divided by -lr, in full precision: an update 1e-7 the size of
    its weight is not, once added to it.
  * ``resume``: every rank builds a model of its own seed and a
    ``Trainer`` (``spatial_shards`` as above), and loads the
    ``checkpoint`` that a ``steps`` job wrote, rank 1 a copy with every
    weight and momentum buffer moved; the result is the digest after
    ``Trainer.load_state``, which replicates rank 0's.
  * ``trainer``: ``Trainer.train`` (``spatial_shards`` as above) of a
    train-phase RefineDet on ``SyntheticDetection(batch, size, classes)``,
    one step an epoch for ``steps`` epochs at constant ``lr`` and clip
    ``clip``, into the folder ``checkpoint``; then every rank builds a
    model of its own seed and a Trainer, and loads rank 0's ``final``
    checkpoint. Result: the logged losses (rank 0), the trained and the
    resumed state's digests, the resumed step, whether the checkpoint was
    there, and the kernels' launches in training.
  * ``spatial_ops`` (ranks only, one data group of ``world`` space
    ranks): ``halo_conv2d`` (3x3 convolutions of dilation 1 and 3 and of
    stride 2 in float64, and one under bf16 autocast), ``halo_exchange``
    under a -inf padded max pool, ``gather_rows`` and ``take_rows``, each
    with its gradients (the convolutions' weight and bias gradients
    summed over the ranks), against the unsharded op on the same
    tensors. Result: per op the largest difference relative to the
    largest magnitude, of the outputs and of the gradients.
  * ``eval``: ``Evaluator.run`` of a test-phase RefineDet (21 classes,
    ``seed`` weights) on ``SyntheticVOC(images, size, data_seed)`` at
    ``rank_batch`` images a batch on each rank (``batch_size`` = rank_batch
    × world). Result: ``all_boxes`` (rank 0 and the reference; None on the
    others) and K1's launches.

Any job may name the pools' backward, ``pool_backward`` (``models/
layers.py:POOL_BACKWARD``, "select_scatter" by default), to run under.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from refinedet_tpu_torch.config import VOC_MEANS, DetectConfig, TrainConfig
from refinedet_tpu_torch.data.collate import Batch
from refinedet_tpu_torch.models import layers
from refinedet_tpu_torch.parallel import distributed
from refinedet_tpu_torch.parallel.mesh import (grid_position, make_grid,
                                               shard_batch)

CHECKPOINT_TAG = "ddp_check"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def global_batch(seed: int, batch: int, size: int, num_classes: int,
                 max_boxes: int = 8, empty_rows: Sequence[int] = ()
                 ) -> Batch:
    """A global batch from ``seed``: N(0, 1) images, 1-4 boxes an image
    (labels 1 .. num_classes - 1), no box in the rows ``empty_rows``."""
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, size, size, 3).astype(np.float32)
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    labels = np.zeros((batch, max_boxes), np.int32)
    valid = np.zeros((batch, max_boxes), bool)
    for i in range(batch):
        n = rng.randint(1, 5)
        xy = rng.uniform(0.05, 0.5, (n, 2))
        wh = rng.uniform(0.15, 0.45, (n, 2))
        boxes[i, :n] = np.hstack([xy, np.minimum(xy + wh, 1.0)])
        labels[i, :n] = rng.randint(1, num_classes, n)
        valid[i, :n] = i not in empty_rows
    return Batch(images, boxes, labels, valid)


def digest(tensors: Sequence[torch.Tensor]) -> str:
    """sha256 of the tensors' bytes (standard layout), in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_digest(net: torch.nn.Module, optimizer=None) -> str:
    """Digest of the net's state_dict and the optimizer's momentum."""
    tensors = list(net.state_dict().values())
    if optimizer is not None:
        tensors += [optimizer.state[p]["momentum_buffer"]
                    for p in net.parameters()
                    if "momentum_buffer" in optimizer.state[p]]
    return digest(tensors)


def summaries(named: Iterable[Tuple[str, torch.Tensor]]
              ) -> Dict[str, np.ndarray]:
    """Per tensor, float64 [sum, absolute sum, first 8 elements (zero
    padded)]: what ``tests/distributed_worker.py`` keeps of each JAX
    parameter."""
    out = {}
    for name, t in named:
        a = t.detach().cpu().double().reshape(-1).numpy()
        head = np.zeros(8)
        head[:min(8, a.size)] = a[:8]
        out[name] = np.concatenate([[a.sum(), np.abs(a).sum()], head])
    return out


def summary_errors(got: Dict[str, np.ndarray],
                   want: Dict[str, np.ndarray]) -> Tuple[float, float]:
    """The worst, over the tensors, of the two measures
    ``tests/test_distributed_multiprocess.py`` holds JAX's ranks to: the
    sum's difference over the absolute sum floored at 1, and the largest
    difference of the first 8 elements."""
    if got.keys() != want.keys():
        raise ValueError("the two runs summarise different tensors")
    sums = max(abs(got[k][0] - w[0]) / max(abs(w[1]), 1.0)
               for k, w in want.items())
    heads = max(float(np.abs(got[k][2:] - w[2:]).max())
                for k, w in want.items())
    return sums, heads


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build(job: dict, phase: str, device, seed: int):
    from refinedet_tpu_torch.models import build_refinedet
    dtype = DTYPES[job.get("dtype", "float32")]
    model = build_refinedet(
        phase, job["size"], job.get("classes", 21),
        use_bn=job.get("bn", False),
        dtype=torch.bfloat16 if dtype == torch.bfloat16 else torch.float32,
        device=device, seed=seed)
    if dtype == torch.float64:
        model.net.double()
    if job.get("init"):
        model.net.load_state_dict(torch.load(job["init"],
                                             weights_only=True))
    return model


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' launch counts in this process."""
    from refinedet_tpu_torch.ops import int8_conv, nms_cuda
    return {"nms_sweep": nms_cuda.nms_sweep.launches,
            "int8_conv": int8_conv.int8_conv.launches,
            "int8_quantize": int8_conv.int8_quantize.launches}


def _launched(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _data_axis(job: dict, group) -> Tuple[int, int, int]:
    """(rank, data index, data-parallel ranks) of this process."""
    if group is None:
        return 0, 0, 1
    rank, shards = dist.get_rank(group), job.get("spatial_shards", 1)
    return rank, grid_position(rank, shards)[0], \
        dist.get_world_size(group) // shards


def _batch(job: dict, t: int) -> Batch:
    seed = job.get("data_seed", 0) + t
    if not job.get("staging"):
        return global_batch(seed, job["batch"], job["size"],
                            job.get("classes", 21),
                            empty_rows=job.get("empty_rows", ()))
    from refinedet_tpu_torch.data.collate import detection_collate
    from refinedet_tpu_torch.tools.train_check import \
        StagedSyntheticDetection
    data = StagedSyntheticDetection(job["batch"], job["staging"],
                                    job.get("classes", 21), seed=seed)
    return detection_collate([data[i] for i in range(len(data))], 8)


def _steps(job: dict, group, device) -> dict:
    from refinedet_tpu_torch.train import (CheckpointManager,
                                           create_train_state,
                                           make_optimizer, make_train_step)
    rank, data_rank, data_world = _data_axis(job, group)
    model = _build(job, "train", device, job.get("seed", 0))
    opt = make_optimizer(model.net.parameters(), lambda t: job["lr"],
                         grad_clip_norm=job.get("clip", 0.0))
    cfg = TrainConfig(batch_size=job["batch"], max_boxes=8,
                      spatial_shards=job.get("spatial_shards", 1),
                      on_device_augment=bool(job.get("staging")),
                      mean=VOC_MEANS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = kernel_launches()
    step = make_train_step(model, opt, cfg, group)
    state = create_train_state(model, opt)
    param_dtype = next(model.net.parameters()).dtype
    out = {"metrics": [], "ms": [], "saved": {}}
    for t in range(job["steps"]):
        batch = _batch(job, t)
        if group is not None:
            batch = shard_batch(batch, data_rank, data_world)
        tensors = [torch.from_numpy(a).to(device) for a in batch]
        # staged images stay uint8, but in a float64 net's float64
        if not job.get("staging") or param_dtype == torch.float64:
            tensors[0] = tensors[0].to(param_dtype)
        _sync(device)
        t0 = time.perf_counter()
        state, metrics = step(state, *tensors)
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1000.0)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if t + 1 in job.get("save", ()) and rank == 0:
            out["saved"][t + 1] = {
                "params": summaries(model.net.named_parameters()),
                "buffers": {k: v.detach().cpu().clone()
                            for k, v in model.net.named_buffers()},
                "momentum": {
                    n: opt.state[p]["momentum_buffer"].detach().cpu().clone()
                    for n, p in model.net.named_parameters()}}
    out["digest"] = state_digest(model.net, opt)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    out["launches"] = _launched(before)
    if step.spatial is not None:
        out["traffic"] = {k: v // job["steps"]
                          for k, v in step.spatial.bytes.items()}
    if job.get("checkpoint") and rank == 0:
        CheckpointManager(job["checkpoint"]).save(state, CHECKPOINT_TAG)
    return out


def _trainer_of(job: dict, group, device, seed: int, **kw):
    from refinedet_tpu_torch.tools.train_check import SyntheticDetection
    from refinedet_tpu_torch.train import Trainer
    world = dist.get_world_size(group)
    batch = job.get("batch", 2 * world)
    cfg = TrainConfig(batch_size=batch, num_workers=0, lr=job.get("lr", 1e-3),
                      warmup_epochs=0, grad_clip_norm=job.get("clip", 0.0),
                      max_epoch=job.get("steps", 1),
                      spatial_shards=job.get("spatial_shards", 1))
    model = _build(job, "train", device, seed)
    data = SyntheticDetection(batch, job["size"], job.get("classes", 21))
    return Trainer(model, data, cfg, **kw)


def _resume(job: dict, group, device) -> dict:
    from refinedet_tpu_torch.train import CheckpointManager
    rank = dist.get_rank(group)
    dist.barrier(group)  # rank 0 wrote the checkpoint
    trainer = _trainer_of(job, group, device, 10 + rank,
                          log_fn=lambda line: None)
    model = trainer.model
    path = CheckpointManager(job["checkpoint"]).path(CHECKPOINT_TAG)
    payload = CheckpointManager.restore_path(path)
    if rank == 1:  # a stale copy: every weight and momentum moved
        payload["model"] = {k: v + 1 if v.is_floating_point() else v
                            for k, v in payload["model"].items()}
        for s in payload["optimizer"]["state"].values():
            s["momentum_buffer"] = s["momentum_buffer"] + 1
    state = trainer.load_state(payload, path)
    return {"digest": state_digest(model.net, trainer.optimizer),
            "step": state.step}


def _eval(job: dict, group, device) -> dict:
    from refinedet_tpu_torch.data import BaseTransform
    from refinedet_tpu_torch.eval import Evaluator
    from refinedet_tpu_torch.ops import nms_cuda
    from refinedet_tpu_torch.tools.eval_check import SyntheticVOC
    world = dist.get_world_size(group) if group is not None else 1
    model = _build({**job, "classes": 21}, "test", device,
                   job.get("seed", 0))
    data = SyntheticVOC(job["images"], job["size"],
                        seed=job.get("data_seed", 0))
    cfg = DetectConfig(num_classes=21, top_k=1000, keep_top_k=1000,
                       nms_thresh=0.45)
    evaluator = Evaluator(model, data, cfg,
                          BaseTransform(job["size"], VOC_MEANS),
                          batch_size=job["rank_batch"] * world,
                          nms_top_k=job.get("nms_top_k", 300),
                          plus_one=False, group=group,
                          log=lambda line: None)
    before = nms_cuda.nms_sweep.launches
    all_boxes = evaluator.run()
    return {"all_boxes": all_boxes,
            "launches": nms_cuda.nms_sweep.launches - before}


def _trainer(job: dict, group, device) -> dict:
    from refinedet_tpu_torch.train import CheckpointManager
    rank = dist.get_rank(group)
    lines: List[str] = []
    trainer = _trainer_of(job, group, device, job.get("seed", 0),
                          save_folder=job["checkpoint"], dataset_name="SYN",
                          log_fn=lines.append)
    before = kernel_launches()
    state = trainer.train()
    launched = _launched(before)
    trained = state_digest(trainer.model.net, trainer.optimizer)
    dist.barrier(group)  # rank 0 wrote the final checkpoint
    path = trainer.ckpt.path("final")
    fresh = _trainer_of(job, group, device, 10 + rank,
                        log_fn=lambda line: None)
    resumed = fresh.load_state(CheckpointManager.restore_path(path), path)
    losses = [float(m.group(1)) for m in map(
        re.compile(r" loss: (\S+) \|\|").search, lines) if m]
    return {"losses": losses, "digest": trained,
            "resumed": state_digest(fresh.model.net, fresh.optimizer),
            "step": resumed.step, "checkpoint": os.path.exists(path),
            "launches": launched}


def _spatial_ops(job: dict, group, device) -> dict:
    import torch.nn.functional as F
    from refinedet_tpu_torch.parallel.spatial import (SpatialContext,
                                                      gather_rows,
                                                      halo_conv2d,
                                                      halo_exchange,
                                                      spatial_plan,
                                                      take_rows)
    world = dist.get_world_size(group)
    space = SpatialContext(spatial_plan(320, world), make_grid(world, group))
    k = space.index
    gen = torch.Generator().manual_seed(job.get("seed", 0))

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, dtype=dtype).to(
            device).to(memory_format=torch.channels_last)

    def rows(t, n):
        return t[:, :, k * n:(k + 1) * n]

    def seeded_conv(dtype, **kw):  # the same weights on every rank
        conv = torch.nn.Conv2d(3, 4, 3, **kw)
        with torch.no_grad():
            for p in conv.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        return conv.to(device, dtype)

    def err(a, b):  # relative to b's largest magnitude
        return float((a.detach() - b.detach()).abs().max()
                     / b.detach().abs().max())

    def compare(full_fn, band_fn, x, out_rows, params=()):
        """full_fn on the whole of x against band_fn on this rank's band:
        the outputs, and the gradients of a random weighting of them,
        of x's band and (summed over the ranks) of ``params``."""
        x = x.detach().requires_grad_()
        y = full_fn(x)
        w = randn(*y.shape, dtype=y.dtype)
        gx, *gp = torch.autograd.grad((y * w).float().sum(), (x, *params))
        h = x.shape[2] // world
        xb = rows(x.detach(), h).clone().requires_grad_()
        yb = band_fn(xb)
        gb, *gq = torch.autograd.grad(
            (yb * rows(w, out_rows)).float().sum(), (xb, *params))
        for g in gq:
            dist.all_reduce(g, group=group)
        return (err(yb, rows(y, out_rows)),
                max([err(gb, rows(gx, h))]
                    + [err(a, b) for a, b in zip(gq, gp)]))

    out = {}
    x = randn(2, 3, 16, 5)
    for name, kw, halo in (("conv3x3", {}, (1, 1)),
                           ("dilated3", {"dilation": 3}, (3, 3)),
                           ("stride2", {"stride": 2}, (1, 0))):
        conv = seeded_conv(torch.float64, padding=kw.get("dilation", 1),
                           **kw)
        out[name] = compare(
            conv, lambda t: halo_conv2d(t, conv, *halo, space), x,
            16 // world // kw.get("stride", 1), tuple(conv.parameters()))
    # bf16 autocast, as the bf16 step runs it: the conv in bf16 on both
    # sides, f32 weights and input
    conv = seeded_conv(torch.float32, padding=1)
    with torch.autocast(device.type, dtype=torch.bfloat16):
        out["conv3x3_bf16"] = compare(
            conv, lambda t: halo_conv2d(t, conv, 1, 1, space), x.float(),
            16 // world, tuple(conv.parameters()))
    out["maxpool_inf"] = compare(
        lambda t: F.max_pool2d(t, 3, 1, 1),
        lambda t: F.max_pool2d(halo_exchange(t, 1, 1, space,
                                             float("-inf")), 3, 1, (0, 1)),
        x, 16 // world)
    # A replicated input: each rank's gradient of its band alone.
    y = x.detach().clone().requires_grad_()
    w = randn(*y.shape)
    yb = take_rows(y, space)
    (gy,) = torch.autograd.grad((yb * rows(w, 16 // world)).sum(), y)
    want = torch.zeros_like(w)
    want[:, :, k * 16 // world:(k + 1) * 16 // world] = \
        rows(w, 16 // world)
    out["take_rows"] = (err(yb, rows(x, 16 // world)), err(gy, want))
    # gather_rows' backward sums the space ranks' gradients: each rank
    # weighs the gathered rows its own way, the band gets the sum.
    ws = [randn(*x.shape) for _ in range(world)]
    xb = rows(x, 16 // world).clone().requires_grad_()
    g = gather_rows(xb, space)
    (gb,) = torch.autograd.grad((g * ws[k]).sum(), xb)
    out["gather_rows"] = (err(g, x), err(gb, rows(sum(ws), 16 // world)))
    return out


JOBS = {"steps": _steps, "resume": _resume, "eval": _eval,
        "trainer": _trainer, "spatial_ops": _spatial_ops}


def run_jobs(jobs: Sequence[dict], group: Optional[dist.ProcessGroup],
             device) -> Dict[str, dict]:
    """Each job's result by name, run in order on ``device``."""
    device = torch.device(device)
    results = {}
    for job in jobs:
        with layers.pool_backward(job.get("pool_backward",
                                          layers.POOL_BACKWARD)):
            results[job["name"]] = JOBS[job["kind"]](job, group, device)
    return results


@dataclasses.dataclass
class Spawned:
    """The processes ``start`` started, and where they save."""

    context: "torch.multiprocessing.ProcessContext"
    out: str
    ranks: int
    references: int

    def results(self, timeout: float = 1800.0) -> Dict[str, dict]:
        """Wait for every process (raising if one failed or the time ran
        out), then ``{"rank0": ..., "reference0": ...}``."""
        deadline = time.monotonic() + timeout
        while not self.context.join(timeout=5.0):
            if time.monotonic() > deadline:
                for p in self.context.processes:
                    p.kill()
                raise TimeoutError(f"ranks still running after {timeout} s")
        names = [f"rank{i}" for i in range(self.ranks)] + [
            f"reference{i}" for i in range(self.references)]
        return {n: torch.load(os.path.join(self.out, n + ".pt"),
                              weights_only=False) for n in names}


def _process(index: int, ranks: int, init_method: str, backend: str,
             rank_jobs: List[dict], reference_jobs: List[List[dict]],
             out: str, device: str, threads: int) -> None:
    torch.set_num_threads(threads)
    # f32 means f32 in these comparisons
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if index < ranks:
        distributed.maybe_initialize(init_method, ranks, index, backend)
        try:
            results = run_jobs(rank_jobs, distributed.default_group(), device)
        finally:
            dist.destroy_process_group()
        name = f"rank{index}"
    else:
        results = run_jobs(reference_jobs[index - ranks], None, device)
        name = f"reference{index - ranks}"
    torch.save(results, os.path.join(out, name + ".pt"))


def start(ranks: int, rank_jobs: List[dict],
          reference_jobs: Sequence[List[dict]], out: str,
          backend: str = "gloo", device: str = "cpu",
          threads: int = 1) -> Spawned:
    """Spawn ``ranks`` ranks of one process group on localhost, each
    running ``rank_jobs`` on ``device``, and one process per list of
    ``reference_jobs`` running it without a group; return at once.
    ``out`` is a folder for this check alone: the ranks rendezvous
    through a file there."""
    init_method = distributed.file_rendezvous(out)
    context = torch.multiprocessing.start_processes(
        _process, args=(ranks, init_method, backend, list(rank_jobs),
                        [list(j) for j in reference_jobs], out, device,
                        threads),
        nprocs=ranks + len(reference_jobs), join=False,
        start_method="spawn")
    return Spawned(context, out, ranks, len(reference_jobs))
