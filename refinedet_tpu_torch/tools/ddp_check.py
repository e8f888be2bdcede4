"""Data-parallel checks: N ranks, each on its contiguous rows of a global
batch, against one process on the whole batch.

Used by ``tests/test_torch_port_parallel.py`` (gloo ranks on the CPU) and
``chip_smoke.py`` phase 12 (two gloo ranks sharing one card). A check is a
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
    ``empty_rows`` carry no GT box). Result: each step's metrics and host
    ms (a correctness run's, synchronised), the state's digest, and after
    each step listed in ``save`` (rank 0 and the reference only) the
    parameters' ``summaries``, the buffers (BN's running statistics) and
    the momentum buffers, by name; with ``checkpoint`` (a folder) rank 0
    writes the final train state there. A step's momentum buffer is its
    update divided by -lr, in full precision: an update 1e-7 the size of
    its weight is not, once added to it.
  * ``resume``: every rank builds a model of its own seed and a
    ``Trainer``, and loads the ``checkpoint`` that a ``steps`` job wrote,
    rank 1 a copy with every weight and momentum buffer moved; the result
    is the digest after ``Trainer.load_state``, which replicates rank 0's.
  * ``eval``: ``Evaluator.run`` of a test-phase RefineDet (21 classes,
    ``seed`` weights) on ``SyntheticVOC(images, size, data_seed)`` at
    ``rank_batch`` images a batch on each rank (``batch_size`` = rank_batch
    × world). Result: ``all_boxes`` (rank 0 and the reference; None on the
    others) and K1's launches.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from refinedet_tpu_torch.config import VOC_MEANS, DetectConfig, TrainConfig
from refinedet_tpu_torch.data.collate import Batch
from refinedet_tpu_torch.parallel import distributed
from refinedet_tpu_torch.parallel.mesh import shard_batch

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


def _steps(job: dict, group, device) -> dict:
    from refinedet_tpu_torch.train import (CheckpointManager,
                                           create_train_state,
                                           make_optimizer, make_train_step)
    rank = dist.get_rank(group) if group is not None else 0
    world = dist.get_world_size(group) if group is not None else 1
    model = _build(job, "train", device, job.get("seed", 0))
    opt = make_optimizer(model.net.parameters(), lambda t: job["lr"],
                         grad_clip_norm=job.get("clip", 0.0))
    cfg = TrainConfig(batch_size=job["batch"], max_boxes=8)
    step = make_train_step(model, opt, cfg, group)
    state = create_train_state(model, opt)
    param_dtype = next(model.net.parameters()).dtype
    out = {"metrics": [], "ms": [], "saved": {}}
    for t in range(job["steps"]):
        batch = global_batch(job.get("data_seed", 0) + t, job["batch"],
                             job["size"], job.get("classes", 21),
                             empty_rows=job.get("empty_rows", ()))
        if group is not None:
            batch = shard_batch(batch, rank, world)
        tensors = [torch.from_numpy(a).to(device) for a in batch]
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
    if job.get("checkpoint") and rank == 0:
        CheckpointManager(job["checkpoint"]).save(state, CHECKPOINT_TAG)
    return out


def _resume(job: dict, group, device) -> dict:
    from refinedet_tpu_torch.tools.train_check import SyntheticDetection
    from refinedet_tpu_torch.train import CheckpointManager, Trainer
    rank = dist.get_rank(group)
    dist.barrier(group)  # rank 0 wrote the checkpoint
    model = _build(job, "train", device, seed=10 + rank)
    trainer = Trainer(model, SyntheticDetection(
        2 * dist.get_world_size(group), job["size"], job.get("classes", 21)),
        TrainConfig(batch_size=2 * dist.get_world_size(group),
                    num_workers=0), log_fn=lambda line: None)
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


JOBS = {"steps": _steps, "resume": _resume, "eval": _eval}


def run_jobs(jobs: Sequence[dict], group: Optional[dist.ProcessGroup],
             device) -> Dict[str, dict]:
    """Each job's result by name, run in order on ``device``."""
    device = torch.device(device)
    return {job["name"]: JOBS[job["kind"]](job, group, device)
            for job in jobs}


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
