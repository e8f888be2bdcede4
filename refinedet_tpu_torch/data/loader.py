"""Prefetching input pipeline feeding the card.

Port of ``refinedet_tpu/data/loader.py``, the counterpart of the
reference's ``torch.utils.data.DataLoader(num_workers=8,
pin_memory=True)``: a pool of workers runs the numpy/cv2 augmentation per
sample (cv2 releases the GIL in its hot loops), batches are assembled with
static-shape padding, and a bounded prefetch queue keeps ``prefetch``
batches in flight so host preprocessing overlaps the device's step.

``DeviceStager`` is the ``device_put`` for a card: in the producer thread
it pins each batch and copies it to the card on a side stream, so the copy
overlaps the previous step; the train loop calls ``StagedBatch.wait()``,
which makes its stream wait for that copy before it reads the batch.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import (Callable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from refinedet_tpu_torch.data.collate import Batch, detection_collate, pad_batch

# Worker-process state for use_processes=True (reference-style worker
# processes, torch DataLoader num_workers semantics). The dataset is
# pickled once per worker via the pool initializer, not per task.
_WORKER_DATASET = None


def _worker_init(dataset, epoch: int) -> None:
    global _WORKER_DATASET
    try:
        import cv2
        cv2.setNumThreads(0)  # workers are the parallelism unit
    except ImportError:
        pass
    _WORKER_DATASET = dataset
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)


def _worker_get(i: int):
    return _WORKER_DATASET[i]


class DataLoader:
    """Shuffling, prefetching batch loader over a map-style dataset.

    dataset[i] must return (image, boxes, labels). Epoch order is
    deterministic given (seed, epoch). With ``drop_last=False`` (the
    Trainer's setting, matching the reference's ceil epoch_size,
    train_refinedet.py:193) the trailing partial batch is padded to
    ``batch_size`` with all-invalid samples — still static shapes, and the
    padding contributes zero loss/gradient (see collate.pad_batch).
    """

    def __init__(self, dataset, batch_size: int, max_boxes: int = 60,
                 num_workers: int = 8, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, drop_last: bool = True,
                 device_put: Optional[Callable[[Batch], Batch]] = None,
                 shard_id: int = 0, num_shards: int = 1,
                 use_processes: bool = False):
        """``shard_id``/``num_shards`` give each rank a disjoint,
        epoch-consistent slice of the global shuffle for data-parallel
        training (every rank must use the same seed): all shards shuffle
        ``(seed, epoch)`` alike, and shard s takes the contiguous indices
        ``[s * per, (s + 1) * per)``, per = len(dataset) // num_shards.

        ``use_processes=True`` runs per-sample work in spawned worker
        processes (the reference's DataLoader-worker model) instead of
        threads — the numpy-heavy augmentation is GIL-bound, so threads
        cannot scale it on any host. Spawn (not fork) is used because the
        parent typically holds an initialized CUDA context; the dataset
        must be picklable (all in-repo datasets are)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        # More threads than cores only adds GIL contention to the
        # numpy-heavy augmentation code — clamp thread workers to what the
        # host has (process workers are taken as requested).
        if use_processes:
            self.num_workers = max(1, num_workers)
        else:
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            self.num_workers = max(1, min(num_workers, cores))
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device_put = device_put
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.use_processes = use_processes
        self.epoch = 0

    def __len__(self) -> int:
        """Batches per epoch of this shard."""
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])).shuffle(idx)
        if self.num_shards > 1:
            per = len(idx) // self.num_shards
            idx = idx[self.shard_id * per:(self.shard_id + 1) * per]
        return idx

    def __iter__(self) -> Iterator[Batch]:
        # Re-randomize per-sample augmentation draws each epoch (datasets
        # seed their RNG from (seed, epoch, index); without this every
        # image would get the identical crop/flip/distort in all epochs).
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        indices = self._epoch_indices()
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that keeps polling the stop flag — a consumer
            that abandons the epoch early (exception, break) must not
            leave this thread parked forever on a full queue."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        if self.use_processes and self.num_workers > 1:
            pool_factory = lambda: ProcessPoolExecutor(  # noqa: E731
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(self.dataset, self.epoch))
            getter = _worker_get
        else:
            pool_factory = lambda: ThreadPoolExecutor(  # noqa: E731
                self.num_workers)
            getter = self.dataset.__getitem__

        def produce():
            try:
                with pool_factory() as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        batch_idx = indices[b * self.batch_size:
                                            (b + 1) * self.batch_size]
                        samples = list(pool.map(getter, batch_idx))
                        batch = detection_collate(samples, self.max_boxes)
                        if len(batch_idx) < self.batch_size:
                            batch = pad_batch(batch, self.batch_size)
                        if self.device_put is not None:
                            batch = self.device_put(batch)
                        if not put_or_stop(batch):
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                put_or_stop(e)
                return
            put_or_stop(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    # Dataset / collate / device_put failure in the producer
                    # thread — surface it to the training loop instead of
                    # hanging on an empty queue.
                    raise item
                yield item
        finally:
            stop.set()
        self.epoch += 1


class StagedBatch(NamedTuple):
    """A batch as tensors on its device; ``ready`` is the event after the
    host-to-device copy (None when there was no asynchronous copy)."""

    images: torch.Tensor   # [B, H, W, 3] float32
    boxes: torch.Tensor    # [B, M, 4] float32
    labels: torch.Tensor   # [B, M] int32
    valid: torch.Tensor    # [B, M] bool
    ready: Optional[torch.cuda.Event] = None

    def wait(self) -> "StagedBatch":
        """Make the current stream wait for the copy (see
        ``wait_for_copy``)."""
        wait_for_copy(self[:4], self.ready)
        return self


def wait_for_copy(tensors: Sequence[torch.Tensor],
                  ready: Optional[torch.cuda.Event]) -> None:
    """Make the current stream wait for the copy that ``ready`` follows,
    and tell the allocator that the current stream uses ``tensors`` (they
    were allocated on the stager's side stream). No-op for ``None``."""
    if ready is not None:
        stream = torch.cuda.current_stream(tensors[0].device)
        stream.wait_event(ready)
        for t in tensors:
            t.record_stream(stream)


class DeviceStager:
    """``device_put`` for the DataLoader: numpy Batch -> StagedBatch on
    ``device``. On a card it pins the arrays and copies them without
    blocking on a side stream of its own; on the CPU it wraps them."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream = None

    def stage(self, arrays: Sequence[np.ndarray]
              ) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
        """numpy arrays -> (tensors on ``device``, the event after their
        copy, or None where no asynchronous copy was made)."""
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type != "cuda":
            return [t.to(self.device) for t in host], None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = [t.pin_memory().to(self.device, non_blocking=True)
                   for t in host]
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def __call__(self, batch: Batch) -> StagedBatch:
        dev, ready = self.stage(batch)
        return StagedBatch(*dev, ready=ready)
