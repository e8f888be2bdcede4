"""Batched detection evaluator (inference + NMS on the card + AP).

Port of ``refinedet_tpu/eval/evaluator.py``, the counterpart of the
reference eval scripts' ``test_net`` loops (``eval_refinedet_coco.py:
155-269``, ``eval_refinedet_voc.py:366-415``): instead of one image at a
time with host NMS, images run in fixed-size batches through the forward
pass, softmax, cascade decode, pixel scaling and class-parallel NMS
(kernel K1 on the card; +1 area convention by default, as the reference's
C/CUDA ``nms_wrapper`` path at eval_refinedet_coco.py:213-232). Only the
compacted detections cross back to the host, once per batch.

Also provides the checkpoint-sweep loop + ap_stats.json + best-epoch report
(eval_refinedet_coco.py:328-368) and FPS/p50 timing.

With a process ``group`` (the JAX Evaluator's ``mesh``) each rank
evaluates its contiguous share of the images on its own device, and rank
0 gathers the detections.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import queue
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from refinedet_tpu_torch.config import DetectConfig
from refinedet_tpu_torch.data.loader import DeviceStager, wait_for_copy
from refinedet_tpu_torch.detect.detection import detect_refinedet
from refinedet_tpu_torch.ops.dispatch import class_parallel_nms


def eval_postprocess(heads, priors: torch.Tensor, scales: torch.Tensor,
                     cfg: DetectConfig, nms_top_k: int, plus_one: bool,
                     plain: bool = False) -> torch.Tensor:
    """Raw heads -> ``dets [B, C-1, nms_top_k, 5]`` rows (x1, y1, x2, y2,
    score) in pixels, score-descending, zero-padded.

    ``scales [B, 4]`` is each image's (w, h, w, h). ``plain=True`` runs
    the NMS sweep's plain version instead of K1, so that the kernel path
    can be held against it on the same heads.
    """
    arm_loc, arm_conf, odm_loc, odm_conf = heads
    boxes, scores = detect_refinedet(
        arm_loc, torch.softmax(arm_conf, dim=-1), odm_loc,
        torch.softmax(odm_conf, dim=-1), priors, variances=cfg.variance,
        objectness_thresh=cfg.objectness_thresh)
    boxes = boxes * scales[:, None, :]
    cls_scores = scores[..., 1:].movedim(-1, 1)  # [B, C-1, P]
    bx, sc = class_parallel_nms(
        boxes[:, None], cls_scores, cfg.nms_thresh, top_k=nms_top_k,
        score_thresh=cfg.conf_thresh, plus_one=plus_one, plain=plain)
    return torch.cat([bx, sc[..., None]], dim=-1)


class Evaluator:
    def __init__(self, model, dataset, detect_cfg: DetectConfig,
                 transform, batch_size: int = 8,
                 nms_top_k: Optional[int] = None,
                 max_per_image: int = 500, plus_one: bool = True,
                 group: Optional[dist.ProcessGroup] = None,
                 log: Callable[[str], None] = print):
        """``model`` is a test-phase ``RefineDetModel``; the evaluator runs
        on its device. ``nms_top_k`` is the per-class pre-NMS candidate
        cap; it defaults to ``detect_cfg.top_k`` (1000, the reference's
        order[:top_k] cap at eval_refinedet_coco.py:222) — pass a smaller
        value to trade recall for NMS speed.

        ``group``: evaluate data-parallel over its ranks, each on its own
        device and its contiguous share of the images, at a batch of
        ``batch_size // world`` (which must divide); rank 0 logs, and its
        ``run`` and ``sweep`` return the results of all the images, the
        other ranks' return None."""
        if model.phase != "test":
            raise ValueError("evaluation requires a 'test'-phase model")
        self.group = group
        self.rank, world = 0, 1
        if group is not None:
            self.rank, world = dist.get_rank(group), dist.get_world_size(
                group)
            if batch_size % world:
                raise ValueError(f"batch_size {batch_size} must divide by "
                                 f"the {world} ranks")
            if self.rank != 0:
                log = lambda line: None  # noqa: E731
        self.world = world
        self.model = model
        self.dataset = dataset
        self.cfg = detect_cfg
        self.transform = transform
        self.batch_size = batch_size // world
        self.nms_top_k = nms_top_k if nms_top_k else detect_cfg.top_k
        self.max_per_image = max_per_image
        self.plus_one = plus_one
        self.log = log
        self.num_classes = detect_cfg.num_classes
        self._stager = DeviceStager(model.device)

    def _forward_postprocess(self, images: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
        """images [B,S,S,3], scales [B,4] (w,h,w,h) on the model's device
        -> dets [B, C-1, K, 5] (see ``eval_postprocess``)."""
        return eval_postprocess(self.model.raw_forward(images),
                                self.model.priors, scales, self.cfg,
                                self.nms_top_k, self.plus_one)

    def _staged_batches(self, n: int, start: int = 0):
        """Host preprocessing of the images ``start`` ... ``n - 1`` and the
        copy to the device, in a producer thread one batch ahead of the
        device. Every batch has the same shape: the last is padded with
        zero images of unit scale."""
        size = self.model.size
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # Bounded put polling the stop flag so an abandoned iteration
            # (exception in the consumer) can't strand this thread on a
            # full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b0 in range(start, n, self.batch_size):
                    if stop.is_set():
                        return
                    idx = list(range(b0, min(b0 + self.batch_size, n)))
                    imgs = np.zeros((self.batch_size, size, size, 3),
                                    np.float32)
                    scales = np.ones((self.batch_size, 4), np.float32)
                    for j, i in enumerate(idx):
                        raw = self.dataset.pull_image(i)
                        raw = raw[0] if isinstance(raw, tuple) else raw
                        imgs[j] = self.transform(raw)
                        h, w = raw.shape[:2]
                        scales[j] = (w, h, w, h)
                    tensors, ready = self._stager.stage((imgs, scales))
                    if not put_or_stop((idx, tensors, ready)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put_or_stop(e)
                return
            put_or_stop(None)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    # A corrupt/missing image must fail the sweep loudly,
                    # not hang it on an empty queue.
                    raise item
                yield item
        finally:
            stop.set()

    def _to_host(self, dets: torch.Tensor) -> np.ndarray:
        """The batch's one wait for the device: ``dets`` copied into
        pinned memory, then the copy's event awaited."""
        if dets.device.type != "cuda":
            return dets.numpy()
        host = torch.empty(dets.shape, dtype=dets.dtype, pin_memory=True)
        host.copy_(dets, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host.numpy()

    def run(self, state: Optional[Mapping[str, torch.Tensor]] = None
            ) -> Optional[List[List[np.ndarray]]]:
        """Returns all_boxes[class][image] = [N, 5] (x1,y1,x2,y2,score)
        (None on a rank other than 0). ``state``, if given, is
        strict-loaded into the model first."""
        if state is not None:
            self.model.net.load_state_dict(state, strict=True)
        self.model.net.eval()
        n = len(self.dataset)
        c = self.num_classes
        all_boxes: List[List[np.ndarray]] = [
            [np.empty((0, 5), np.float32) for _ in range(n)]
            for _ in range(c)]
        # this rank's contiguous share: images lo ... hi - 1
        per, extra = divmod(n, self.world)
        lo = self.rank * per + min(self.rank, extra)
        hi = lo + per + (self.rank < extra)
        batch_times = []
        t_start = time.perf_counter()
        for idx, (imgs, scales), ready in self._staged_batches(hi, lo):
            t0 = time.perf_counter()
            wait_for_copy((imgs, scales), ready)
            with torch.inference_mode():
                dets = self._to_host(self._forward_postprocess(imgs, scales))
            batch_times.append(time.perf_counter() - t0)
            for j, i in enumerate(idx):
                for cl in range(1, c):
                    rows = dets[j, cl - 1]
                    rows = rows[rows[:, 4] > 0][:self.max_per_image]
                    all_boxes[cl][i] = rows.astype(np.float32)
        total = time.perf_counter() - t_start
        # skip the first batch (cuDNN plans, the kernel's build) for
        # steady-state numbers
        steady = batch_times[1:] or batch_times
        per_img = float(np.median(steady)) / self.batch_size
        self.log(f"\nFPS: {1.0 / per_img:.2f} "
                 f"(p50 batch latency {np.median(steady) * 1000:.1f} ms @ "
                 f"batch {self.batch_size}; total {total:.1f}s for "
                 f"{hi - lo} imgs)")
        self.timing = {"fps": 1.0 / per_img,
                       "p50_batch_ms": float(np.median(steady) * 1000),
                       "batch_size": self.batch_size}
        if self.group is None:
            return all_boxes
        return self._gather(all_boxes, range(lo, hi))

    def _gather(self, all_boxes: List[List[np.ndarray]],
                mine: range) -> Optional[List[List[np.ndarray]]]:
        """Every rank's detections of its images into rank 0's
        ``all_boxes`` (returned there; None elsewhere)."""
        rows = {i: [cls[i] for cls in all_boxes] for i in mine}
        parts = [None] * self.world if self.rank == 0 else None
        dist.gather_object(rows, parts, dst=dist.get_global_rank(
            self.group, 0), group=self.group)
        if self.rank != 0:
            return None
        for part in parts:
            for i, per_class in part.items():
                for cls, r in zip(all_boxes, per_class):
                    cls[i] = r
        return all_boxes

    # -- checkpoint sweep (eval_refinedet_coco.py:328-368 parity) ----------
    def sweep(self, checkpoints: Sequence, load_fn: Callable,
              epochs: Optional[Sequence[int]] = None,
              save_folder: Optional[str] = None
              ) -> Optional[Dict[str, list]]:
        """Evaluate a series of checkpoints (``load_fn(path)`` -> the
        model's state_dict); returns + dumps ap_stats (rank 0 computes the
        AP; the other ranks of a group return None)."""
        ap_stats = {k: [] for k in ("ap", "ap50", "ap75", "ap_small",
                                    "ap_medium", "ap_large", "epoch")}
        for i, ckpt in enumerate(checkpoints):
            state = load_fn(ckpt)
            epoch = epochs[i] if epochs else i
            self.log(f"evaluating epoch: {epoch}")
            all_boxes = self.run(state)
            if all_boxes is None:  # a rank other than 0: rank 0 scores
                continue
            stats = self.dataset.evaluate_detections(all_boxes, save_folder)
            for key, val in zip(("ap", "ap50", "ap75", "ap_small",
                                 "ap_medium", "ap_large"), stats[:6]):
                ap_stats[key].append(float(val))
            ap_stats["epoch"].append(epoch)
        if self.rank != 0:
            return None
        if save_folder:
            os.makedirs(save_folder, exist_ok=True)
            with open(osp.join(save_folder, "ap_stats.json"), "w") as f:
                json.dump(ap_stats, f)
        if ap_stats["ap"]:
            best = int(np.argmax(ap_stats["ap"]))
            best50 = int(np.argmax(ap_stats["ap50"]))
            self.log(
                f"best ap: {ap_stats['ap'][best]:.4f} @ epoch "
                f"{ap_stats['epoch'][best]}; best ap50: "
                f"{ap_stats['ap50'][best50]:.4f} @ epoch "
                f"{ap_stats['epoch'][best50]}")
        return ap_stats
