"""Batched NMS and compaction for the detection post-processors.

Port of ``refinedet_tpu/ops/dispatch.py``. The sweep is the op
``refinedet_tpu_torch::nms_sweep`` (``ops/nms_cuda.py``), which goes where
the tensors are: on a CUDA tensor to kernel K1, on a CPU tensor to its
plain version; ``torch.export`` keeps it as one node. ``plain=True`` takes the plain version on any
device; it exists so the kernel path can be held against the plain path on
the card.
"""

from __future__ import annotations

import torch

from refinedet_tpu_torch.ops.nms import (NmsResult, nms_sweep_reference,
                                         select_candidates)
from refinedet_tpu_torch.ops.nms_cuda import nms_sweep


def batched_nms_auto(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thresh: float, top_k: int,
                     score_thresh: float = -float("inf"),
                     plus_one: bool = False,
                     plain: bool = False) -> NmsResult:
    """NMS over arbitrary leading dims: boxes ``[..., N, 4]`` (broadcast
    against scores' leading dims), scores ``[..., N]``. All groups go to
    one sweep call."""
    lead = scores.shape[:-1]
    idx, sc, cand, valid = select_candidates(boxes, scores, top_k,
                                             score_thresh)
    k = idx.shape[-1]
    sweep = nms_sweep_reference if plain else nms_sweep
    keep = sweep(cand.reshape(-1, k, 4).contiguous(),
                 valid.reshape(-1, k).contiguous(), iou_thresh,
                 plus_one=plus_one)
    return NmsResult(idx, keep.reshape(*lead, k), sc)


def class_parallel_nms(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_thresh: float, top_k: int,
                       score_thresh: float = -float("inf"),
                       plus_one: bool = False, plain: bool = False):
    """Batched NMS + compaction.

    boxes ``[..., N, 4]`` (or broadcastable), scores ``[..., N]``. Returns
    (boxes ``[..., top_k, 4]``, scores ``[..., top_k]``): survivors first
    in descending score, zeros after.
    """
    res = batched_nms_auto(boxes, scores, iou_thresh, top_k, score_thresh,
                           plus_one, plain)
    lead, n = scores.shape[:-1], scores.shape[-1]
    boxes = boxes.expand(*lead, n, 4)

    # Stable sort on ~keep moves survivors to the front in score order.
    order = torch.argsort((~res.keep).to(torch.uint8), dim=-1, stable=True)
    keep_sorted = torch.gather(res.keep, -1, order)
    sc = torch.gather(torch.where(res.keep, res.scores, 0.0), -1, order)
    idx_sorted = torch.gather(res.indices, -1, order)
    k = sc.shape[-1]
    bx = torch.gather(boxes, -2, idx_sorted[..., None].expand(*lead, k, 4))
    bx = torch.where(keep_sorted[..., None], bx, 0.0)

    if k >= top_k:
        return bx[..., :top_k, :], sc[..., :top_k]
    pad = top_k - k
    sc = torch.nn.functional.pad(sc, (0, pad))
    bx = torch.nn.functional.pad(bx, (0, 0, 0, pad))
    return bx, sc
