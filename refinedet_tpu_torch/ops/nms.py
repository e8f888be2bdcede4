"""Greedy hard NMS in plain PyTorch: the reference path and test oracle.

Port of ``refinedet_tpu/ops/nms.py``. ``nms_sweep_reference`` is the plain
version of kernel K1 (``ops/nms_cuda.py``): the same keep mask from the
same score-sorted candidates, computed from a dense ``[G, K, K]`` IoU
matrix and a sequential sweep over the rows. Both area conventions are
supported: ``plus_one=True`` is the C/CUDA/numpy family's
``(x2-x1+1)*(y2-y1+1)`` area, ``plus_one=False`` the torch NMS's.
``soft_nms`` is the on-device Soft-NMS (``cpu_nms.pyx:70-163``'s
semantics), in tensor ops: the JAX package computes it with an XLA loop
and no Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from refinedet_tpu_torch.boxes.geometry import iou_pairwise


class NmsResult(NamedTuple):
    indices: torch.Tensor  # [..., K] indices into the input, score-descending
    keep: torch.Tensor     # [..., K] bool, True for surviving boxes
    scores: torch.Tensor   # [..., K] scores of the candidates


def as_f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float. A threshold given this
    way compares the same in every torch op and in the kernel."""
    return float(np.float32(x))


def select_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                      top_k: int, score_thresh: float = -float("inf")):
    """The ``min(top_k, N)`` best candidates of each group.

    boxes ``[..., N, 4]`` (broadcast against scores' leading dims), scores
    ``[..., N]``. A stable descending sort breaks ties by lower index, as
    ``jax.lax.top_k`` does (``torch.topk`` promises no order on the card).
    Returns (indices, scores, boxes ``[..., K, 4]``, valid ``[..., K]``),
    where valid marks scores above ``score_thresh``.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    k = min(top_k, n)
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    cand = torch.gather(boxes.expand(*lead, n, 4), -2,
                        top_idx[..., None].expand(*lead, k, 4))
    valid = top_scores > as_f32(score_thresh)
    return top_idx, top_scores, cand, valid


def nms_sweep_reference(boxes: torch.Tensor, valid: torch.Tensor,
                        iou_thresh: float,
                        plus_one: bool = False) -> torch.Tensor:
    """Plain version of K1: keep ``[G, K]`` from score-descending
    candidates ``boxes [G, K, 4]`` and ``valid [G, K]``.

    Row i, if it is valid and not yet suppressed, suppresses every column
    j > i whose IoU with it is above ``iou_thresh`` (a NaN IoU never
    suppresses). Invalid rows neither suppress nor are kept.
    """
    k = valid.shape[-1]
    iou = iou_pairwise(boxes, boxes, plus_one=plus_one)  # [G, K, K]
    thresh = as_f32(iou_thresh)
    col = torch.arange(k, device=boxes.device)
    suppressed = torch.zeros_like(valid)
    # Rows after the last valid candidate cannot suppress anything.
    n_rows = int(torch.where(valid, col, -1).max()) + 1 if valid.numel() \
        else 0
    for i in range(n_rows):
        active = valid[:, i] & ~suppressed[:, i]
        hits = (iou[:, i] > thresh) & (col > i)
        suppressed |= active[:, None] & hits
    return valid & ~suppressed


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
        top_k: int = 200, score_thresh: float = -float("inf"),
        plus_one: bool = False) -> NmsResult:
    """Greedy hard NMS over one set: boxes ``[N, 4]``, scores ``[N]``."""
    idx, sc, cand, valid = select_candidates(boxes, scores, top_k,
                                             score_thresh)
    keep = nms_sweep_reference(cand[None], valid[None], iou_thresh,
                               plus_one=plus_one)[0]
    return NmsResult(idx, keep, sc)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
             iou_thresh: float = 0.3, sigma: float = 0.5,
             score_thresh: float = 0.001, method: str = "linear",
             top_k: int = 200) -> NmsResult:
    """Soft-NMS (linear / gaussian / hard) over one set: boxes ``[N, 4]``,
    scores ``[N]``, on their device.

    Port of ``refinedet_tpu/ops/nms.py:soft_nms``: the ``min(top_k, N)``
    best candidates (stable descending), +1 areas as the Cython original,
    then ``k`` rounds, each taking the current best of the pool that is
    left (first index on ties), decaying the rest of the pool against it
    and dropping from the pool every box whose decayed score falls below
    ``score_thresh``. A round whose best is at or below ``score_thresh``
    changes nothing. Returns the candidates' indices, ``keep`` (the boxes
    that had a turn) and their rescored scores. The rounds are tensor
    ops: nothing waits for the device.
    """
    if method not in ("linear", "gaussian", "hard"):
        raise ValueError(f"method must be linear, gaussian or hard, got "
                         f"{method!r}")
    idx, live, cand, _ = select_candidates(boxes, scores, top_k)
    k = live.shape[-1]
    iou = iou_pairwise(cand, cand, plus_one=True)
    thresh, floor = as_f32(iou_thresh), as_f32(score_thresh)
    # A device scalar: the card divides by a host scalar as a multiply by
    # its reciprocal, the CPU (and XLA) by a true division.
    sigma_t = torch.full((), sigma, dtype=iou.dtype, device=iou.device)
    col = torch.arange(k, device=live.device)
    processed = torch.zeros(k, dtype=torch.bool, device=live.device)
    dead = torch.zeros_like(processed)
    for _ in range(k):
        in_pool = ~(processed | dead)
        pool = torch.where(in_pool, live, -float("inf"))
        cur = torch.argmax(pool).view(1)
        has = pool.gather(0, cur) > floor
        row = iou.index_select(0, cur)[0]
        if method == "linear":
            decay = torch.where(row > thresh, 1.0 - row, 1.0)
        elif method == "gaussian":
            decay = torch.exp(-(row * row) / sigma_t)
        else:
            decay = torch.where(row > thresh, 0.0, 1.0)
        do = in_pool & (col != cur) & has
        live = torch.where(do, live * decay, live)
        dead |= do & (live < floor)
        processed |= has & (col == cur)
    return NmsResult(idx, processed, live)
