"""The reference's detection post-processing: raw heads to the served
``dets [B, C-1, K, 5]`` rows (x1, y1, x2, y2, score).

RefineDet's two-step decode as the fork's ``Detect_RefineDet`` runs it:
softmax of both confidence heads, every class score zeroed where ARM
P(object) <= ``objectness_thresh``, the ODM offsets decoded against the
ARM-refined anchors; then per class the ``top_k`` best scores (a stable
descending sort), those above ``conf_thresh`` kept as candidates, greedy
NMS at ``nms_thresh`` (IoU without +1; a row suppresses the later rows
whose IoU with it is above the threshold), the survivors first in score
order and zeros after. The sweep is plain: one row at a time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from portbench.reference.boxes import center_size, decode, iou


class Candidates(NamedTuple):
    boxes: torch.Tensor   # [G, K, 4] score-descending
    scores: torch.Tensor  # [G, K]
    valid: torch.Tensor   # [G, K] score above conf_thresh
    keep: torch.Tensor    # [G, K] greedy NMS survivors


def f32(x: float) -> float:
    return float(np.float32(x))


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                thresh: float) -> torch.Tensor:
    """keep [G, K] of score-sorted ``boxes`` [G, K, 4]; a NaN IoU never
    suppresses, an invalid row neither suppresses nor is kept."""
    k = valid.shape[-1]
    ov = iou(boxes, boxes)
    col = torch.arange(k, device=boxes.device)
    suppressed = torch.zeros_like(valid)
    rows = int(torch.where(valid, col, -1).max()) + 1 if valid.numel() else 0
    for i in range(rows):
        active = valid[:, i] & ~suppressed[:, i]
        suppressed |= active[:, None] & (ov[:, i] > f32(thresh)) & (col > i)
    return valid & ~suppressed


def candidates(heads, pri: torch.Tensor, post: Dict) -> Candidates:
    """Per (image, class >= 1) group, the ``nms_top_k`` candidates and
    their greedy keep mask."""
    arm_loc, arm_conf, odm_loc, odm_conf = heads
    var = post["variance"]
    arm_p = torch.softmax(arm_conf, -1)
    odm_p = torch.softmax(odm_conf, -1)
    scores = torch.where(arm_p[..., 1:2] <= post["objectness_thresh"], 0.0,
                         odm_p)
    boxes = decode(odm_loc, center_size(decode(arm_loc, pri, var)), var)
    b, p, c = scores.shape
    cls = scores[..., 1:].movedim(-1, 1).reshape(b * (c - 1), p)
    k = min(post["nms_top_k"], p)
    top, idx = torch.sort(cls, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    grp_boxes = boxes[:, None].expand(b, c - 1, p, 4).reshape(-1, p, 4)
    cand = torch.gather(grp_boxes, 1, idx[..., None].expand(-1, k, 4))
    valid = top > f32(post["conf_thresh"])
    return Candidates(cand, top, valid,
                      greedy_keep(cand, valid, post["nms_thresh"]))


def dets(c: Candidates, batch: int, top_k: int) -> torch.Tensor:
    """The served rows ``[B, C-1, top_k, 5]`` of ``candidates``."""
    order = torch.argsort((~c.keep).to(torch.uint8), dim=-1, stable=True)
    keep = torch.gather(c.keep, -1, order)
    sc = torch.where(keep, torch.gather(c.scores, -1, order), 0.0)
    bx = torch.where(keep[..., None], torch.gather(
        c.boxes, 1, order[..., None].expand(-1, -1, 4)), 0.0)
    out = torch.cat([bx, sc[..., None]], -1)[:, :top_k]
    if out.shape[1] < top_k:
        out = torch.nn.functional.pad(out, (0, 0, 0, top_k - out.shape[1]))
    return out.reshape(batch, -1, top_k, 5)
