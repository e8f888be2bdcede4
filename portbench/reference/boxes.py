"""Plain box arithmetic of the reference: priors, encode and decode, IoU,
and the cascaded anchor matching of the train loss.

Frozen copies of the port's ``boxes/priors.py``, ``boxes/codec.py``,
``boxes/geometry.py`` and ``boxes/matcher.py`` semantics (the reference
fork's ``layers/box_utils.py``): the ``log(wh + 1e-5)`` epsilon, the decode
exponent clamped to +/-30, IoU without the +1 area, padding GT rows at
overlap -1, ties to the first maximal index, the forced match where the
last GT wins, ODM targets encoded against the ARM-decoded anchors.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

ENCODE_EPS = 1e-5
DECODE_MAX_EXP = 30.0


def anchor_table(size: int) -> Dict:
    """The fork's ``voc_refinedet`` / ``coco_refinedet`` anchor geometry
    at 320 or 512 (both tables share it; only the class count differs)."""
    fm = {320: (40, 20, 10, 5), 512: (64, 32, 16, 8)}[size]
    return {"feature_maps": fm, "min_dim": size, "steps": (8, 16, 32, 64),
            "min_sizes": (32, 64, 128, 256), "aspect_ratios": (2,)}


def priors(size: int) -> np.ndarray:
    """[P, 4] float32 center-size priors in [0, 1]: per cell (row-major),
    the min-size box, then the sqrt(2) pair; float64, then float32, then
    clipped."""
    t = anchor_table(size)
    out = []
    for k, f in enumerate(t["feature_maps"]):
        f_k = t["min_dim"] / t["steps"][k]
        s_k = t["min_sizes"][k] / t["min_dim"]
        cell = [(s_k, s_k)]
        for ar in t["aspect_ratios"]:
            r = math.sqrt(ar)
            cell += [(s_k * r, s_k / r), (s_k / r, s_k * r)]
        cell = np.asarray(cell, np.float64)
        ij = np.arange(f, dtype=np.float64)
        a = cell.shape[0]
        grid = np.empty((f, f, a, 4), np.float64)
        grid[..., 0] = np.broadcast_to(((ij + 0.5) / f_k)[None, :, None],
                                       (f, f, a))
        grid[..., 1] = np.broadcast_to(((ij + 0.5) / f_k)[:, None, None],
                                       (f, f, a))
        grid[..., 2] = cell[None, None, :, 0]
        grid[..., 3] = cell[None, None, :, 1]
        out.append(grid.reshape(-1, 4))
    return np.clip(np.concatenate(out).astype(np.float32), 0.0, 1.0)


def point_form(b: torch.Tensor) -> torch.Tensor:
    half = b[..., 2:] / 2
    return torch.cat([b[..., :2] - half, b[..., :2] + half], -1)


def center_size(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([(b[..., 2:] + b[..., :2]) / 2, b[..., 2:] - b[..., :2]],
                     -1)


def encode(matched: torch.Tensor, pri: torch.Tensor,
           var: Sequence[float]) -> torch.Tensor:
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2 - pri[..., :2]
    g_cxcy = g_cxcy / (var[0] * pri[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / pri[..., 2:]
    return torch.cat([g_cxcy, torch.log(g_wh + ENCODE_EPS) / var[1]], -1)


def decode(loc: torch.Tensor, pri: torch.Tensor,
           var: Sequence[float]) -> torch.Tensor:
    cxcy = pri[..., :2] + loc[..., :2] * var[0] * pri[..., 2:]
    wh = pri[..., 2:] * torch.exp((loc[..., 2:] * var[1]).clamp(
        -DECODE_MAX_EXP, DECODE_MAX_EXP))
    mins = cxcy - wh / 2
    return torch.cat([mins, mins + wh], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., A, B] of point-form boxes, no +1 area; the union
    as (area_a + area_b) - inter."""
    max_xy = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    min_xy = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    wh = (max_xy - min_xy).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])

    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter)


def refine_match(truths: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, pri: torch.Tensor,
                 var: Sequence[float], threshold: float,
                 arm_loc: torch.Tensor = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loc_t [B, P, 4], conf_t [B, P]) of the batch. ARM mode (no
    ``arm_loc``): anchors are the priors. ODM mode: the ARM-decoded boxes,
    targets encoded against their center-size form."""
    if arm_loc is None:
        anchors, base = point_form(pri), pri
    else:
        anchors = decode(arm_loc, pri, var)
        base = center_size(anchors)
    m, p = truths.shape[1], anchors.shape[-2]
    ov = iou(truths, anchors)                                # [B, M, P]
    ov = torch.where(valid[..., None], ov, -1.0)
    best_prior = torch.argmax(ov, 2)                         # [B, M]
    best_overlap = torch.amax(ov, 1)                         # [B, P]
    best_truth = torch.argmax(ov, 1)
    hits = valid[..., None] & (best_prior[..., None]
                               == torch.arange(p, device=ov.device))
    forced = hits.any(1)
    last = (m - 1) - torch.argmax(hits.flip(1).to(torch.uint8), 1)
    best_truth = torch.where(forced, last, best_truth)
    best_overlap = torch.where(forced, 2.0, best_overlap)
    matches = torch.gather(truths, 1, best_truth[..., None].expand(-1, -1, 4))
    conf = torch.gather(labels.long(), 1, best_truth)
    conf = torch.where(best_overlap < threshold, 0, conf)
    return encode(matches, base, var), conf
