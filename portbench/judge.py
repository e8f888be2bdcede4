"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each as one number held to its cell's limit.

Training (``train_gaps``), by the worst leaf, each leaf's gap taken
between the two norms (not the norm of the difference) and measured
against the reference's norm of that leaf or of the median leaf,
whichever is larger:

  * ``loss_gap``: the largest relative gap of a step's loss
    (``loss_gap_first``: the first step's);
  * ``grad_gap``: the first step's clipped gradient as the optimizer gets
    it (``grad_gap_median``: the median leaf's gap);
  * ``update_gap``: the change of the parameters over the compared steps;
    leaves whose reference gradient is under a thousandth of the median
    leaf's (round-off moves them under momentum) are left out;
    ``update_gap_median`` is the median leaf's gap.

Detection (``det_gaps``), per image and class, a row of one side matches
the row of the other whose box overlaps it most, where that IoU is 0.9 or
more (two rows kept by one NMS overlap by 0.49 at most, so a match is
unique):

  * ``score_gap``: the largest score gap over matched rows, ``score_rms``
    their root mean square;
  * ``missed``: the share of rows, of both sides, scored ``min_score`` or
    more, that match no row of the other side;
  * ``mismatched``: the same share, counting a matched row whose score is
    more than ``score_tol`` off as unmatched too;
  * ``logit_mismatched`` (where a ``logit_tol`` is given): the same share,
    counting a matched row as unmatched where its score's logit,
    log(p / (1 - p)), is more than ``logit_tol`` off: the gap of the
    network's own class margin, which a score near 0 or 1 squashes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference.boxes import iou

MATCH_IOU = 0.9


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               names: Sequence[str]) -> torch.Tensor:
    pn = {n: float(torch.linalg.vector_norm(prog[n].float())) for n in names}
    rn = {n: float(torch.linalg.vector_norm(ref[n].float())) for n in names}
    med = float(torch.tensor(list(rn.values())).median())
    return torch.tensor([abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
                         for n in names], dtype=torch.float64)


def train_gaps(prog_losses: List[float], ref_losses: List[float],
               prog_grad: Dict[str, torch.Tensor],
               ref_grad: Dict[str, torch.Tensor],
               prog_delta: Dict[str, torch.Tensor],
               ref_delta: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(ref_grad)
    norms = {n: float(torch.linalg.vector_norm(ref_grad[n])) for n in names}
    med = float(torch.tensor(list(norms.values())).median())
    moved = [n for n in names if norms[n] >= 1e-3 * med]
    grad = _leaf_gaps(prog_grad, ref_grad, names)
    update = _leaf_gaps(prog_delta, ref_delta, moved)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(prog_losses, ref_losses)),
        "loss_gap_first": abs(prog_losses[0] - ref_losses[0])
        / abs(ref_losses[0]),
        "grad_gap": float(grad.max()),
        "grad_gap_median": float(grad.median()),
        "update_gap": float(update.max()),
        "update_gap_median": float(update.median()),
    }


def worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> str:
    """The leaf whose gap of norms is the largest."""
    names = sorted(ref)
    return names[int(_leaf_gaps(prog, ref, names).argmax())]


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-30, 1.0 - 2.0 ** -24)
    return torch.log(p) - torch.log1p(-p)


def det_gaps(got: torch.Tensor, want: torch.Tensor, min_score: float,
             score_tol: float, logit_tol: Optional[float] = None
             ) -> Dict[str, float]:
    """``got`` and ``want``: served rows [N, C-1, K, 5] (x1, y1, x2, y2,
    score), zero rows empty."""
    g = got.reshape(-1, got.shape[-2], 5).float()
    w = want.reshape(-1, want.shape[-2], 5).float().to(g.device)
    score_gap, sq, pairs, missed, off, rows = 0.0, 0.0, 0, 0, 0, 0
    loff = 0
    step = max(1, (1 << 25) // (g.shape[1] * w.shape[1]))
    for i in range(0, g.shape[0], step):
        a, b = g[i:i + step], w[i:i + step]
        ka, kb = a[..., 4] > 0, b[..., 4] > 0
        ov = torch.nan_to_num(iou(a[..., :4], b[..., :4]), nan=0.0)
        ov = torch.where(ka[:, :, None] & kb[:, None, :], ov, 0.0)
        best_b, jb = ov.max(2)          # for each row of a
        best_a, ja = ov.max(1)          # for each row of b
        hit_a, hit_b = best_b >= MATCH_IOU, best_a >= MATCH_IOU
        pair = torch.gather(b[..., 4], 1, jb)
        pair_b = torch.gather(a[..., 4], 1, ja)
        gap = torch.where(hit_a & ka, (a[..., 4] - pair).abs(), 0.0)
        gap_b = (b[..., 4] - pair_b).abs()
        score_gap = max(score_gap, float(gap.max()) if gap.numel() else 0.0)
        sq += float((gap.double() ** 2).sum())
        pairs += int((hit_a & ka).sum())
        big_a, big_b = ka & (a[..., 4] >= min_score), \
            kb & (b[..., 4] >= min_score)
        missed += int((big_a & ~hit_a).sum() + (big_b & ~hit_b).sum())
        off += int((big_a & ~(hit_a & (gap <= score_tol))).sum()
                   + (big_b & ~(hit_b & (gap_b <= score_tol))).sum())
        rows += int(big_a.sum() + big_b.sum())
        if logit_tol is not None:
            lg = (_logit(a[..., 4]) - _logit(pair)).abs()
            lg_b = (_logit(b[..., 4]) - _logit(pair_b)).abs()
            loff += int((big_a & ~(hit_a & (lg <= logit_tol))).sum()
                        + (big_b & ~(hit_b & (lg_b <= logit_tol))).sum())
    out = {"score_gap": score_gap, "score_rms": (sq / max(pairs, 1)) ** 0.5,
           "missed": missed / max(rows, 1), "mismatched": off / max(rows, 1)}
    if logit_tol is not None:
        out["logit_mismatched"] = loff / max(rows, 1)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
