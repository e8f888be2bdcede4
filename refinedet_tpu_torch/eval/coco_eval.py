"""COCO-style detection evaluation in pure numpy.

The port's own copy of ``refinedet_tpu/eval/coco_eval.py``, unchanged in
behaviour: a from-scratch implementation of the standard COCO bbox AP
protocol (greedy score-ordered matching per IoU threshold, crowd/area
ignore handling, 101-point interpolated precision), producing the same
12-element ``stats`` vector as pycocotools' ``COCOeval.summarize()``
without needing pycocotools. The SSDD evaluator (counterpart of the
reference's ``data/sarship_coco.py:279-347``) consumes stats[0:6] = AP,
AP50, AP75, APs, APm, APl.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# NOTE: the gt/dt containers are duck-typed
# refinedet_tpu_torch.data.coco_io.COCO objects; importing them here would
# create a cycle (data -> eval -> data).


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    """IoU between det and gt boxes in xywh; crowd gts use intersection
    over det-area (the COCO convention). [D,4] x [G,4] -> [D,G]."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    darea = (dets[:, 2] * dets[:, 3])[:, None]
    garea = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), darea,
                     darea + garea - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class Params:
    """Default bbox-eval parameters (mirrors pycocotools Params('bbox'))."""

    def __init__(self):
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.0, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0.0, 1e10], [0.0, 32.0 ** 2],
                        [32.0 ** 2, 96.0 ** 2], [96.0 ** 2, 1e10]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.useCats = 1
        self.useSegm = 0


class COCOeval:
    """Greedy-matching COCO bbox evaluator.

    Usage mirrors pycocotools:
      e = COCOeval(coco_gt, coco_dt); e.evaluate(); e.accumulate();
      e.summarize(); e.stats
    """

    def __init__(self, cocoGt, cocoDt, iouType: str = "bbox"):
        assert iouType == "bbox", "only bbox evaluation is implemented"
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params()
        self.params.imgIds = sorted(cocoGt.getImgIds())
        self.params.catIds = sorted(cocoGt.getCatIds())
        self.eval: Dict = {}
        self.stats = np.zeros(12)
        self._img_results: Dict = {}

    # -- per-image matching -------------------------------------------------
    def _compute_ious(self, img_id: int, cat_id: int, max_det: int):
        """Score-sorted capped dets, raw-order gts, and their IoU matrix —
        computed ONCE per (image, category) and reused across the 4 area
        ranges (pycocotools caches computeIoU the same way; only the
        ignore-dependent matching below varies per range)."""
        gts = [g for g in self.cocoGt.img_to_anns[img_id]
               if g["category_id"] == cat_id]
        dts = [d for d in self.cocoDt.img_to_anns[img_id]
               if d["category_id"] == cat_id]
        if not gts and not dts:
            return None
        dt_order = np.argsort([-d["score"] for d in dts], kind="stable")
        dts = [dts[i] for i in dt_order[:max_det]]
        gt_boxes = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
        dt_boxes = np.array([d["bbox"] for d in dts], float).reshape(-1, 4)
        crowd = np.array([g.get("iscrowd", 0) for g in gts], int)
        ious = box_iou_xywh(dt_boxes, gt_boxes, crowd)
        return gts, dts, dt_boxes, crowd, ious

    def _evaluate_img(self, img_id: int, cat_id: int,
                      area_rng: Sequence[float], cached):
        p = self.params
        if cached is None:
            return None
        gts_raw, dts, dt_boxes, crowd_raw, ious_raw = cached

        for g in gts_raw:
            outside = (g["area"] < area_rng[0] or g["area"] > area_rng[1])
            g["_ignore"] = 1 if (g.get("ignore", 0) or
                                 g.get("iscrowd", 0) or outside) else 0

        # non-ignored GTs first (stable), then ignored; permute the cached
        # IoU columns to match (pycocotools: ious[:, gtind])
        gt_order = np.argsort([g["_ignore"] for g in gts_raw], kind="stable")
        gts = [gts_raw[i] for i in gt_order]
        crowd = crowd_raw[gt_order]
        ious = ious_raw[:, gt_order] if ious_raw.size else ious_raw

        t_n = len(p.iouThrs)
        gt_ig = np.array([g["_ignore"] for g in gts])
        gtm = -np.ones((t_n, len(gts)), int)
        dtm = -np.ones((t_n, len(dts)), int)
        dt_ig = np.zeros((t_n, len(dts)))
        for ti, thr in enumerate(p.iouThrs):
            for di in range(len(dts)):
                best = min(thr, 1 - 1e-10)
                match = -1
                for gi in range(len(gts)):
                    if gtm[ti, gi] >= 0 and not crowd[gi]:
                        continue
                    if match > -1 and not gt_ig[match] and gt_ig[gi]:
                        break  # remaining gts are all ignored
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    match = gi
                if match == -1:
                    continue
                dt_ig[ti, di] = gt_ig[match]
                dtm[ti, di] = match
                gtm[ti, match] = di
        # unmatched dets outside the area range are ignored
        d_areas = dt_boxes[:, 2] * dt_boxes[:, 3]
        outside = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ig = np.logical_or(
            dt_ig, np.logical_and(dtm < 0, outside[None, :]))
        return {
            "dtScores": np.array([d["score"] for d in dts]),
            "dtMatches": dtm,
            "dtIgnore": dt_ig,
            "gtIgnore": gt_ig,
        }

    def evaluate(self) -> None:
        p = self.params
        max_det = max(p.maxDets)
        self._img_results = {}
        for cat in p.catIds:
            for img in p.imgIds:
                cached = self._compute_ious(img, cat, max_det)
                for ai, area in enumerate(p.areaRng):
                    self._img_results[(cat, ai, img)] = self._evaluate_img(
                        img, cat, area, cached)

    # -- accumulation -------------------------------------------------------
    def accumulate(self) -> None:
        p = self.params
        t_n, r_n = len(p.iouThrs), len(p.recThrs)
        k_n, a_n, m_n = len(p.catIds), len(p.areaRng), len(p.maxDets)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))
        scores = -np.ones((t_n, r_n, k_n, a_n, m_n))

        for ki, cat in enumerate(p.catIds):
            for ai in range(a_n):
                results = [self._img_results.get((cat, ai, img))
                           for img in p.imgIds]
                results = [r for r in results if r is not None]
                if not results:
                    continue
                n_gt = sum(int((r["gtIgnore"] == 0).sum()) for r in results)
                for mi, max_det in enumerate(p.maxDets):
                    dt_scores = np.concatenate(
                        [r["dtScores"][:max_det] for r in results])
                    order = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores = dt_scores[order]
                    dtm = np.concatenate(
                        [r["dtMatches"][:, :max_det] for r in results],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [r["dtIgnore"][:, :max_det] for r in results],
                        axis=1)[:, order]
                    if n_gt == 0:
                        continue
                    tps = np.logical_and(dtm >= 0, ~dt_ig.astype(bool))
                    fps = np.logical_and(dtm < 0, ~dt_ig.astype(bool))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(t_n):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone-decreasing interpolation
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, p.recThrs, side="left")
                        q = np.zeros(r_n)
                        s = np.zeros(r_n)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                                s[ri] = dt_scores[pi]
                        precision[ti, :, ki, ai, mi] = q
                        scores[ti, :, ki, ai, mi] = s

        self.eval = {
            "params": p,
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # -- summary ------------------------------------------------------------
    def _summarize(self, ap: bool, iouThr: Optional[float] = None,
                   areaRng: str = "all", maxDets: int = 100) -> float:
        p = self.params
        ai = p.areaRngLbl.index(areaRng)
        mi = p.maxDets.index(maxDets)
        if ap:
            s = self.eval["precision"]
            if iouThr is not None:
                ti = int(np.where(np.isclose(p.iouThrs, iouThr))[0][0])
                s = s[ti:ti + 1]
            s = s[:, :, :, ai, mi]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                ti = int(np.where(np.isclose(p.iouThrs, iouThr))[0][0])
                s = s[ti:ti + 1]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        mean = float(valid.mean()) if valid.size else -1.0
        kind = "(AP)" if ap else "(AR)"
        thr = (f"{iouThr:0.2f}" if iouThr is not None
               else f"{p.iouThrs[0]:0.2f}:{p.iouThrs[-1]:0.2f}")
        print(f" Average {'Precision' if ap else 'Recall'} {kind} "
              f"@[ IoU={thr} | area={areaRng:>6s} | maxDets={maxDets:>3d} ]"
              f" = {mean:0.3f}")
        return mean

    def summarize(self) -> np.ndarray:
        s = self._summarize
        self.stats = np.array([
            s(True), s(True, 0.5), s(True, 0.75),
            s(True, areaRng="small"), s(True, areaRng="medium"),
            s(True, areaRng="large"),
            s(False, maxDets=1), s(False, maxDets=10), s(False, maxDets=100),
            s(False, areaRng="small"), s(False, areaRng="medium"),
            s(False, areaRng="large"),
        ])
        return self.stats
