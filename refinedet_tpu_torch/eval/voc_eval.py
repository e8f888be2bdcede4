"""PASCAL VOC detection AP evaluation.

The port's own copy of ``refinedet_tpu/eval/voc_eval.py``, quirks intact
(the counterpart of the reference's ``eval_refinedet_voc.py:148-363``):
per-class result-file writing in the official VOC format, greedy
IoU>thresh matching with difficult-object handling, and both AP
conventions (11-point VOC2007 metric and the every-point AUC). Operates
on in-memory structures; the txt file round-trip is optional (kept for
tooling compatibility).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Sequence, Tuple

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = True) -> float:
    """AP from recall/precision curves (eval_refinedet_voc.py:196-363
    semantics)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(np.max(prec[rec >= t])) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Matching IoU of one detection vs many GT boxes.

    NOTE: this reference fork's ``voc_eval`` DROPS the VOC devkit's
    +1-pixel area convention (eval_refinedet_voc.py:330-336 — plain
    ``ixmax - ixmin``, areas without +1), unlike the Fast-R-CNN-lineage
    original and unlike the fork's own NMS path. Reproduced as-is for
    numerical parity (tests/test_voc_eval_reference_parity.py holds the
    JAX package's copy to the reference, tests/test_torch_port_eval.py
    this one to the JAX package's).
    """
    ixmin = np.maximum(boxes[:, 0], box[0])
    iymin = np.maximum(boxes[:, 1], box[1])
    ixmax = np.minimum(boxes[:, 2], box[2])
    iymax = np.minimum(boxes[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin, 0.0)
    ih = np.maximum(iymax - iymin, 0.0)
    inter = iw * ih
    union = ((box[2] - box[0]) * (box[3] - box[1]) +
             (boxes[:, 2] - boxes[:, 0]) *
             (boxes[:, 3] - boxes[:, 1]) - inter)
    return inter / union


def voc_eval_class(detections: Sequence[Tuple[str, float, np.ndarray]],
                   gt: Dict[str, dict], ovthresh: float = 0.5,
                   use_07_metric: bool = True, det_shift: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Evaluate one class.

    Args:
      detections: list of (image_id, score, box[x1,y1,x2,y2]).
      gt: image_id -> {"bbox": [G,4], "difficult": [G] bool}.
      det_shift: added to every detection coordinate before matching.
        The reference's end-to-end chain inherits an off-by-one from
        ssd.pytorch: result files are written 1-based
        (eval_refinedet_voc.py:160-162, ``+1`` on 0-based net outputs)
        while ``parse_rec`` converts the XML GT back to 0-based
        (:117-120), so its IoU sees detections shifted by (+1, +1)
        relative to GT. ``evaluate_voc`` passes 1.0 to reproduce the
        reference's reported numbers exactly
        (tests/test_voc_eval_reference_parity.py).
    Returns (recall, precision, ap).
    """
    # per-image match state
    cls_gt = {}
    npos = 0
    for img_id, g in gt.items():
        difficult = np.asarray(g["difficult"], bool)
        npos += int((~difficult).sum())
        cls_gt[img_id] = {
            "bbox": np.asarray(g["bbox"], float).reshape(-1, 4),
            "difficult": difficult,
            "det": np.zeros(len(difficult), bool),
        }

    order = np.argsort([-score for _, score, _ in detections],
                       kind="mergesort")
    tp = np.zeros(len(detections))
    fp = np.zeros(len(detections))
    for rank, di in enumerate(order):
        img_id, _, box = detections[di]
        g = cls_gt.get(img_id)
        if g is None or len(g["bbox"]) == 0:
            fp[rank] = 1.0
            continue
        overlaps = _iou_one_to_many(np.asarray(box, float) + det_shift,
                                    g["bbox"])
        jmax = int(np.argmax(overlaps))
        if overlaps[jmax] > ovthresh:
            if g["difficult"][jmax]:
                continue  # neither TP nor FP
            if not g["det"][jmax]:
                tp[rank] = 1.0
                g["det"][jmax] = True
            else:
                fp[rank] = 1.0
        else:
            fp[rank] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / max(npos, 1)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def write_voc_results_files(all_boxes, image_ids: Sequence[str],
                            class_names: Sequence[str],
                            out_dir: str) -> Dict[str, str]:
    """Write the official per-class result txt files
    (``comp4_det_test_<class>.txt``; eval_refinedet_voc.py:148-162)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for cls_ind, cls in enumerate(class_names):
        path = osp.join(out_dir, f"comp4_det_test_{cls}.txt")
        paths[cls] = path
        with open(path, "w") as f:
            for im_ind, img_id in enumerate(image_ids):
                dets = np.asarray(all_boxes[cls_ind + 1][im_ind])
                for k in range(dets.shape[0] if dets.size else 0):
                    # VOC writes 1-based pixel coords
                    f.write(f"{img_id} {dets[k, 4]:.3f} "
                            f"{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} "
                            f"{dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n")
    return paths


def evaluate_voc(all_boxes, dataset, class_names: Sequence[str],
                 ovthresh: float = 0.5, use_07_metric: bool = True,
                 verbose: bool = True,
                 det_shift: float = 1.0) -> Dict[str, float]:
    """Full VOC mAP over a VOCDetection dataset.

    all_boxes[class_index][image_index] = [N, 5] (x1, y1, x2, y2, score)
    with class_index 1-based (0 = background), matching the reference's
    all_boxes layout. ``det_shift=1.0`` reproduces the reference chain's
    1-based-result-file vs 0-based-GT matching offset (see
    voc_eval_class); pass 0.0 for geometrically aligned matching.
    """
    # Gather GT per class (incl. difficult flags) from the dataset.
    gts: List[Dict[str, dict]] = [dict() for _ in class_names]
    for i in range(len(dataset)):
        img_id, boxes, labels0, difficult = dataset.pull_anno_full(i)
        for box, cls0, diff in zip(boxes, labels0, difficult):
            g = gts[int(cls0)].setdefault(str(img_id),
                                          {"bbox": [], "difficult": []})
            g["bbox"].append(box)
            g["difficult"].append(bool(diff))

    aps = {}
    for cls_ind, cls in enumerate(class_names):
        dets = []
        for im_ind in range(len(dataset)):
            img_id = dataset.ids[im_ind][1]
            rows = np.asarray(all_boxes[cls_ind + 1][im_ind])
            for k in range(rows.shape[0] if rows.size else 0):
                dets.append((str(img_id), float(rows[k, 4]), rows[k, :4]))
        _, _, ap = voc_eval_class(dets, gts[cls_ind], ovthresh,
                                  use_07_metric, det_shift=det_shift)
        aps[cls] = ap
        if verbose:
            print(f"AP for {cls} = {ap:.4f}")
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    if verbose:
        print(f"Mean AP = {mean_ap:.4f}")
    aps["mAP"] = mean_ap
    return aps
