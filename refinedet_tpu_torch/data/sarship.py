"""COCO-format detection dataset (SSDD SAR-ship + generic COCO json).

Port of ``refinedet_tpu/data/sarship.py``, the counterpart of the
reference's live loader ``data/sarship_coco.py`` (COCODetection) and the
stock ``data/coco.py``: COCO-json annotation loading with bbox
sanitization, absolute-pixel targets with 1-based labels, the raw
accessor, and the built-in COCO evaluator (``evaluate_detections`` ->
the port's numpy COCOeval stats [AP, AP50, AP75, APs, APm, APl, AR...]).

Differences from the reference (deliberate):
  * pure-Python COCO index (refinedet_tpu_torch.data.coco_io) instead of
    pycocotools; no pickle roidb cache — annotation parsing is fast enough
    and caches are a staleness hazard (sarship_coco.py:119-132);
  * deterministic per-index RNG for augmentation.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # a host without cv2 can still import the module
    cv2 = None

from refinedet_tpu_torch.data.coco_io import COCO
from refinedet_tpu_torch.eval.coco_eval import COCOeval


class COCODetection:
    """COCO-json dataset emitting absolute-pixel [x1,y1,x2,y2] + 1-based
    labels, mirroring sarship_coco.py:160-173.

    This one class covers BOTH of the reference's COCO loaders: the live
    SSDD loader (the reference's ``data/sarship_coco.py``) and the stock
    disabled one (its ``data/coco.py`` with its 91->80 label
    table ``get_label_map``/``coco_labels.txt``, data/coco.py:33-39) —
    ``_cat_id_to_class_ind`` below derives the contiguous 1-based mapping
    from the json's own category list, so non-contiguous COCO category ids
    (stock 2014/2017 jsons included) need no hand-maintained table.

    ``image_sets`` is a list of (dataset_dir_name, split) pairs, e.g.
    [("sarship", "train")] -> annotations/instances_sarship_train.json with
    images under root/sarship_train/ (the reference's layout: image dir ==
    coco_name).
    """

    def __init__(self, root: str,
                 image_sets: Sequence[Tuple[str, str]] = (("sarship",
                                                           "train"),),
                 transform=None, dataset_name: str = "COCO",
                 seed: int = 0):
        self.root = root
        self.image_sets = list(image_sets)
        self.transform = transform
        self.name = dataset_name
        self.seed = seed

        self.ids: List[str] = []          # image paths
        self.image_indexes: List[int] = []  # coco image ids
        self.annotations: List[np.ndarray] = []
        self._cocos: List[COCO] = []

        for dataset, split in self.image_sets:
            coco_name = f"{dataset}_{split}"
            ann_file = osp.join(root, "annotations",
                                f"instances_{coco_name}.json")
            self._add_image_set(COCO(ann_file), coco_name)

    def _add_image_set(self, coco: COCO, coco_name: str) -> None:
        """Index one image set's annotations (images under
        root/coco_name/)."""
        self._COCO = coco  # last one wins, mirroring the reference
        self.coco_name = coco_name
        self._cocos.append(coco)

        cats = coco.loadCats(coco.getCatIds())
        self._classes = ["__background__"] + [c["name"] for c in cats]
        self.num_classes = len(self._classes)
        self._class_to_ind = {c: i for i, c in enumerate(self._classes)}
        self._class_to_coco_cat_id = {
            c["name"]: c["id"] for c in cats}
        self._cat_id_to_class_ind = {
            c["id"]: self._class_to_ind[c["name"]] for c in cats}

        indexes = coco.getImgIds()
        self.image_indexes.extend(indexes)
        for idx in indexes:
            fname = coco.loadImgs(idx)[0]["file_name"]
            self.ids.append(osp.join(self.root, coco_name, fname))
            self.annotations.append(
                self._annotation_from_index(idx, coco))

    def __len__(self) -> int:
        return len(self.ids)

    def _annotation_from_index(self, index: int, coco: COCO) -> np.ndarray:
        """[N, 5] rows (x1, y1, x2, y2, class>=1), sanitized to the image
        (sarship_coco.py:147-157: clamp to [0, dim-1], drop empty)."""
        im = coco.loadImgs(index)[0]
        width, height = im["width"], im["height"]
        rows = []
        for ann in coco.loadAnns(coco.getAnnIds(imgIds=index)):
            x, y, w, h = ann["bbox"]
            x1 = max(0.0, x)
            y1 = max(0.0, y)
            x2 = min(width - 1.0, x1 + max(0.0, w - 1))
            y2 = min(height - 1.0, y1 + max(0.0, h - 1))
            if ann.get("area", w * h) > 0 and x2 >= x1 and y2 >= y1:
                cls = self._cat_id_to_class_ind[ann["category_id"]]
                rows.append([x1, y1, x2, y2, cls])
        if not rows:
            return np.zeros((0, 5), np.float32)
        return np.asarray(rows, np.float32)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-sample augmentation RNG stream (called by the
        DataLoader each epoch so draws differ across epochs while staying
        deterministic given (seed, epoch, index))."""
        self.epoch = int(epoch)

    def __getitem__(self, index: int):
        img = cv2.imread(self.ids[index], cv2.IMREAD_COLOR)
        target = self.annotations[index]
        boxes = target[:, :4].copy()
        labels = target[:, 4].astype(np.int32)
        if self.transform is not None:
            rng = np.random.default_rng(
                np.random.SeedSequence(
                    [self.seed, getattr(self, "epoch", 0), index]))
            img, boxes, labels = self.transform(img, boxes, labels, rng)
        return img, boxes, labels

    # -- raw accessor (sarship_coco.py:207-231 parity) ---------------------
    def pull_image(self, index: int):
        img = cv2.imread(self.ids[index], cv2.IMREAD_COLOR)
        return img, self.annotations[index].copy()

    # -- evaluation (sarship_coco.py:279-347 parity) -----------------------
    def _results_list(self, all_boxes) -> List[dict]:
        """all_boxes[class][image] = [N, 5] (x1, y1, x2, y2, score)."""
        results = []
        for cls_ind, cls in enumerate(self._classes):
            if cls == "__background__":
                continue
            cat_id = self._class_to_coco_cat_id[cls]
            for im_ind, img_idx in enumerate(self.image_indexes):
                dets = np.asarray(all_boxes[cls_ind][im_ind],
                                  dtype=np.float64)
                if dets.size == 0:
                    continue
                # xyxy -> xywh with the reference's +1 convention
                # (sarship_coco.py:301-304).
                for k in range(dets.shape[0]):
                    x1, y1, x2, y2, score = dets[k]
                    results.append({
                        "image_id": int(img_idx),
                        "category_id": int(cat_id),
                        "bbox": [float(x1), float(y1),
                                 float(x2 - x1 + 1), float(y2 - y1 + 1)],
                        "score": float(score),
                    })
        return results

    def evaluate_detections(self, all_boxes,
                            output_dir: Optional[str] = None) -> np.ndarray:
        results = self._results_list(all_boxes)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            res_file = osp.join(
                output_dir, f"detections_{self.coco_name}_results.json")
            with open(res_file, "w") as f:
                json.dump(results, f)
        coco_dt = self._COCO.loadRes(results)
        coco_eval = COCOeval(self._COCO, coco_dt, "bbox")
        coco_eval.evaluate()
        coco_eval.accumulate()
        coco_eval.summarize()
        return coco_eval.stats
