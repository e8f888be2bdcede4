"""In-memory eval sets, made from a numpy seed, for scoring on the card.

Used by ``chip_smoke.py`` (phase 7) and ``tests/test_torch_port_gpu.py``.
The card's host has no cv2 and no image files, so these sets hold their
images in memory, already at the model's size (``BaseTransform`` then
needs no resize), drawn as ``train_check.SyntheticDetection`` draws them:
uint8 BGR pixel noise in [0, 80) with 1-8 boxes of value 220, and
absolute-pixel ground truth. Their eval hooks are the real ones:

  * ``SyntheticSSDD``: an SSDD-like 2-class set (one class, "ship"), a
    ``COCODetection`` whose index is the port's ``coco_io.COCO`` built from
    an in-memory dict, so ``evaluate_detections`` runs the port's
    ``COCOeval`` on it;
  * ``SyntheticVOC``: a VOC-like 21-class set with ``pull_image``,
    ``ids`` and ``pull_anno_full`` (a few objects marked difficult), for
    ``eval.voc_eval.evaluate_voc``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from refinedet_tpu_torch.data.coco_io import COCO
from refinedet_tpu_torch.data.sarship import COCODetection
from refinedet_tpu_torch.data.voc import VOC_CLASSES


def draw_image(rng: np.random.Generator, size: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(image [size, size, 3] uint8 BGR, boxes [k, 4] int x, y, w, h),
    k in 1..8, each box's side 8-50% of the image."""
    img = rng.integers(0, 80, (size, size, 3)).astype(np.uint8)
    k = int(rng.integers(1, 9))
    wh = np.maximum((rng.uniform(0.08, 0.5, (k, 2)) * size).astype(int), 2)
    xy = (rng.uniform(0.0, 1.0, (k, 2)) * (size - wh)).astype(int)
    for (x, y), (w, h) in zip(xy, wh):
        img[y:y + h, x:x + w] = 220
    return img, np.concatenate([xy, wh], 1)


class SyntheticSSDD(COCODetection):
    """``n`` SSDD-like images of ``size``² from ``seed``; category 1,
    "ship". GT boxes are the drawn rectangles (COCO xywh, sanitized to
    x1, y1, x2 = x1 + w - 1, y2 = y1 + h - 1 by ``COCODetection``)."""

    def __init__(self, n: int, size: int = 512, seed: int = 0):
        self.root = "synthetic"
        self.image_sets = [("synthetic", "test")]
        self.transform = None
        self.name = f"synthetic_ssdd{n}"
        self.seed = seed
        self.ids, self.image_indexes, self.annotations = [], [], []
        self._cocos: List[COCO] = []
        self.images = []
        images, anns = [], []
        for i in range(n):
            img, boxes = draw_image(np.random.default_rng([seed, i]), size)
            self.images.append(img)
            images.append({"id": i + 1, "file_name": f"{i + 1:06d}.jpg",
                           "width": size, "height": size})
            for x, y, w, h in boxes.tolist():
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": 1,
                             "bbox": [float(x), float(y), float(w),
                                      float(h)],
                             "area": float(w * h), "iscrowd": 0})
        coco = COCO({"images": images, "annotations": anns,
                     "categories": [{"id": 1, "name": "ship",
                                     "supercategory": "ship"}]})
        self._add_image_set(coco, "synthetic_test")

    def pull_image(self, index: int):
        return self.images[index], self.annotations[index].copy()


class SyntheticVOC:
    """``n`` VOC-like images of ``size``² from ``seed``: each box one of
    the 20 VOC classes, about one in ten marked difficult. Boxes are
    0-based inclusive pixels (x1, y1, x1 + w - 1, y1 + h - 1), as
    ``VOCDetection.pull_anno_full`` gives them."""

    def __init__(self, n: int, size: int = 320, seed: int = 0):
        self.name = f"synthetic_voc{n}"
        self.ids = [("synthetic", f"{i:06d}") for i in range(n)]
        self.images, self.annos = [], []
        for i in range(n):
            rng = np.random.default_rng([seed, i])
            img, boxes = draw_image(rng, size)
            k = len(boxes)
            xyxy = np.concatenate([boxes[:, :2],
                                   boxes[:, :2] + boxes[:, 2:] - 1], 1)
            labels0 = rng.integers(0, len(VOC_CLASSES), k).astype(np.int32)
            difficult = rng.uniform(size=k) < 0.1
            self.images.append(img)
            self.annos.append((self.ids[i][1], xyxy.astype(float), labels0,
                               difficult))

    def __len__(self) -> int:
        return len(self.ids)

    def pull_image(self, index: int) -> np.ndarray:
        return self.images[index]

    def pull_anno_full(self, index: int):
        img_id, boxes, labels0, difficult = self.annos[index]
        return img_id, boxes.copy(), labels0.copy(), difficult.copy()
