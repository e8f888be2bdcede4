"""PASCAL VOC detection dataset (pure Python + cv2, no torch).

Port of ``refinedet_tpu/data/voc.py``, the counterpart of the reference's
``data/voc0712.py``: XML annotation parsing
(1-based pixels -> 0-based, difficult filtering), multi-imageset roots, and
the raw accessors (pull_image / pull_anno) used by the VOC evaluator.

Label convention: this framework uses **1-based foreground labels
everywhere** (0 = background), matching the sarship loader
(sarship_coco.py:160-173) and the no-offset ``refine_match``
(box_utils.py:153-156). The reference's VOC loader emits 0-based labels,
which silently maps class 0 to background through refine_match — a
reference-lineage bug this build fixes by shifting +1 here. Boxes are
absolute pixels (the convention SSDAugmentation expects).
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # a host without cv2 can still import the module
    cv2 = None

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


class VOCAnnotationTransform:
    """Parse a VOC XML root into [N, 5] (x1, y1, x2, y2, label).

    Coordinates become 0-based absolute pixels; labels are 1-based
    foreground ids. Difficult objects are skipped unless keep_difficult.
    """

    def __init__(self, class_to_ind: Optional[dict] = None,
                 keep_difficult: bool = False):
        self.class_to_ind = class_to_ind or {
            c: i for i, c in enumerate(VOC_CLASSES)}
        self.keep_difficult = keep_difficult

    def __call__(self, target: ET.Element) -> np.ndarray:
        rows = []
        for obj in target.iter("object"):
            diff = obj.find("difficult")
            if (not self.keep_difficult and diff is not None
                    and int(diff.text) == 1):
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            coords = [int(float(bb.find(k).text)) - 1
                      for k in ("xmin", "ymin", "xmax", "ymax")]
            rows.append(coords + [self.class_to_ind[name] + 1])
        if not rows:
            return np.zeros((0, 5), np.float32)
        return np.asarray(rows, np.float32)


class VOCDetection:
    """VOC dataset over one or more (year, imageset) roots.

    ``__getitem__`` returns (image [H,W,3] float32, boxes [N,4] absolute,
    labels [N] int32 1-based) after the optional ``transform``
    (SSDAugmentation signature). Raw accessors mirror voc0712.py:142-184.
    """

    def __init__(self, root: str,
                 image_sets: Sequence[Tuple[str, str]] = (
                     ("2007", "trainval"), ("2012", "trainval")),
                 transform=None,
                 target_transform: Optional[VOCAnnotationTransform] = None,
                 dataset_name: str = "VOC0712",
                 seed: int = 0):
        self.root = root
        self.image_sets = list(image_sets)
        self.transform = transform
        self.target_transform = target_transform or VOCAnnotationTransform()
        self.name = dataset_name
        self.seed = seed
        self.epoch = 0
        self.ids: List[Tuple[str, str]] = []
        for year, setname in self.image_sets:
            base = osp.join(root, "VOC" + year)
            listfile = osp.join(base, "ImageSets", "Main", setname + ".txt")
            with open(listfile) as f:
                for line in f:
                    self.ids.append((base, line.strip()))

    def __len__(self) -> int:
        return len(self.ids)

    def _paths(self, index: int) -> Tuple[str, str]:
        base, img_id = self.ids[index]
        return (osp.join(base, "JPEGImages", img_id + ".jpg"),
                osp.join(base, "Annotations", img_id + ".xml"))

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-sample augmentation RNG stream (see
        COCODetection.set_epoch — called by the DataLoader each epoch)."""
        self.epoch = int(epoch)

    def __getitem__(self, index: int):
        img_path, ann_path = self._paths(index)
        img = cv2.imread(img_path)  # BGR HWC uint8
        target = self.target_transform(ET.parse(ann_path).getroot())
        boxes, labels = target[:, :4], target[:, 4].astype(np.int32)
        if self.transform is not None:
            # Deterministic given (seed, epoch, index) — reproducible and
            # multi-host-consistent, unlike an OS-entropy default_rng().
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, index]))
            img, boxes, labels = self.transform(img, boxes, labels, rng)
        return img, boxes, labels

    # -- raw accessors (voc0712.py:142-184 parity) -------------------------
    def pull_image(self, index: int) -> np.ndarray:
        img_path, _ = self._paths(index)
        return cv2.imread(img_path, cv2.IMREAD_COLOR)

    def pull_anno(self, index: int):
        _, ann_path = self._paths(index)
        img_id = self.ids[index][1]
        target = self.target_transform(ET.parse(ann_path).getroot())
        # [x1, y1, x2, y2, 0-based-label] rows for the evaluator.
        rows = [[*t[:4], int(t[4]) - 1] for t in target]
        return img_id, rows

    def pull_tensor(self, index: int) -> np.ndarray:
        """Raw image as a [1, H, W, 3] float32 array (NHWC — the torch
        version returned CHW; voc0712.py:171-184 parity accessor)."""
        return self.pull_image(index).astype(np.float32)[None]

    def pull_anno_full(self, index: int):
        """All objects incl. difficult: (img_id, boxes [N,4],
        labels0 [N] 0-based, difficult [N] bool). For AP evaluation."""
        _, ann_path = self._paths(index)
        img_id = self.ids[index][1]
        boxes, labels, difficult = [], [], []
        for obj in ET.parse(ann_path).getroot().iter("object"):
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            boxes.append([int(float(bb.find(k).text)) - 1
                          for k in ("xmin", "ymin", "xmax", "ymax")])
            labels.append(self.target_transform.class_to_ind[name])
            d = obj.find("difficult")
            difficult.append(bool(int(d.text)) if d is not None else False)
        return (img_id, np.asarray(boxes, float).reshape(-1, 4),
                np.asarray(labels, np.int32),
                np.asarray(difficult, bool))
