"""In-memory counterparts of the JAX repo's synthetic training fixtures.

The JAX tools that train from scratch (``tools/smoke_e2e.py``,
``smoke_multiclass.py``, ``smoke_int8.py``, ``ablate_int8.py``,
``calib_study.py``, ``ablate_ema.py``) draw their images at 160² with a
numpy ``RandomState``, write them as JPEGs and read them back through
``COCODetection`` and ``BaseTransform``. The card's host has no cv2 and no
image decoder, so these fixtures make the same draws in memory:

  * ``coco_fixture(n, seed, size)``: the SSDD-like set of
    ``tests/data_fixtures.py:make_coco_dataset`` at ``img_size=160``, the
    same ``RandomState(seed)`` calls in the same order (noise in [0, 80),
    1-3 boxes of value 220, each ``w``, ``h`` from ``randint(12, 80)``,
    then ``x``, then ``y``); one class, "ship";
  * ``multiclass_fixture(size)``: the 16 images of
    ``tools/smoke_multiclass.py:38-58`` (``RandomState(0)``, noise in
    [0, 60), 1-3 boxes whose colour is the class), three classes.

Two differences from the JAX tools' pixels, both stated here because
they are the only ones:

  * there is no JPEG round trip: the JAX tools train on the decoded
    JPEG, whose pixels differ from the drawn ones by the codec's error;
  * the 160² draw is upsampled to the model's size once, here, by
    ``F.interpolate(mode="bilinear", align_corners=False)``, rounded and
    clamped to uint8, where JAX's ``BaseTransform`` resizes the float
    image with ``cv2.resize(INTER_LINEAR)`` and does not round (within one
    grey level of each other, tested). ``BaseTransform`` then meets an
    image already at its size and needs no cv2.

One writer makes files, as the JAX repo's does: ``make_voc_dataset``, the
port's copy of ``tests/data_fixtures.py:make_voc_dataset`` (a VOCdevkit
tree of JPEGs, XML annotations and an image-set list, with the same
``RandomState`` calls and silhouettes), for the VOC smoke through the real
CLIs (``tools/smoke_voc_e2e.py``). It draws and encodes through cv2, which
it imports when called: without cv2 it stops with an error that says so.

The training targets are the boxes as ``COCODetection`` sanitizes them at
160² (x2 = x1 + w - 1, y2 = y1 + h - 1), divided by 160, as the JAX tools
compute them (``tools/smoke_e2e.py:22-28``). The eval ground truth is in
the held image's own pixels (each 160² bbox scaled by ``size / 160``), so
``evaluate_detections`` runs the port's ``COCOeval`` on boxes the
Evaluator scales by the held image's size.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from refinedet_tpu_torch.data.coco_io import COCO
from refinedet_tpu_torch.data.sarship import COCODetection
from refinedet_tpu_torch.device import DeviceLike, resolve_device

DRAW_SIZE = 160  # the JAX tools draw every fixture at 160²
# tools/smoke_multiclass.py:40, BGR as cv2.imwrite takes it
COLORS = {1: (230, 60, 60), 2: (60, 230, 60), 3: (60, 60, 230)}
MULTICLASS_NAMES = ((1, "red"), (2, "green"), (3, "blue"))


def coco_draws(n: int, seed: int) -> Tuple[List[np.ndarray], Dict]:
    """``make_coco_dataset(root, num_images=n, img_size=160, seed=seed)``
    in memory: (the 160² uint8 images, the COCO dict it writes)."""
    rng = np.random.RandomState(seed)
    size = DRAW_SIZE
    images, infos, annotations = [], [], []
    for i in range(n):
        img_id = i + 1
        img = rng.randint(0, 80, (size, size, 3)).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):
            w = rng.randint(12, size // 2)
            h = rng.randint(12, size // 2)
            x = rng.randint(0, size - w)
            y = rng.randint(0, size - h)
            img[y:y + h, x:x + w] = 220
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id,
                "category_id": 1,
                "bbox": [float(x), float(y), float(w), float(h)],
                "area": float(w * h), "iscrowd": 0})
        images.append(img)
        infos.append({"id": img_id, "file_name": f"{img_id:06d}.jpg",
                      "width": size, "height": size})
    return images, {"images": infos, "annotations": annotations,
                    "categories": [{"id": 1, "name": "ship",
                                    "supercategory": "ship"}]}


def multiclass_draws() -> Tuple[List[np.ndarray], Dict]:
    """The draws of ``tools/smoke_multiclass.py:38-58``: (16 uint8 images
    of 160², the COCO dict it writes)."""
    rng = np.random.RandomState(0)
    images, infos, annotations = [], [], []
    for i in range(16):
        img_id = i + 1
        img = rng.randint(0, 60, (DRAW_SIZE, DRAW_SIZE, 3)).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):
            w, h = rng.randint(20, 70, 2)
            x, y = rng.randint(0, DRAW_SIZE - w), rng.randint(0, DRAW_SIZE - h)
            cls = rng.randint(1, 4)
            img[y:y + h, x:x + w] = COLORS[cls]
            annotations.append({"id": len(annotations) + 1,
                                "image_id": img_id, "category_id": cls,
                                "bbox": [float(x), float(y), float(w),
                                         float(h)],
                                "area": float(w * h), "iscrowd": 0})
        images.append(img)
        infos.append({"id": img_id, "file_name": f"{img_id:06d}.jpg",
                      "width": DRAW_SIZE, "height": DRAW_SIZE})
    return images, {"images": infos, "annotations": annotations,
                    "categories": [{"id": c, "name": n, "supercategory": "x"}
                                   for c, n in MULTICLASS_NAMES]}


def upsample(images: Sequence[np.ndarray], size: int,
             device: DeviceLike = "cuda") -> np.ndarray:
    """uint8 ``[N, 160, 160, 3]`` -> uint8 ``[N, size, size, 3]``: bilinear
    (``align_corners=False``, cv2's pixel centres) on ``device``, rounded
    and clamped."""
    x = torch.from_numpy(np.stack(images)).to(resolve_device(device))
    if x.shape[1] == size:
        return x.cpu().numpy()
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size),
                      mode="bilinear", align_corners=False)
    y = y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return y.contiguous().cpu().numpy()


def _scaled(coco: Dict, size: int) -> Dict:
    """The COCO dict with every image and bbox in ``size`` pixels."""
    s = size / DRAW_SIZE
    return {"images": [dict(im, width=size, height=size)
                       for im in coco["images"]],
            "annotations": [dict(a, bbox=[v * s for v in a["bbox"]],
                                 area=a["area"] * s * s)
                            for a in coco["annotations"]],
            "categories": coco["categories"]}


class FixtureDetection(COCODetection):
    """A drawn fixture at the model's ``size``: a ``COCODetection`` over
    an in-memory ``COCO`` in the held images' pixels (as
    ``tools/eval_check.py:SyntheticSSDD``), so ``evaluate_detections``
    runs the port's ``COCOeval``. ``images[i]`` is the uint8 BGR image at
    ``size``; ``targets[i]`` is (boxes [k, 4] float32 normalized point
    form, labels [k] int32), the training targets of the JAX tools."""

    def __init__(self, name: str, draws: Tuple[List[np.ndarray], Dict],
                 size: int, device: DeviceLike = "cuda"):
        images, coco = draws
        self.root = "synthetic"
        self.image_sets = [("synthetic", "train")]
        self.transform = None
        self.name = name
        self.seed = 0
        self.size = size
        self.ids, self.image_indexes, self.annotations = [], [], []
        self._cocos: List[COCO] = []
        self._add_image_set(COCO(_scaled(coco, size)), "synthetic_train")
        # The training targets: COCODetection's sanitization at 160².
        drawn = COCO(coco)
        scale = np.array([DRAW_SIZE] * 4, np.float32)
        self.targets = []
        for idx in self.image_indexes:
            rows = self._annotation_from_index(idx, drawn)
            self.targets.append((rows[:, :4] / scale,
                                 rows[:, 4].astype(np.int32)))
        self.images = list(upsample(images, size, device))

    def pull_image(self, index: int):
        return self.images[index], self.annotations[index].copy()


def coco_fixture(n: int, seed: int, size: int,
                 device: DeviceLike = "cuda") -> FixtureDetection:
    """The SSDD-like fixture of ``make_coco_dataset(num_images=n,
    img_size=160, seed=seed)`` at ``size`` (2 classes with background)."""
    return FixtureDetection(f"fixture_coco{n}_s{seed}", coco_draws(n, seed),
                            size, device)


def multiclass_fixture(size: int,
                       device: DeviceLike = "cuda") -> FixtureDetection:
    """The 16-image, three-colour fixture of ``tools/smoke_multiclass.py``
    at ``size`` (4 classes with background)."""
    return FixtureDetection("fixture_multiclass16", multiclass_draws(), size,
                            device)


def need_cv2(tool: str):
    """The cv2 module; without it a ``RuntimeError`` naming ``tool``."""
    try:
        import cv2
    except ImportError:  # the card's host has no image decoder
        raise RuntimeError(f"{tool} writes and reads JPEGs through cv2 "
                           "(opencv-python), which is not installed") \
            from None
    return cv2


def _draw_class_pattern(cv2, img, x, y, w, h, pattern):
    """One object of value 220 whose class is its silhouette (colour is
    randomized by the photometric augmentation, fine texture erased by
    Expand's shrink): 0 = filled rect, 1 = filled ellipse, 2 = filled
    triangle, 3 = thick cross."""
    v = 220
    k = pattern % 4
    if k == 0:
        img[y:y + h, x:x + w] = v
    elif k == 1:
        cv2.ellipse(img, (x + w // 2, y + h // 2), (w // 2, h // 2),
                    0, 0, 360, (v, v, v), -1)
    elif k == 2:
        pts = np.array([[x + w // 2, y], [x, y + h - 1],
                        [x + w - 1, y + h - 1]], np.int32)
        cv2.fillPoly(img, [pts], (v, v, v))
    else:
        tw, th = max(3, w // 3), max(3, h // 3)
        cx, cy = x + (w - tw) // 2, y + (h - th) // 2
        img[y:y + h, cx:cx + tw] = v
        img[cy:cy + th, x:x + w] = v


def make_voc_dataset(root: str, year: str = "2007",
                     image_set: str = "trainval", num_images: int = 4,
                     img_size: int = 96, seed: int = 0,
                     classes: Sequence[str] = ("aeroplane", "bicycle"),
                     class_patterns: bool = False) -> List[str]:
    """Write ``root/VOC<year>``: ``JPEGImages/<id>.jpg`` (noise in [0, 80)
    with 1-2 objects of value 220), ``Annotations/<id>.xml`` (1-based
    inclusive boxes, none difficult) and ``ImageSets/Main/<image_set>.txt``;
    returns the ids. The objects are rectangles at least 14 px wide and
    high, or with ``class_patterns`` each class's silhouette, at least a
    quarter of the image wide and high."""
    cv2 = need_cv2("make_voc_dataset")
    rng = np.random.RandomState(seed)
    base = osp.join(root, "VOC" + year)
    for sub in ("JPEGImages", "Annotations",
                osp.join("ImageSets", "Main")):
        os.makedirs(osp.join(base, sub), exist_ok=True)
    ids = []
    for i in range(num_images):
        img_id = f"{i:06d}"
        ids.append(img_id)
        img = rng.randint(0, 80, (img_size, img_size, 3)).astype(np.uint8)
        objs = []
        for _ in range(rng.randint(1, 3)):
            lo = img_size // 4 if class_patterns else 14
            w = rng.randint(lo, img_size // 2)
            h = rng.randint(lo, img_size // 2)
            x = rng.randint(0, img_size - w)
            y = rng.randint(0, img_size - h)
            ci = rng.randint(len(classes))
            if class_patterns:
                _draw_class_pattern(cv2, img, x, y, w, h, ci)
            else:
                img[y:y + h, x:x + w] = 220
            rng.uniform()  # the JAX writer's draw for the difficult flag
            objs.append(
                f"<object><name>{classes[ci]}</name><pose>Unspecified</pose>"
                f"<truncated>0</truncated><difficult>0</difficult>"
                f"<bndbox><xmin>{x + 1}</xmin><ymin>{y + 1}</ymin>"
                f"<xmax>{x + w}</xmax><ymax>{y + h}</ymax></bndbox>"
                f"</object>")
        cv2.imwrite(osp.join(base, "JPEGImages", img_id + ".jpg"), img)
        xml = (f"<annotation><filename>{img_id}.jpg</filename>"
               f"<size><width>{img_size}</width>"
               f"<height>{img_size}</height><depth>3</depth></size>"
               + "".join(objs) + "</annotation>")
        with open(osp.join(base, "Annotations", img_id + ".xml"), "w") as f:
            f.write(xml)
    with open(osp.join(base, "ImageSets", "Main", image_set + ".txt"),
              "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids
