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

The training targets are the boxes as ``COCODetection`` sanitizes them at
160² (x2 = x1 + w - 1, y2 = y1 + h - 1), divided by 160, as the JAX tools
compute them (``tools/smoke_e2e.py:22-28``). The eval ground truth is in
the held image's own pixels (each 160² bbox scaled by ``size / 160``), so
``evaluate_detections`` runs the port's ``COCOeval`` on boxes the
Evaluator scales by the held image's size.
"""

from __future__ import annotations

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
