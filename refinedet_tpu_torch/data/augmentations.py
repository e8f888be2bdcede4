"""SSD training augmentation pipeline (host-side, numpy/cv2, seedable).

Port of ``refinedet_tpu/data/augmentations.py``, the counterpart of the
reference's SSDAugmentation: photometric distortion, mean-filled expand,
IoU-constrained random crop with the center-keep rule, horizontal mirror,
percent coords, resize, mean subtraction.

Design differences from the reference (deliberate):
  * every random draw comes from an explicit ``np.random.Generator`` —
    the pipeline is deterministic given (seed, index), so input pipelines
    are reproducible and shardable across hosts;
  * coordinate convention is explicit: the reference disabled
    ``ToAbsoluteCoords`` (augmentations.py:407) because its live loader
    (sarship) emits absolute pixels while the VOC loader emits normalized
    coords — making VOC crops geometrically inconsistent. Here
    ``boxes_normalized=True`` converts up front so both datasets run the
    same (correct) geometry;
  * images flow HWC float32 BGR (cv2-native) through augmentation and are
    converted to the network's RGB layout at the very end.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # a host without cv2 can still import the module
    cv2 = None

# Crop sampler modes: (min_iou, max_iou); None = unconstrained
# (augmentations.py:223-233).
_CROP_MODES = (
    None,
    (0.1, None),
    (0.3, None),
    (0.7, None),
    (0.9, None),
    (None, None),
)

_CHANNEL_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2),
                  (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _iou_one_to_many(boxes: np.ndarray, rect: np.ndarray) -> np.ndarray:
    """IoU of each box against one rect. [N,4] x [4] -> [N]."""
    lt = np.maximum(boxes[:, :2], rect[:2])
    rb = np.minimum(boxes[:, 2:], rect[2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_r = (rect[2] - rect[0]) * (rect[3] - rect[1])
    return inter / (area_b + area_r - inter)


def photometric_distort(img: np.ndarray, rng: np.random.Generator
                        ) -> np.ndarray:
    """Brightness/contrast/saturation/hue jitter + channel shuffle.

    Mirrors PhotometricDistort (augmentations.py:377-398): brightness
    +/-32 always first, contrast randomly before or after the HSV leg,
    saturation/hue in HSV space, then a random channel permutation.
    Expects float32 BGR.
    """
    img = img.copy()
    if rng.integers(2):
        img += rng.uniform(-32, 32)

    contrast_first = bool(rng.integers(2))

    def contrast(im):
        if rng.integers(2):
            im *= rng.uniform(0.5, 1.5)
        return im

    if contrast_first:
        img = contrast(img)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    if rng.integers(2):
        img[:, :, 1] *= rng.uniform(0.5, 1.5)
    if rng.integers(2):
        img[:, :, 0] += rng.uniform(-18.0, 18.0)
        img[:, :, 0][img[:, :, 0] > 360.0] -= 360.0
        img[:, :, 0][img[:, :, 0] < 0.0] += 360.0
    img = cv2.cvtColor(img, cv2.COLOR_HSV2BGR)
    if not contrast_first:
        img = contrast(img)
    if rng.integers(2):
        perm = _CHANNEL_PERMS[rng.integers(len(_CHANNEL_PERMS))]
        img = img[:, :, perm]
    return img


def random_expand(img, boxes, mean, rng):
    """Mean-filled canvas expand, ratio in [1, 4) (augmentations.py:313-338)."""
    if rng.integers(2):
        return img, boxes
    h, w, c = img.shape
    ratio = rng.uniform(1, 4)
    left = int(rng.uniform(0, w * ratio - w))
    top = int(rng.uniform(0, h * ratio - h))
    canvas = np.empty((int(h * ratio), int(w * ratio), c), dtype=img.dtype)
    canvas[:] = mean
    canvas[top:top + h, left:left + w] = img
    boxes = boxes.copy()
    boxes[:, 0::2] += left
    boxes[:, 1::2] += top
    return canvas, boxes


def random_sample_crop(img, boxes, labels, rng, max_trials: int = 50):
    """IoU-constrained crop with center-keep rule (augmentations.py:209-310).

    Keeps the reference's exact constraint expression
    ``overlap.min() < min_iou and max_iou < overlap.max() -> retry``.
    """
    h, w, _ = img.shape
    while True:
        mode = _CROP_MODES[rng.integers(len(_CROP_MODES))]
        if mode is None:
            return img, boxes, labels
        if boxes.shape[0] == 0:
            # No GT (e.g. all-difficult VOC images, annotation-free COCO
            # images): the IoU/center constraints are vacuous and
            # overlap.min() on an empty array would crash — any crop is
            # acceptable, keep the image whole.
            return img, boxes, labels
        min_iou = -np.inf if mode[0] is None else mode[0]
        max_iou = np.inf if mode[1] is None else mode[1]

        for _ in range(max_trials):
            cw = rng.uniform(0.3 * w, w)
            ch = rng.uniform(0.3 * h, h)
            if ch / cw < 0.5 or ch / cw > 2:
                continue
            left = rng.uniform(0, w - cw)
            top = rng.uniform(0, h - ch)
            rect = np.array([int(left), int(top),
                             int(left + cw), int(top + ch)])
            overlap = _iou_one_to_many(boxes, rect)
            if overlap.min() < min_iou and max_iou < overlap.max():
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
            inside = ((rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1]) &
                      (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1]))
            if not inside.any():
                continue
            out = img[rect[1]:rect[3], rect[0]:rect[2]]
            kept = boxes[inside].copy()
            kept[:, :2] = np.maximum(kept[:, :2], rect[:2]) - rect[:2]
            kept[:, 2:] = np.minimum(kept[:, 2:], rect[2:]) - rect[:2]
            return out, kept, labels[inside]


def random_mirror(img, boxes, rng):
    """Horizontal flip w.p. 1/2 (augmentations.py:341-348)."""
    if rng.integers(2):
        _, w, _ = img.shape
        img = img[:, ::-1]
        boxes = boxes.copy()
        boxes[:, 0::2] = w - boxes[:, 2::-2]
    return img, boxes


class SSDAugmentation:
    """Full train-time pipeline; call with one image + absolute or
    normalized pixel boxes.

    Returns (image [size, size, 3] float32 RGB mean-subtracted,
    boxes [N, 4] normalized point-form, labels [N]).
    """

    def __init__(self, size: int = 320,
                 mean: Sequence[float] = (104, 117, 123),
                 boxes_normalized: bool = False,
                 to_rgb: bool = True):
        self.size = size
        self.mean = np.array(mean, dtype=np.float32)
        self.boxes_normalized = boxes_normalized
        self.to_rgb = to_rgb

    def __call__(self, img: np.ndarray, boxes: np.ndarray,
                 labels: np.ndarray,
                 rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng()
        img = img.astype(np.float32)
        boxes = boxes.astype(np.float32)
        h, w, _ = img.shape
        if self.boxes_normalized:
            boxes = boxes * np.array([w, h, w, h], np.float32)

        img = photometric_distort(img, rng)
        img, boxes = random_expand(img, boxes, self.mean, rng)
        img, boxes, labels = random_sample_crop(img, boxes, labels, rng)
        img, boxes = random_mirror(img, boxes, rng)

        h, w, _ = img.shape
        boxes = boxes / np.array([w, h, w, h], np.float32)
        img = cv2.resize(img, (self.size, self.size))
        img -= self.mean
        if self.to_rgb:
            img = img[:, :, ::-1]
        return np.ascontiguousarray(img, np.float32), boxes, labels


class BaseTransform:
    """Eval-time transform: resize + mean-sub (+ BGR->RGB), no geometry.

    Mirrors data/__init__.py:30-43 and the eval-side variant
    (eval_refinedet_coco.py:124-152) in one class; output is HWC RGB
    (the network's NHWC input layout — no channel-first swap).
    """

    def __init__(self, size: int, mean: Sequence[float] = (104, 117, 123),
                 to_rgb: bool = True):
        self.size = size
        self.mean = np.array(mean, dtype=np.float32)
        self.to_rgb = to_rgb

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.shape[:2] == (self.size, self.size):
            # cv2.resize to the same size copies (bit for bit, tested), so
            # an image already at the model's size needs no cv2.
            img = img.astype(np.float32)
        elif cv2 is None:
            raise RuntimeError(
                f"BaseTransform: resizing a {img.shape[1]}x{img.shape[0]} "
                f"image to {self.size}x{self.size} needs cv2, which is not "
                "installed")
        else:
            img = cv2.resize(img.astype(np.float32), (self.size, self.size),
                             interpolation=cv2.INTER_LINEAR)
        img -= self.mean
        if self.to_rgb:
            img = img[:, :, ::-1]
        return np.ascontiguousarray(img, np.float32)
