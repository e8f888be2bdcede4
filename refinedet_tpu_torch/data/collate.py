"""Batch assembly with static-shape target padding.

Port of ``refinedet_tpu/data/collate.py`` (numpy only). Instead of the
reference's Python list of ragged target tensors, targets are padded to a
fixed ``max_boxes`` with a validity mask, so a batch is four fixed-shape
arrays that the batched matcher and losses consume directly.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np


class Batch(NamedTuple):
    images: np.ndarray   # [B, H, W, 3] float32
    boxes: np.ndarray    # [B, M, 4] float32, normalized point-form
    labels: np.ndarray   # [B, M] int32, 1-based foreground (0 pad)
    valid: np.ndarray    # [B, M] bool


def pad_targets(boxes: np.ndarray, labels: np.ndarray,
                max_boxes: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad one image's targets to [max_boxes]; overflow is truncated."""
    n = min(len(boxes), max_boxes)
    b = np.zeros((max_boxes, 4), np.float32)
    l = np.zeros((max_boxes,), np.int32)
    v = np.zeros((max_boxes,), bool)
    b[:n] = boxes[:n]
    l[:n] = labels[:n]
    v[:n] = True
    return b, l, v


def pad_batch(batch: Batch, batch_size: int) -> Batch:
    """Pad a partial batch to ``batch_size`` with all-invalid samples.

    Restores the reference's trailing-partial-batch epoch semantics
    (``epoch_size = math.ceil(len(dataset)/batch_size)``,
    in the reference's train script) under static shapes: a
    padded sample has ``valid`` all-False, so matching yields zero
    positives, hard-negative mining selects ``3*0 = 0`` negatives, and the
    losses normalize by the batch-total positive count — the padded rows
    contribute exactly zero loss AND zero gradient, making the padded
    full-size step numerically identical to the reference's partial batch
    (tested in tests/test_trainer.py). Only BN batch statistics would see
    the zero images.
    """
    n = batch.images.shape[0]
    if n >= batch_size:
        return batch

    def z(a: np.ndarray) -> np.ndarray:
        pad = np.zeros((batch_size - n,) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad], axis=0)

    return Batch(z(batch.images), z(batch.boxes), z(batch.labels),
                 z(batch.valid))


def detection_collate(samples: Sequence[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]],
                      max_boxes: int = 60) -> Batch:
    """Stack (image, boxes, labels) samples into one fixed-shape Batch.

    Image dtype is preserved: uint8-staged pixels (on-device augmentation
    path) stay uint8 so the host->device transfer is 4x smaller; float
    transforms stay float32.
    """
    images = np.stack([s[0] for s in samples])
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    bs, ls, vs = [], [], []
    for _, boxes, labels in samples:
        b, l, v = pad_targets(boxes, labels, max_boxes)
        bs.append(b); ls.append(l); vs.append(v)
    return Batch(images, np.stack(bs), np.stack(ls), np.stack(vs))
