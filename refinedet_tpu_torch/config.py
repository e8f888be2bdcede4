"""Model / anchor / training / detection configuration.

The port's own copy of ``refinedet_tpu/config.py``: the anchor tables
(``voc_refinedet``, ``coco_refinedet``), the training recipe
(``TrainConfig``), the post-processing knobs (``DetectConfig``) and the
dataset roots and means the train CLI defaults to. Plain dataclasses, no
framework imports.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

HOME = os.getcwd()
COCOroot = os.path.join(HOME, "data/SSDD/SSDD_coco")
VOC_ROOT = os.path.join(HOME, "data/VOCdevkit/")

# Per-channel pixel mean (BGR). The SAR-ship (COCO) recipe uses the SSDD
# mean on all channels; VOC and serving inputs use (104, 117, 123).
MEANS = (98.13131, 98.13131, 98.13131)
VOC_MEANS = (104, 117, 123)


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor-grid geometry for one input resolution (reference
    config-dict keys)."""

    num_classes: int
    feature_maps: Tuple[int, ...]
    min_dim: int
    steps: Tuple[int, ...]
    min_sizes: Tuple[int, ...]
    max_sizes: Tuple[int, ...]
    aspect_ratios: Tuple[Tuple[int, ...], ...]
    variance: Tuple[float, float] = (0.1, 0.2)
    clip: bool = True
    name: str = "RefineDet"
    lr_steps: Tuple[int, ...] = ()
    max_iter: int = 120000

    def __post_init__(self):
        for v in self.variance:
            if v <= 0:
                raise ValueError("Variances must be greater than 0")

    @property
    def num_priors_per_cell(self) -> Tuple[int, ...]:
        out = []
        for k in range(len(self.feature_maps)):
            n = 1  # aspect-ratio-1 box at min_size
            if self.max_sizes:
                n += 1  # geometric-mean box
            n += 2 * len(self.aspect_ratios[k])  # +/- sqrt(ar) pair per ratio
            out.append(n)
        return tuple(out)

    @property
    def num_priors(self) -> int:
        return sum(f * f * n
                   for f, n in zip(self.feature_maps, self.num_priors_per_cell))


def _refinedet_cfg(size: int, num_classes: int, name: str) -> AnchorConfig:
    # 896 is the five-source variant: an extra stride-4 conv3_3 source with
    # the min_size = 4 * step rule carried one level deeper.
    fm = {320: (40, 20, 10, 5), 512: (64, 32, 16, 8),
          896: (224, 112, 56, 28, 14)}[size]
    steps = (8, 16, 32, 64) if size != 896 else (4, 8, 16, 32, 64)
    min_sizes = ((32, 64, 128, 256) if size != 896
                 else (16, 32, 64, 128, 256))
    return AnchorConfig(
        num_classes=num_classes,
        feature_maps=fm,
        min_dim=size,
        steps=steps,
        min_sizes=min_sizes,
        max_sizes=(),
        aspect_ratios=tuple((2,) for _ in fm),
        variance=(0.1, 0.2),
        clip=True,
        name=name,
        lr_steps=(80000, 100000, 120000),
        max_iter=120000,
    )


voc_refinedet = {
    "320": _refinedet_cfg(320, 21, "RefineDet_VOC_320"),
    "512": _refinedet_cfg(512, 21, "RefineDet_VOC_512"),
    "896": _refinedet_cfg(896, 21, "RefineDet_VOC_896"),
}
coco_refinedet = {
    "320": _refinedet_cfg(320, 2, "RefineDet_COCO_320"),
    "512": _refinedet_cfg(512, 2, "RefineDet_COCO_512"),
    "896": _refinedet_cfg(896, 2, "RefineDet_COCO_896"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-recipe knobs (the train CLI's defaults). The compute dtype
    is the model's own (``build_refinedet(..., dtype=)``), so it has no
    field here. ``mean`` (BGR, as ``MEANS``) is read by the on-device
    augmentation only; the host transforms carry their own."""

    batch_size: int = 32
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    gamma: float = 0.1
    max_epoch: int = 300
    warmup_epochs: int = 5
    warmup_init_lr: float = 1e-6
    negpos_ratio: int = 3
    overlap_thresh: float = 0.5
    theta: float = 0.01  # ARM objectness filter for ODM positives
    max_boxes: int = 60  # static per-image GT padding
    grad_clip_norm: float = 0.0  # 0 = off (reference has no clipping)
    ema_decay: float = 0.0  # >0: keep an EMA of params (0 = off, like ref)
    on_device_augment: bool = False  # SSD augmentation inside the step
    mean: Tuple[float, float, float] = (104.0, 117.0, 123.0)
    num_workers: int = 8
    worker_processes: bool = False  # spawn-based workers (vs threads)
    seed: int = 0
    spatial_shards: int = 1  # >1: shard image H over devices


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Post-processing knobs (eval_refinedet_coco.py defaults)."""

    num_classes: int = 2
    top_k: int = 1000
    keep_top_k: int = 500
    conf_thresh: float = 0.01
    nms_thresh: float = 0.49
    objectness_thresh: float = 0.01
    variance: Tuple[float, float] = (0.1, 0.2)

    def __post_init__(self):
        if self.nms_thresh <= 0:
            raise ValueError("nms_threshold must be non negative.")
