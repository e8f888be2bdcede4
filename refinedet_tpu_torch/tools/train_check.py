"""Helpers that hold the training slice on the card against the CPU.

Used by ``chip_smoke.py`` (phase 6) and ``tests/test_torch_port_gpu.py``:

  * ``SyntheticDetection``: an in-memory dataset made from a numpy seed
    (mean-subtracted RGB images of pixel noise with 1-8 bright boxes each,
    normalized targets), so training runs without cv2 or image files;
  * ``StagedSyntheticDetection``: the same images as the on-device
    augmentation's host stage hands them on (uint8 RGB at the staging
    size, boxes in staging pixels), made without cv2;
  * ``crop_near_ties``: the images whose crop decision lies within a
    tolerance of a threshold (the augmentation's counterpart of
    ``separated_batch``'s margin);
  * ``separated_batch``: the first batch of a seed sequence on which a
    card-vs-CPU comparison of one step is well posed, i.e. no ODM match
    sits so close to a decision that the two devices' last-ulp
    differences in the heads could flip it;
  * ``one_step``: one full train step from the model's current weights,
    returning the metrics and each state_dict entry's update;
  * ``biases_before_bn``: the BN variant's conv biases whose gradient is
    zero (left out of relative comparisons);
  * ``conv_flops``: the forward's convolution FLOPs, counted from the
    port's own conv shapes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple

import numpy as np
import torch
from torch import nn

from refinedet_tpu_torch.boxes.codec import decode
from refinedet_tpu_torch.boxes.geometry import jaccard
from refinedet_tpu_torch.config import VOC_MEANS, TrainConfig
from refinedet_tpu_torch.data.augment import Draws, crop_trials
from refinedet_tpu_torch.data.collate import Batch, detection_collate
from refinedet_tpu_torch.train.train_step import (create_train_state,
                                                  make_optimizer,
                                                  make_train_step)

# A match decided by less than this (IoU against the threshold, or a GT's
# best anchor against its second best) could differ between devices.
MARGIN = 1e-4
# A crop test decided by less than this (pixels, or h/w against 1/2 and 2)
# could differ between devices.
CROP_MARGIN = 1e-5


def _painted(seed: int, i: int, size: int, num_classes: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Item i of ``seed``: (image [size, size, 3] float32 BGR, pixel noise
    in [0, 80) with k boxes of 220, boxes [k, 4] normalized point form,
    labels [k] int32 in 1..num_classes-1), k in 1..8."""
    rng = np.random.default_rng([seed, i])
    img = rng.integers(0, 80, (size, size, 3)).astype(np.float32)
    k = int(rng.integers(1, 9))
    wh = rng.uniform(0.08, 0.5, (k, 2))
    xy = rng.uniform(0.0, 1.0 - wh)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    for x1, y1, x2, y2 in (boxes * size).astype(int):
        img[y1:y2, x1:x2] = 220.0
    return img, boxes, rng.integers(1, num_classes, k).astype(np.int32)


class SyntheticDetection:
    """``n`` images of ``size``², made once from ``seed``; item i is
    (image [size, size, 3] float32 RGB minus ``mean``, boxes [k, 4]
    normalized point form, labels [k] int32 in 1..num_classes-1), k in
    1..8."""

    def __init__(self, n: int, size: int = 320, num_classes: int = 21,
                 seed: int = 0, mean=VOC_MEANS):
        self.name = f"synthetic{n}"
        self.items = []
        mean = np.asarray(mean, np.float32)
        for i in range(n):
            img, boxes, labels = _painted(seed, i, size, num_classes)
            self.items.append((np.ascontiguousarray((img - mean)[..., ::-1]),
                               boxes, labels))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int):
        return self.items[i]


class StagedSyntheticDetection(SyntheticDetection):
    """``SyntheticDetection``'s images as ``data.augment.StagingTransform``
    hands them to the loader: item i is (image [size, size, 3] uint8 RGB,
    boxes [k, 4] point form in staging pixels, labels), at ``size`` the
    staging size. For ``TrainConfig(on_device_augment=True)``."""

    def __init__(self, n: int, size: int = 640, num_classes: int = 21,
                 seed: int = 0):
        self.name = f"staged{n}"
        self.items = []
        for i in range(n):
            img, boxes, labels = _painted(seed, i, size, num_classes)
            self.items.append((np.ascontiguousarray(
                img[..., ::-1].astype(np.uint8)), boxes * size, labels))


def crop_near_ties(boxes: torch.Tensor, valid: torch.Tensor, draws: Draws,
                   w: float, h: float) -> torch.Tensor:
    """[B] bool: an image with a crop test within ``CROP_MARGIN`` of its
    threshold, where a last-ulp difference upstream could flip the trial
    taken or a kept box: a trial's h/w near 1/2 or 2, or a valid box's
    center near an edge of a trial rect or of the whole canvas (the
    center-keep rule). The IoU test never decides (its reference form
    cannot fail with max_iou = inf), and the floors take the same float32
    bits on every device."""
    t = crop_trials(boxes, valid, draws, w, h)
    aspect = torch.minimum((t.aspect - 0.5).abs(),
                           (t.aspect - 2.0).abs()).amin(1)
    rects = torch.cat([t.rects, t.canvas[:, None]], 1)  # [B, T + 1, 4]
    cx, cy = t.centers[:, None, :, 0], t.centers[:, None, :, 1]
    gap = torch.stack([(rects[..., i:i + 1] - c).abs() for i, c in
                       ((0, cx), (1, cy), (2, cx), (3, cy))]).amin(0)
    gap = torch.where(valid[:, None], gap, float("inf")).amin(-1).amin(-1)
    return (aspect < CROP_MARGIN) | (gap < CROP_MARGIN)


def _param_dtype(model) -> torch.dtype:
    return next(model.net.parameters()).dtype


def separated_batch(cpu_model, batch_size: int, max_boxes: int,
                    num_classes: int, theta: float, threshold: float,
                    seeds: Iterable[int] = range(40)) -> Tuple[int, Batch]:
    """The first seed whose batch (``SyntheticDetection(batch_size, seed)``)
    is separated by ``MARGIN`` on ``cpu_model``'s heads: every ODM IoU
    away from ``threshold``, every valid GT's best ODM anchor ahead of its
    second best, every ARM objectness away from ``theta``. ARM matching
    needs no check: it depends on the priors only, through IEEE-exact
    elementwise ops, so it is bitwise equal on both devices."""
    for seed in seeds:
        ds = SyntheticDetection(batch_size, cpu_model.size, num_classes,
                                seed)
        batch = detection_collate([ds[i] for i in range(len(ds))],
                                  max_boxes)
        # The step's own forward: train mode (BN on the batch statistics),
        # with the running statistics it moves put back.
        saved = [b.clone() for b in cpu_model.net.buffers()]
        images = torch.from_numpy(batch.images).to(_param_dtype(cpu_model))
        with torch.no_grad():
            arm_loc, arm_conf, _, _ = cpu_model.raw_forward(images,
                                                            train=True)
            for b, s in zip(cpu_model.net.buffers(), saved):
                b.copy_(s)
            anchors = decode(arm_loc, cpu_model.priors, cpu_model.cfg.variance)
            obj = torch.softmax(arm_conf, -1)[..., 1]
        if float((obj - theta).abs().min()) <= MARGIN:
            continue
        ok = True
        for b in range(batch_size):
            gt = torch.from_numpy(batch.boxes[b][batch.valid[b]])
            iou = jaccard(gt, anchors[b])
            top2 = iou.topk(2, dim=1).values
            if (float((iou - threshold).abs().min()) <= MARGIN
                    or float((top2[:, 0] - top2[:, 1]).min()) <= MARGIN):
                ok = False
                break
        if ok:
            return seed, batch
    raise RuntimeError("no separated batch among the seeds tried")


def one_step(model, batch: Batch, train_cfg: TrainConfig,
             lr: float) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """One train step of ``model`` (its weights are updated in place) at
    constant ``lr``: the metrics as floats, and each state_dict entry's
    update (after minus before; BN running statistics included) as a CPU
    tensor. The images take the dtype of the net's parameters (a net
    cast to float64 steps in float64)."""
    before = {k: v.detach().cpu().clone()
              for k, v in model.net.state_dict().items()}
    opt = make_optimizer(model.net.parameters(), lambda t: lr,
                         train_cfg.momentum, train_cfg.weight_decay,
                         train_cfg.grad_clip_norm)
    step = make_train_step(model, opt, train_cfg)
    tensors = [torch.from_numpy(a).to(model.device) for a in batch]
    tensors[0] = tensors[0].to(_param_dtype(model))
    _, metrics = step(create_train_state(model, opt), *tensors)
    after = model.net.state_dict()
    return ({k: float(v) for k, v in metrics.items()},
            {k: after[k].detach().cpu() - v for k, v in before.items()})


def update_rel_errors(got: Dict[str, torch.Tensor],
                      want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per state_dict entry, ||got - want|| / ||want||; an integer entry
    (BN's ``num_batches_tracked``) is 0 if equal, else inf."""
    return {k: float((got[k] - w).norm() / (w.norm() + 1e-12))
            if w.is_floating_point()
            else (0.0 if torch.equal(got[k], w) else float("inf"))
            for k, w in want.items()}


def biases_before_bn(net: nn.Module) -> Set[str]:
    """State_dict names of the conv biases that feed a BatchNorm. BN
    subtracts the batch mean, so their gradient is zero and their update
    is rounding noise, which no relative error can be taken of."""
    names = set()
    for list_name in ("vgg", "extras"):
        mods = getattr(net, list_name)
        for i in range(len(mods) - 1):
            if isinstance(mods[i], nn.Conv2d) and isinstance(
                    mods[i + 1], nn.BatchNorm2d):
                names.add(f"{list_name}.{i}.bias")
    return names


def conv_flops(net: nn.Module, images: torch.Tensor) -> int:
    """FLOPs of the convolutions of one forward of ``net`` on ``images``:
    2·Cin·Cout·k²·Hout·Wout per image for a conv, 2·Cin·Cout·k²·Hin·Win
    for a transposed conv (each input pixel scatters a k² patch). Only
    shapes are read: a net and images on the ``meta`` device do."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        kh, kw = mod.kernel_size
        per = 2 * mod.in_channels * mod.out_channels * kh * kw // mod.groups
        x = inputs[0] if isinstance(mod, nn.ConvTranspose2d) else out
        total += per * x.shape[0] * x.shape[2] * x.shape[3]

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            net(images)
    finally:
        for h in handles:
            h.remove()
    return total
