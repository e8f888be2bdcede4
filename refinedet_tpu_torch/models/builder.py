"""Model construction + phase wrapper.

Port of ``refinedet_tpu/models/builder.py``: ``build_refinedet(phase,
size, num_classes, use_bn=...)`` returns a ``RefineDetModel`` whose
``apply(images)`` gives the raw heads + priors in the 'train' phase, and
in the 'test' phase softmax over the float32 heads followed by the
detector. ``apply`` always runs the network in eval mode, as the JAX
package's does (``train=False`` in both phases): only
``raw_forward(..., train=True)``, which the train step calls, uses the
BN variant's batch statistics and moves its running ones.

Parameters are float32. ``dtype=torch.bfloat16`` runs the convolutions
in bf16 through autocast (L2Norm stays in float32 and the heads come out
in float32), which is the JAX package's bf16 mode.

``quant=True`` builds the int8 serving twin (``QuantConv2d`` trunk and
TCB, test phase only); ``quant/ptq.py:quantize_model`` fills it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from refinedet_tpu_torch.boxes.priors import generate_priors
from refinedet_tpu_torch.config import AnchorConfig, coco_refinedet, \
    voc_refinedet
from refinedet_tpu_torch.detect.detection import Detect_RefineDet, \
    detect_refinedet
from refinedet_tpu_torch.device import DeviceLike, resolve_device
from refinedet_tpu_torch.models.refinedet import RefineDet

SIZES = (320, 512, 896)  # 896: the five-source variant
DTYPES = (torch.float32, torch.bfloat16)


def anchor_config_for(size: int, num_classes: int) -> AnchorConfig:
    """VOC anchor table iff num_classes == 21, else the coco table, with
    ``num_classes`` set to the requested count."""
    table = voc_refinedet if num_classes == 21 else coco_refinedet
    cfg = table[str(size)]
    if cfg.num_classes != num_classes:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    return cfg


class RefineDetModel:
    """The network on its device, its priors, and the phase semantics.

    Usage::

      model = build_refinedet("test", 320, 21)        # on the card
      boxes, scores = model(images)                   # images NHWC
    """

    def __init__(self, phase: str, size: int, num_classes: int,
                 detector: Optional[Detect_RefineDet] = None,
                 use_bn: bool = False, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda", seed: int = 0,
                 quant: bool = False, quant_skip: Sequence[str] = ()):
        if phase not in ("train", "test"):
            raise ValueError(f"phase must be 'train' or 'test', got {phase!r}")
        if quant and phase != "test":
            raise ValueError("int8 quantization is an inference-only "
                             "serving mode; use phase='test'")
        if size not in SIZES:
            raise ValueError(f"supported sizes: {SIZES} (896 is the "
                             "five-source variant)")
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.phase = phase
        self.size = size
        self.num_classes = num_classes
        self.use_bn = use_bn
        self.dtype = dtype
        self.quant = quant
        self.quant_skip = tuple(quant_skip)
        self.device = resolve_device(device)
        self.cfg = anchor_config_for(size, num_classes)
        net = RefineDet(num_classes, size, use_bn, quant, quant_skip)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net = net.to(self.device,
                          memory_format=torch.channels_last).eval()
        self.priors = torch.from_numpy(generate_priors(self.cfg)).to(
            self.device)
        self.detect = detector

    def raw_forward(self, images: torch.Tensor, train: bool = False,
                    net: Optional[torch.nn.Module] = None):
        """Raw heads (arm_loc, arm_conf, odm_loc, odm_conf), float32, with
        the network in train mode iff ``train`` (BN: batch statistics, and
        the running ones move). ``net`` is a wrapper of ``self.net`` to
        call in its place (the train step's ``DistributedDataParallel``)."""
        net = self.net if net is None else net
        if net.training != train or self.net.training != train:
            net.train(train)
        with torch.autocast(device_type=self.device.type,
                            dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            return net(images)

    def apply(self, images: torch.Tensor):
        """Phase-dependent forward of NHWC ``images``."""
        heads = self.raw_forward(images)
        if self.phase == "train":
            return (*heads, self.priors)
        arm_loc, arm_conf, odm_loc, odm_conf = heads
        arm_probs = torch.softmax(arm_conf, dim=-1)
        odm_probs = torch.softmax(odm_conf, dim=-1)
        if self.detect is not None:
            return self.detect.forward(arm_loc, arm_probs, odm_loc,
                                       odm_probs, self.priors)
        return detect_refinedet(arm_loc, arm_probs, odm_loc, odm_probs,
                                self.priors)

    __call__ = apply


def build_refinedet(phase: str, size: int = 320, num_classes: int = 21,
                    detector: Optional[Detect_RefineDet] = None,
                    use_bn: bool = False,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = "cuda",
                    seed: int = 0, quant: bool = False,
                    quant_skip: Sequence[str] = ()) -> RefineDetModel:
    """Build RefineDet on ``device`` (the card unless ``device="cpu"``)
    with weights drawn from ``seed``; load trained weights with
    ``model.net.load_state_dict(state, strict=True)``. ``quant=True``
    builds the int8 serving twin, ``quant_skip`` (flax names) keeps the
    named convs unquantized."""
    return RefineDetModel(phase, size, num_classes, detector=detector,
                          use_bn=use_bn, dtype=dtype, device=device,
                          seed=seed, quant=quant, quant_skip=quant_skip)


def build_refinedet_bn(phase: str, size: int = 320, num_classes: int = 21,
                       detector: Optional[Detect_RefineDet] = None,
                       dtype: torch.dtype = torch.float32,
                       device: DeviceLike = "cuda",
                       seed: int = 0, quant: bool = False,
                       quant_skip: Sequence[str] = ()) -> RefineDetModel:
    """The BN variant (the reference's ``refinedet_bn.py`` builder)."""
    return RefineDetModel(phase, size, num_classes, detector=detector,
                          use_bn=True, dtype=dtype, device=device, seed=seed,
                          quant=quant, quant_skip=quant_skip)
