"""RefineDet320/512/896 network, plain or BN variant, as an ``nn.Module``.

Port of ``refinedet_tpu/models/refinedet.py``. The public layout is the
JAX package's: images NHWC ``[B, H, W, 3]`` in, heads ``arm_loc [B,P,4]``,
``arm_conf [B,P,2]``, ``odm_loc [B,P,4]``, ``odm_conf [B,P,C]`` out, in
float32. Inside, the NHWC input is viewed as NCHW with channels-last
strides, which is what cuDNN wants, and heads flatten in (h, w, anchor)
order (``permute(0, 2, 3, 1)`` before ``reshape``) so they line up with
the priors.

Variants, as in the JAX module:

  * ``use_bn``: a BatchNorm (flax's semantics, ``layers.BatchNorm2d``)
    after every VGG conv, conv6, conv7 and both extras; heads and TCB have
    none. The train mode (``net.train()``) normalises with the batch
    statistics and moves the running ones.
  * ``size=896``: five sources, the first an extra stride-4 source tapped
    after conv3_3 (``conv3_3_L2Norm``, scale 10).
  * ``quant``: the int8 serving twin. The quantizable convs (JAX's set:
    every VGG conv but conv1_1, conv6, conv7, both extras and the three
    TCB convs of each level) become ``layers.QuantConv2d``, but those
    ``quant_skip`` names; heads, L2Norm and the deconvs stay as they are.
    ``quant_skip`` takes the JAX package's (flax) names, ``vgg_conv1_2``
    and so on (``convert.module_names`` maps them to module paths). The
    BN variant keeps its BN after each quantized conv.

Submodules carry the reference network's state_dict names (``vgg.N``,
``extras.N``, ``arm_loc.i``, ``tcb0.{3i,3i+2}``, ``tcb1.i``,
``tcb2.{3i+1}``, ``conv4_3_L2Norm``), with the BN variant's indices of
``refinedet_bn.py`` (each conv at idx, its BN at idx+1, then the ReLU;
extras at 0/1/3/4), so a reference ``.pth`` of either variant
strict-loads.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from refinedet_tpu_torch.models.layers import BatchNorm2d, L2Norm, \
    QuantConv2d, max_pool_2x2

# VGG-16 convs (name, width); "M" is a 2x2 pool, "C" the ceil-mode pool3.
VGG_CFG = (("conv1_1", 64), ("conv1_2", 64), "M",
           ("conv2_1", 128), ("conv2_2", 128), "M",
           ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "C",
           ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
           ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512))
# Channels of the four ARM sources (conv4_3, conv5_3, fc7, extra); 896
# puts conv3_3's 256 in front.
SOURCE_CHANNELS = (512, 512, 1024, 512)
TCB_CHANNELS = 256
ANCHORS_PER_CELL = 3
# L2Norm taps: (conv whose ReLU output is tapped, module name, scale).
L2NORM_TAPS = (("conv3_3", "conv3_3_L2Norm", 10.0),
               ("conv4_3", "conv4_3_L2Norm", 10.0),
               ("conv5_3", "conv5_3_L2Norm", 8.0))

Heads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def vgg_layout(use_bn: bool = False) -> List[tuple]:
    """The ``vgg`` ModuleList, entry by entry: ``("conv", name, c_in,
    c_out, conv kwargs)``, ``("bn", name, channels)``, ``("relu", name)``
    or ``("pool", ceil_mode)``."""
    out: List[tuple] = []
    c_in = 3

    def conv(name, c_out, **kw):
        nonlocal c_in
        out.append(("conv", name, c_in, c_out, kw))
        if use_bn:
            out.append(("bn", name, c_out))
        out.append(("relu", name))
        c_in = c_out

    for item in VGG_CFG:
        if item in ("M", "C"):
            out.append(("pool", item == "C"))
        else:
            conv(*item, kernel_size=3, padding=1)
    out.append(("pool", False))                                # pool5
    conv("conv6", 1024, kernel_size=3, padding=3, dilation=3)  # dilated fc6
    conv("conv7", 1024, kernel_size=1)
    return out


def vgg_conv_indices(use_bn: bool = False) -> Dict[int, str]:
    """``vgg`` index of each conv -> its name (``conv1_1`` ... ``conv7``)."""
    return {i: e[1] for i, e in enumerate(vgg_layout(use_bn))
            if e[0] == "conv"}


def source_channels(size: int) -> Tuple[int, ...]:
    return (256,) + SOURCE_CHANNELS if size == 896 else SOURCE_CHANNELS


def quantizable_names(num_sources: int = 4) -> Tuple[str, ...]:
    """The flax names of the convs the int8 twin may quantize, in the
    order the forward runs them (``refinedet_tpu/models/refinedet.py``:
    ``quantizable=True``)."""
    vgg = [f"vgg_{e[1]}" for e in vgg_layout() if e[0] == "conv"
           and e[1] != "conv1_1"]
    tcb = []
    for i in reversed(range(num_sources)):
        tcb += [f"tcb0_{i}_conv1", f"tcb0_{i}_conv2", f"tcb2_{i}_conv"]
    return tuple(vgg + ["extra_conv1", "extra_conv2"] + tcb)


def _conv(c_in: int, c_out: int, quant: bool, kernel_size: int,
          stride: int = 1, padding: int = 0, dilation: int = 1) -> nn.Module:
    if quant:
        return QuantConv2d(c_in, c_out, kernel_size, stride, padding,
                           dilation)
    return nn.Conv2d(c_in, c_out, kernel_size, stride=stride,
                     padding=padding, dilation=dilation)


def _vgg_module(entry, quantized: Sequence[str]) -> nn.Module:
    kind = entry[0]
    if kind == "conv":
        _, name, c_in, c_out, kw = entry
        return _conv(c_in, c_out, f"vgg_{name}" in quantized, **kw)
    if kind == "bn":
        return BatchNorm2d(entry[2])
    if kind == "relu":
        return nn.ReLU(inplace=True)
    return max_pool_2x2(ceil_mode=entry[1])


class RefineDet(nn.Module):
    """VGG-16 trunk + extras + ARM heads + TCB fusion + ODM heads."""

    def __init__(self, num_classes: int = 21, size: int = 320,
                 use_bn: bool = False, quant: bool = False,
                 quant_skip: Sequence[str] = ()):
        super().__init__()
        self.num_classes = num_classes
        self.size = size
        self.use_bn = use_bn
        self.quant = quant
        self.quant_skip = tuple(quant_skip)
        sources = source_channels(size)
        # flax names of the quantizable convs not skipped: calibrated in
        # the float network, QuantConv2d in the int8 twin
        self.calibrated = tuple(n for n in quantizable_names(len(sources))
                                if n not in self.quant_skip)
        quantized = self.calibrated if quant else ()
        layout = vgg_layout(use_bn)
        self.vgg = nn.ModuleList([_vgg_module(e, quantized) for e in layout])
        relu_at = {e[1]: i for i, e in enumerate(layout) if e[0] == "relu"}
        width = {e[1]: e[3] for e in layout if e[0] == "conv"}
        # vgg index -> the L2Norm applied to that layer's output
        self._taps: Dict[int, str] = {}
        for conv, name, scale in L2NORM_TAPS:
            if conv == "conv3_3" and size != 896:
                continue
            self.add_module(name, L2Norm(width[conv], scale))
            self._taps[relu_at[conv]] = name
        extra1 = _conv(1024, 256, "extra_conv1" in quantized, 1)
        extra2 = _conv(256, 512, "extra_conv2" in quantized, 3, stride=2,
                       padding=1)
        if use_bn:
            self.extras = nn.ModuleList([
                extra1, BatchNorm2d(256), nn.ReLU(inplace=True),
                extra2, BatchNorm2d(512), nn.ReLU(inplace=True)])
        else:
            self.extras = nn.ModuleList([extra1, extra2])
        a = ANCHORS_PER_CELL
        self.arm_loc = nn.ModuleList(
            [nn.Conv2d(c, a * 4, 3, padding=1) for c in sources])
        self.arm_conf = nn.ModuleList(
            [nn.Conv2d(c, a * 2, 3, padding=1) for c in sources])
        self.odm_loc = nn.ModuleList(
            [nn.Conv2d(TCB_CHANNELS, a * 4, 3, padding=1) for _ in sources])
        self.odm_conf = nn.ModuleList(
            [nn.Conv2d(TCB_CHANNELS, a * num_classes, 3, padding=1)
             for _ in sources])
        tcb0: List[nn.Module] = []
        tcb2: List[nn.Module] = []
        for i, c in enumerate(sources):
            tcb0 += [_conv(c, TCB_CHANNELS, f"tcb0_{i}_conv1" in quantized,
                           3, padding=1),
                     nn.ReLU(inplace=True),
                     _conv(TCB_CHANNELS, TCB_CHANNELS,
                           f"tcb0_{i}_conv2" in quantized, 3, padding=1)]
            tcb2 += [nn.ReLU(inplace=True),
                     _conv(TCB_CHANNELS, TCB_CHANNELS,
                           f"tcb2_{i}_conv" in quantized, 3, padding=1),
                     nn.ReLU(inplace=True)]
        self.tcb0 = nn.ModuleList(tcb0)
        self.tcb1 = nn.ModuleList(
            [nn.ConvTranspose2d(TCB_CHANNELS, TCB_CHANNELS, 2, 2)
             for _ in sources[1:]])
        self.tcb2 = nn.ModuleList(tcb2)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: He-normal (truncated) for the VGG
        trunk, Xavier-uniform elsewhere, zero biases, L2Norm scales 10/8,
        BatchNorm at scale 1, bias 0, mean 0, var 1. Draws from
        ``generator`` in module order."""
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, BatchNorm2d):
                    m.reset_parameters()
                if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    continue
                if name.startswith("vgg."):
                    fan_in = m.weight[0].numel()
                    # Truncation at 2 std shrinks the variance by 0.774.
                    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=generator)
                else:
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            for _, name, scale in L2NORM_TAPS:
                if hasattr(self, name):
                    getattr(self, name).weight.fill_(scale)

    @staticmethod
    def _flatten(mods: nn.ModuleList, feats, ch: int) -> torch.Tensor:
        outs = [m(f).permute(0, 2, 3, 1).reshape(f.shape[0], -1, ch)
                for m, f in zip(mods, feats)]
        return torch.cat(outs, dim=1).float()

    def forward(self, images: torch.Tensor) -> Heads:
        """images NHWC [B, H, W, 3] -> (arm_loc, arm_conf, odm_loc,
        odm_conf), float32."""
        x = images.permute(0, 3, 1, 2)
        sources = []
        for k, layer in enumerate(self.vgg):
            x = layer(x)
            if k in self._taps:
                sources.append(getattr(self, self._taps[k])(x))
        sources.append(x)  # fc7
        for layer in self.extras:
            x = layer(x)
            if not self.use_bn:  # the BN variant has its ReLU modules
                x = torch.relu(x)
        sources.append(x)

        arm_loc = self._flatten(self.arm_loc, sources, 4)
        arm_conf = self._flatten(self.arm_conf, sources, 2)

        # TCB, top-down: the deeper level's deconv joins before the relu.
        n = len(sources)
        tcb_feats = [None] * n
        p = None
        for si in reversed(range(n)):
            s = self.tcb0[3 * si](sources[si])
            s = self.tcb0[3 * si + 1](s)
            s = self.tcb0[3 * si + 2](s)
            if si != n - 1:
                s = s + self.tcb1[si](p)
            s = self.tcb2[3 * si](s)
            s = self.tcb2[3 * si + 1](s)
            s = self.tcb2[3 * si + 2](s)
            p = s
            tcb_feats[si] = s

        odm_loc = self._flatten(self.odm_loc, tcb_feats, 4)
        odm_conf = self._flatten(self.odm_conf, tcb_feats, self.num_classes)
        return arm_loc, arm_conf, odm_loc, odm_conf
