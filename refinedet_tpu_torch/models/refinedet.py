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
  * ``stem_s2d``: the space-to-depth stem, an inference-only serving
    transform of the plain network (``models/stem_s2d.py``). conv1_1
    becomes ``stem_conv1``, a 4x4 stride-2 conv with 256 outputs, the
    2x2-blocked layout of conv1_1's 64; conv1_2 and pool1 become four 2x2
    phase convs ``stem_conv2_{di}{dj}`` and their elementwise max. Its
    weights are a standard network's, folded (``reset_parameters``
    folds the standard net of the same draws).

On the card, the plain network's unsharded forward runs each conv that
feeds a ReLU, the trunk's 15, both extras and each level's first TCB conv
and its TCB2 conv (25 a forward; the int8 twin's float convs among them),
as one ``ops.conv_epilogue.conv_bias_relu``: cuDNN's convolution without
its bias, then the bias add and the ReLU in one pass, bitwise the
separate ops. Which convs go so is read from what the forward sees
(``_fuses``): a plain ``nn.Conv2d`` without hooks, its ReLU without
hooks, a CUDA input in a dtype the epilogue takes. Meta and CPU inputs,
hooked modules (calibration, FLOP and shape counters), ``QuantConv2d``,
the BN variant, the spatial path and the stem twin's stem run as before;
modules and the state_dict are the same.

Submodules carry the reference network's state_dict names (``vgg.N``,
``extras.N``, ``arm_loc.i``, ``tcb0.{3i,3i+2}``, ``tcb1.i``,
``tcb2.{3i+1}``, ``conv4_3_L2Norm``), with the BN variant's indices of
``refinedet_bn.py`` (each conv at idx, its BN at idx+1, then the ReLU;
extras at 0/1/3/4), so a reference ``.pth`` of either variant
strict-loads. The stem twin keeps the trunk from conv2_1 on at those
indices (``vgg.0``-``vgg.4`` are parameter-free placeholders) and adds
the stem modules under their flax names, which have no reference
counterpart.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn
from torch.nn.modules import module as _module

from refinedet_tpu_torch.models.layers import BatchNorm2d, L2Norm, \
    MaxPool2x2, QuantConv2d
from refinedet_tpu_torch.models.stem_s2d import STEM_PHASES, \
    STEM_VGG_LAYERS, fold_stem_state_dict
from refinedet_tpu_torch.ops import conv_epilogue

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
    return MaxPool2x2(ceil_mode=entry[1])


class RefineDet(nn.Module):
    """VGG-16 trunk + extras + ARM heads + TCB fusion + ODM heads."""

    def __init__(self, num_classes: int = 21, size: int = 320,
                 use_bn: bool = False, quant: bool = False,
                 quant_skip: Sequence[str] = (), stem_s2d: bool = False):
        super().__init__()
        if stem_s2d and (use_bn or quant):
            raise ValueError("stem_s2d is a plain-model serving transform "
                             "(no BN/quant folding)")
        self.num_classes = num_classes
        self.size = size
        self.use_bn = use_bn
        self.quant = quant
        self.quant_skip = tuple(quant_skip)
        self.stem_s2d = stem_s2d
        sources = source_channels(size)
        # flax names of the quantizable convs not skipped: calibrated in
        # the float network, QuantConv2d in the int8 twin
        self.calibrated = tuple(n for n in quantizable_names(len(sources))
                                if n not in self.quant_skip
                                and not (stem_s2d and n == "vgg_conv1_2"))
        quantized = self.calibrated if quant else ()
        layout = vgg_layout(use_bn)
        self.vgg = nn.ModuleList([_vgg_module(e, quantized) for e in layout])
        if stem_s2d:
            for k in range(STEM_VGG_LAYERS):
                self.vgg[k] = nn.Identity()
            c1 = layout[0][3]  # conv1's width
            self.stem_conv1 = nn.Conv2d(3, 4 * c1, 4, stride=2, padding=1)
            for phase in STEM_PHASES:
                # padding 1 all round: phase (di, dj) is the output window
                # starting at (di, dj) (see ``stem``)
                self.add_module(f"stem_conv2_{phase}", nn.Conv2d(
                    4 * c1, c1, 2, padding=1))
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
        ``generator`` in module order. The stem twin takes the fold of
        the standard network drawn so (the JAX twin has no init of its
        own either)."""
        if self.stem_s2d:
            standard = RefineDet(self.num_classes, self.size)
            standard.reset_parameters(generator)
            self.load_state_dict(fold_stem_state_dict(
                standard.state_dict()))
            return
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
    def _flatten(mods: nn.ModuleList, name: str, feats, ch: int,
                 run, full) -> torch.Tensor:
        outs = [full(f"{name}.{i}", run(f"{name}.{i}", m, f))
                .permute(0, 2, 3, 1).reshape(f.shape[0], -1, ch)
                for i, (m, f) in enumerate(zip(mods, feats))]
        return torch.cat(outs, dim=1).float()

    def forward(self, images: torch.Tensor, spatial=None) -> Heads:
        """images NHWC [B, H, W, 3] -> (arm_loc, arm_conf, odm_loc,
        odm_conf), float32. ``spatial`` (a ``parallel.spatial.
        SpatialContext``, the train step's under ``--spatial_shards``):
        the images are this rank's band of rows, each layer runs as the
        context's plan places it, and the heads come out whole on every
        space rank."""
        if spatial is None:
            run, full = _run, _whole
        elif self.stem_s2d:
            raise ValueError("stem_s2d is an inference-only serving "
                             "transform: no spatial sharding")
        else:
            spatial.check(images)
            run, full = spatial.call, spatial.full
        # The plain network's unsharded forward runs each conv that feeds
        # a ReLU as one conv_bias_relu where it can (``_fuses``).
        fuse = spatial is None and not self.use_bn
        x = images.permute(0, 3, 1, 2)
        sources = []
        k = 0
        if self.stem_s2d:
            x = self.stem(x)
            k = STEM_VGG_LAYERS
        for tap in sorted(self._taps):  # each an index of a ReLU
            x = _chain("vgg", self.vgg, k, tap + 1, x, run, fuse)
            sources.append(run(self._taps[tap],
                               getattr(self, self._taps[tap]), x))
            k = tap + 1
        x = _chain("vgg", self.vgg, k, len(self.vgg), x, run, fuse)
        sources.append(x)  # fc7
        if self.use_bn:  # the BN variant has its ReLU modules
            x = _chain("extras", self.extras, 0, len(self.extras), x, run,
                       fuse)
        else:
            for k, layer in enumerate(self.extras):
                if fuse and _fuses(layer, x):
                    x = _conv_bias_relu(layer, x)
                else:
                    x = torch.relu(run(f"extras.{k}", layer, x))
        sources.append(x)

        arm_loc = self._flatten(self.arm_loc, "arm_loc", sources, 4, run,
                                full)
        arm_conf = self._flatten(self.arm_conf, "arm_conf", sources, 2, run,
                                 full)

        # TCB, top-down: the deeper level's deconv joins before the relu.
        n = len(sources)
        tcb_feats = [None] * n
        p = None
        for si in reversed(range(n)):
            s = _chain("tcb0", self.tcb0, 3 * si, 3 * si + 3, sources[si],
                       run, fuse)
            if si != n - 1:
                s = s + run(f"tcb1.{si}", self.tcb1[si], p)
            s = _chain("tcb2", self.tcb2, 3 * si, 3 * si + 3, s, run, fuse)
            p = s
            tcb_feats[si] = s

        odm_loc = self._flatten(self.odm_loc, "odm_loc", tcb_feats, 4, run,
                                full)
        odm_conf = self._flatten(self.odm_conf, "odm_conf", tcb_feats,
                                 self.num_classes, run, full)
        return arm_loc, arm_conf, odm_loc, odm_conf

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv1_1, conv1_2 and pool1 with their ReLUs (``vgg.0``-``vgg.4``)
        or the twin's blocked form of them: NCHW images in, pool1's output
        out (``tools/bench_stem_s2d.py`` times it alone).

        The twin: ``stem_conv1`` and its ReLU give the blocked features
        ``[B, 4C, H/2, W/2]``; phase (di, dj) is JAX's 2x2 conv padded
        ``((1-di, di), (1-dj, dj))``, which is the (H/2, W/2) window at
        (di, dj) of the same conv padded by 1 all round (one extra row
        and column computed, no padded copy and no slice of the input:
        each conv reads the channels-last features as they are); then
        the phases' elementwise max and the ReLU."""
        if not self.stem_s2d:
            for layer in self.vgg[:STEM_VGG_LAYERS]:
                x = layer(x)
            return x
        x = torch.relu(self.stem_conv1(x))
        h, w = x.shape[2:]
        y = None
        for phase in STEM_PHASES:
            di, dj = int(phase[0]), int(phase[1])
            p = getattr(self, f"stem_conv2_{phase}")(x)[
                :, :, di:di + h, dj:dj + w]
            y = p if y is None else torch.maximum(y, p)
        return torch.relu_(y)


def _run(name: str, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return module(x)


def _hooked(module: nn.Module) -> bool:
    """Whether calling ``module`` would run a hook, its own or a global
    one (the test ``nn.Module.__call__`` makes before it skips them)."""
    return bool(module._forward_hooks or module._forward_pre_hooks
                or module._backward_hooks or module._backward_pre_hooks
                or _module._global_forward_hooks
                or _module._global_forward_pre_hooks
                or _module._global_backward_hooks
                or _module._global_backward_pre_hooks)


def _fuses(conv: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``conv``, which feeds a ReLU, runs with it as one
    ``conv_bias_relu`` on the input ``x``: a plain ``nn.Conv2d`` (not a
    subclass, not ``QuantConv2d``) with no hooks, on a CUDA input (not
    meta, not the CPU), in a form the epilogue takes."""
    return type(conv) is nn.Conv2d and x.device.type == "cuda" and \
        not _hooked(conv) and conv_epilogue.takes(conv, x)


def _conv_bias_relu(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv_epilogue.conv_bias_relu(x, conv.weight, conv.bias,
                                        conv.stride, conv.padding,
                                        conv.dilation)


def _chain(name: str, mods: nn.ModuleList, lo: int, hi: int,
           x: torch.Tensor, run, fuse: bool) -> torch.Tensor:
    """``mods[lo:hi]`` in turn through ``run``; with ``fuse``, a conv that
    ``_fuses`` and the ``nn.ReLU`` after it (without hooks) run as one
    ``conv_bias_relu``."""
    k = lo
    while k < hi:
        m = mods[k]
        if fuse and k + 1 < hi and type(mods[k + 1]) is nn.ReLU and \
                not _hooked(mods[k + 1]) and _fuses(m, x):
            x = _conv_bias_relu(m, x)
            k += 2
        else:
            x = run(f"{name}.{k}", m, x)
            k += 1
    return x


def _whole(name: str, y: torch.Tensor) -> torch.Tensor:
    return y
