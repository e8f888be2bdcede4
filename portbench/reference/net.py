"""The reference RefineDet network (VGG-16, no BatchNorm), plain float32.

RefineDet (Zhang et al., arXiv:1711.06897) as the reference fork builds it
(``models/refinedet.py``): the VGG-16 trunk with the dilated fc6 and the
1x1 fc7, two extra layers, L2Norm on conv4_3 (scale 10) and conv5_3
(scale 8), the ARM heads on the four sources, the transfer connection
blocks top-down (two 3x3 convs, the deeper level's 2x2 deconv added before
the ReLU, a third 3x3 conv) and the ODM heads. Images NHWC in, heads
``arm_loc [B, P, 4]``, ``arm_conf [B, P, 2]``, ``odm_loc``, ``odm_conf
[B, P, C]`` out, flattened in (h, w, anchor) order. Parameter names are
the fork's state_dict keys, so one state_dict loads into the program and
into this network alike.

Two switches serve the comparison and its control:

  * ``quant``: module path -> (kernel_q, w_scale, in_scale, bias) from
    ``reference/quant.py``; that conv then runs as the int8 serving twin
    computes it, exactly: its input quantized per channel
    (``round(x * (1 / in_scale))`` clamped to the levels), the integer
    convolution in float64 (exact), the epilogue ``acc * w_scale + bias``.
  * ``emulate="fp8"`` or ``"int8"``: the net in a precision below
    bfloat16, as low-precision training runs it: every convolution's
    input and weight rounded to float8 e4m3 (or int8) and the gradient of
    its output to float8 e5m2 (or int8), each at a per-tensor scale at the
    format's largest value, around a float32 convolution.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

VGG = (("conv1_1", 64), ("conv1_2", 64), "M", ("conv2_1", 128),
       ("conv2_2", 128), "M", ("conv3_1", 256), ("conv3_2", 256),
       ("conv3_3", 256), "C", ("conv4_1", 512), ("conv4_2", 512),
       ("conv4_3", 512), "M", ("conv5_1", 512), ("conv5_2", 512),
       ("conv5_3", 512))
SOURCES = (512, 512, 1024, 512)
TCB = 256
ANCHORS = 3
FP8_MAX = 448.0
E5M2_MAX = 57344.0


def vgg_layout() -> List[tuple]:
    """The ``vgg`` list: ("conv", name, cin, cout, kwargs), ("relu", name)
    or ("pool", ceil_mode); pool5, conv6 (dilation 3) and conv7 close it."""
    out, c = [], 3

    def conv(name, cout, **kw):
        nonlocal c
        out.extend([("conv", name, c, cout, kw), ("relu", name)])
        c = cout

    for item in VGG:
        if item in ("M", "C"):
            out.append(("pool", item == "C"))
        else:
            conv(*item, kernel_size=3, padding=1)
    out.append(("pool", False))
    conv("conv6", 1024, kernel_size=3, padding=3, dilation=3)
    conv("conv7", 1024, kernel_size=1)
    return out


def quantizable(num_sources: int = 4) -> Dict[str, str]:
    """flax-style name -> module path of every conv the int8 twin may
    quantize, in forward order (every VGG conv but conv1_1, the two
    extras, the three TCB convs of each level)."""
    out = {}
    for i, e in enumerate(vgg_layout()):
        if e[0] == "conv" and e[1] != "conv1_1":
            out[f"vgg_{e[1]}"] = f"vgg.{i}"
    out["extra_conv1"], out["extra_conv2"] = "extras.0", "extras.1"
    for i in reversed(range(num_sources)):
        out[f"tcb0_{i}_conv1"] = f"tcb0.{3 * i}"
        out[f"tcb0_{i}_conv2"] = f"tcb0.{3 * i + 2}"
        out[f"tcb2_{i}_conv"] = f"tcb2.{3 * i + 1}"
    return out


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


def _int8(x: torch.Tensor) -> torch.Tensor:
    s = x.detach().abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(x / s).clamp(-127, 127) * s


ROUND = {"fp8": (lambda x: _round(x, torch.float8_e4m3fn, FP8_MAX),
                 lambda g: _round(g, torch.float8_e5m2, E5M2_MAX)),
         "int8": (_int8, _int8)}


class _Ste(torch.autograd.Function):
    """Rounds the value forward; identity backward."""

    @staticmethod
    def forward(ctx, x, kind):
        return ROUND[kind][0](x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradRound(torch.autograd.Function):
    """Identity forward; rounds the incoming gradient."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ROUND[ctx.kind][1](g), None


class L2Norm(nn.Module):
    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), scale))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(1, keepdim=True)) + 1e-10
        return x / norm * self.weight.view(1, -1, 1, 1)


class RefineDet(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        layout = vgg_layout()
        self.vgg = nn.ModuleList([
            nn.Conv2d(e[2], e[3], **e[4]) if e[0] == "conv" else nn.ReLU()
            if e[0] == "relu" else nn.MaxPool2d(2, 2, ceil_mode=e[1])
            for e in layout])
        relu_at = {e[1]: i for i, e in enumerate(layout) if e[0] == "relu"}
        self.conv4_3_L2Norm = L2Norm(512, 10.0)
        self.conv5_3_L2Norm = L2Norm(512, 8.0)
        self.taps = {relu_at["conv4_3"]: "conv4_3_L2Norm",
                     relu_at["conv5_3"]: "conv5_3_L2Norm"}
        self.extras = nn.ModuleList([nn.Conv2d(1024, 256, 1),
                                     nn.Conv2d(256, 512, 3, 2, 1)])
        a = ANCHORS
        self.arm_loc = nn.ModuleList([nn.Conv2d(c, a * 4, 3, padding=1)
                                      for c in SOURCES])
        self.arm_conf = nn.ModuleList([nn.Conv2d(c, a * 2, 3, padding=1)
                                       for c in SOURCES])
        self.odm_loc = nn.ModuleList([nn.Conv2d(TCB, a * 4, 3, padding=1)
                                      for _ in SOURCES])
        self.odm_conf = nn.ModuleList([
            nn.Conv2d(TCB, a * num_classes, 3, padding=1) for _ in SOURCES])
        tcb0, tcb2 = [], []
        for c in SOURCES:
            tcb0 += [nn.Conv2d(c, TCB, 3, padding=1), nn.ReLU(),
                     nn.Conv2d(TCB, TCB, 3, padding=1)]
            tcb2 += [nn.ReLU(), nn.Conv2d(TCB, TCB, 3, padding=1), nn.ReLU()]
        self.tcb0 = nn.ModuleList(tcb0)
        self.tcb1 = nn.ModuleList([nn.ConvTranspose2d(TCB, TCB, 2, 2)
                                   for _ in SOURCES[1:]])
        self.tcb2 = nn.ModuleList(tcb2)
        self.quant: Dict[str, Tuple[torch.Tensor, ...]] = {}
        self.levels = 127
        self.emulate: Optional[str] = None
        self.paths = {m: n for n, m in self.named_modules()}

    def _layer(self, m: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            return m(x)
        q = self.quant.get(self.paths[m])
        if q is not None:
            return quant_conv(x, q, m, self.levels)
        if self.emulate is not None:
            w = _Ste.apply(m.weight, self.emulate)
            x = _Ste.apply(x, self.emulate)
            if isinstance(m, nn.ConvTranspose2d):
                y = F.conv_transpose2d(x, w, m.bias, m.stride)
            else:
                y = F.conv2d(x, w, m.bias, m.stride, m.padding, m.dilation)
            return _GradRound.apply(y, self.emulate)
        return m(x)

    def _flat(self, mods, feats, ch):
        return torch.cat([self._layer(m, f).permute(0, 2, 3, 1).reshape(
            f.shape[0], -1, ch) for m, f in zip(mods, feats)], 1)

    def forward(self, images: torch.Tensor, taps=None):
        """NHWC float32 images -> the four heads. ``taps(path, x)``, if
        given, sees the input of every conv the int8 twin may quantize."""
        x = images.permute(0, 3, 1, 2)
        qpaths = set(quantizable().values()) if taps else ()

        def run(path, m, x):
            if path in qpaths:
                taps(path, x)
            return self._layer(m, x)

        sources = []
        for k, layer in enumerate(self.vgg):
            x = run(f"vgg.{k}", layer, x)
            if k in self.taps:
                sources.append(getattr(self, self.taps[k])(x))
        sources.append(x)
        for k, layer in enumerate(self.extras):
            x = torch.relu(run(f"extras.{k}", layer, x))
        sources.append(x)
        arm_loc = self._flat(self.arm_loc, sources, 4)
        arm_conf = self._flat(self.arm_conf, sources, 2)
        n = len(sources)
        feats, p = [None] * n, None
        for si in reversed(range(n)):
            s = sources[si]
            for j in range(3 * si, 3 * si + 3):
                s = run(f"tcb0.{j}", self.tcb0[j], s)
            if si != n - 1:
                s = s + self._layer(self.tcb1[si], p)
            for j in range(3 * si, 3 * si + 3):
                s = run(f"tcb2.{j}", self.tcb2[j], s)
            p = feats[si] = s
        odm_loc = self._flat(self.odm_loc, feats, 4)
        odm_conf = self._flat(self.odm_conf, feats, self.num_classes)
        return arm_loc, arm_conf, odm_loc, odm_conf


def quantize_input(x: torch.Tensor, in_scale: torch.Tensor,
                   levels: int) -> torch.Tensor:
    """``clamp(round(x * (1 / in_scale)), -levels, levels)`` per channel of
    NCHW ``x``, as float32 integers; the reciprocal by IEEE division."""
    inv = torch.ones_like(in_scale) / in_scale
    return torch.clamp(torch.round(x.float() * inv.view(1, -1, 1, 1)),
                       -levels, levels)


def quant_conv(x: torch.Tensor, q: Tuple[torch.Tensor, ...], m: nn.Conv2d,
               levels: int) -> torch.Tensor:
    """The int8 twin's conv: integer sums in float64 (exact), then
    ``acc * w_scale + bias`` in float64, rounded once to float32."""
    kernel_q, w_scale, in_scale, bias = q
    xq = quantize_input(x, in_scale, levels).double()
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq, kernel_q.double(), None, m.stride, m.padding,
                       m.dilation)
    return (acc * w_scale.double().view(1, -1, 1, 1)
            + bias.double().view(1, -1, 1, 1)).float()
