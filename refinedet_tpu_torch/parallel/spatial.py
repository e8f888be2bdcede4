"""Spatial sharding of the network: the image height over the space ranks
of a ``(data, space)`` grid (``parallel/mesh.py:make_grid``).

The JAX package shards NHWC images ``P("data", "space")`` and lets XLA
SPMD insert the exchanges a convolution over a split height needs
(``refinedet_tpu/train/train_step.py:161-170``). Here they are explicit:

  * ``halo_exchange`` pads a band with its neighbours' rows (the fill,
    zeros or -inf, at the image's own top and bottom); its backward sends
    each halo row's gradient back to the rank that owns the row.
    ``halo_conv2d`` runs a convolution over the exchanged halo and keeps
    the band and the halo rows for its backward, not the padded copy;
  * ``gather_rows`` makes a full-height copy on every space rank; its
    backward sums the gradient over the space group and keeps the rank's
    own rows;
  * ``take_rows`` slices a replicated tensor to the rank's band; its
    backward puts the gradient in zeros.

Each is built on ``all_reduce`` alone (a zeroed buffer in which every
rank fills its own slot), the one collective besides ``broadcast`` that
gloo takes on CUDA tensors, so several ranks may share a card over gloo.
That moves S times the rows a point-to-point exchange would; the context
counts the bytes it hands to ``all_reduce``.

Gradients keep one invariant: a sharded tensor's gradient is the true one
for its rows, and the S copies of a replicated tensor carry gradients
whose sum over the space group is S times the true one (every space rank
computes its data group's whole loss). ``DistributedDataParallel``'s
average over the W = D·S ranks of the grid then gives, for a loss scaled
by D as the data-parallel step scales it, the gradient of the global
loss (``train/train_step.py``).

``spatial_plan`` says, for each layer of the network, whether it runs
sharded (with which halo) or replicated on every space rank. Where a band
does not split evenly (a stride-2 layer whose band starts on an odd row,
or a band thinner than a halo) the trunk gathers there and runs the rest
of the branch replicated: every deeper trunk layer and the heads and TCB
of the levels it feeds, and the TCB's deconv climbs back into a sharded
level through ``take_rows``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from refinedet_tpu_torch.models.layers import BatchNorm2d
from refinedet_tpu_torch.models.refinedet import L2NORM_TAPS, vgg_layout
from refinedet_tpu_torch.parallel.mesh import Grid, band


class Layer(NamedTuple):
    """A layer's place in the plan: ``sharded`` (else replicated on every
    space rank), its ``halo`` (rows above, rows below), ``gather`` (the
    input is gathered to full height first: the trunk turns replicated
    here) and ``take`` (the replicated output is sliced to the band)."""

    sharded: bool
    halo: Tuple[int, int] = (0, 0)
    gather: bool = False
    take: bool = False


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """``layers``: module name (``vgg.3``, ``extras.1``, ``arm_loc.0``,
    ``tcb1.2``, ``conv4_3_L2Norm``, ...) -> ``Layer``; ``levels``: per
    source, whether its heads and TCB run sharded; ``heights``: each
    source's rows; ``gather_at``: the trunk layer that gathers (None when
    the whole net runs sharded)."""

    size: int
    shards: int
    layers: Dict[str, Layer]
    levels: Tuple[bool, ...]
    heights: Tuple[int, ...]
    gather_at: Optional[str]


def conv_halo(kernel: int, stride: int = 1, padding: int = 0,
              dilation: int = 1) -> Tuple[int, int]:
    """Rows above and below a band that a convolution's output rows of
    that band read: output row i reads input rows ``i·s - p`` to
    ``i·s - p + d·(k-1)``. A stride-2, pad-1 3x3 conv reads one row above
    and none below an even band."""
    return padding, max(0, dilation * (kernel - 1) - padding - (stride - 1))


def spatial_plan(size: int, shards: int, use_bn: bool = False) -> SpatialPlan:
    """The plan of RefineDet``size`` (the BN variant's module indices with
    ``use_bn``) over ``shards`` bands. Raises when the image itself does
    not split into equal bands."""
    if shards < 1 or size % shards:
        raise ValueError(f"image height {size} does not split into "
                         f"{shards} bands")
    layers: Dict[str, Layer] = {}
    levels, heights = [], []
    h, sharded, gather_at = size, True, None
    taps = {conv: name for conv, name, _ in L2NORM_TAPS
            if conv != "conv3_3" or size == 896}

    def place(name, step=1, halo=(0, 0)):
        """Run ``name`` sharded if the trunk still is and its band (of
        ``h`` rows) starts and ends on a multiple of ``step`` and is no
        thinner than its halo; else gather before it."""
        nonlocal sharded, gather_at
        fits = h % (shards * step) == 0 and h // shards >= max(halo)
        if sharded and not fits:
            sharded, gather_at = False, name
            layers[name] = Layer(False, gather=True)
        else:
            layers[name] = Layer(sharded, halo if sharded else (0, 0))

    def source():
        levels.append(sharded)
        heights.append(h)

    def conv(name, k, s=1, p=0, d=1):
        nonlocal h
        place(name, s, conv_halo(k, s, p, d))
        h = (h + 2 * p - d * (k - 1) - 1) // s + 1

    for i, entry in enumerate(vgg_layout(use_bn)):
        name = f"vgg.{i}"
        if entry[0] == "conv":
            kw = entry[4]
            conv(name, kw["kernel_size"], 1, kw.get("padding", 0),
                 kw.get("dilation", 1))
        elif entry[0] == "pool":
            place(name, 2)
            h = -(-h // 2) if entry[1] else h // 2
        else:
            place(name)
            if entry[0] == "relu" and entry[1] in taps:
                layers[taps[entry[1]]] = Layer(sharded)
                source()
    source()  # fc7
    index = 0
    for k, s, p in ((1, 1, 0), (3, 2, 1)):  # extras: 1x1, 3x3 stride 2
        conv(f"extras.{index}", k, s, p)
        if use_bn:
            place(f"extras.{index + 1}")
            place(f"extras.{index + 2}")
        index += 3 if use_bn else 1
    source()

    for i, on in enumerate(levels):
        halo = (1, 1) if on else (0, 0)
        for head in ("arm_loc", "arm_conf", "odm_loc", "odm_conf"):
            layers[f"{head}.{i}"] = Layer(on, halo)
        for j in (3 * i, 3 * i + 2):
            layers[f"tcb0.{j}"] = Layer(on, halo)
        layers[f"tcb0.{3 * i + 1}"] = Layer(on)
        layers[f"tcb2.{3 * i}"] = Layer(on)
        layers[f"tcb2.{3 * i + 1}"] = Layer(on, halo)
        layers[f"tcb2.{3 * i + 2}"] = Layer(on)
        if i + 1 < len(levels):  # the deconv from level i + 1 into i
            deeper = levels[i + 1]
            layers[f"tcb1.{i}"] = Layer(deeper, take=on and not deeper)
    return SpatialPlan(size, shards, layers, tuple(levels), tuple(heights),
                       gather_at)


# -- the collectives, as autograd functions -----------------------------------

def _format(x: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if x.dim() == 4 and x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format


def _empty(shape, like: torch.Tensor, fmt) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       memory_format=fmt)


def _all_reduce(buf: torch.Tensor, space: "SpatialContext",
                kind: str) -> None:
    space.bytes[kind] += buf.numel() * buf.element_size()
    dist.all_reduce(buf, group=space.group)


def _exchange(x: torch.Tensor, top: int, bottom: int, fill: float,
              space: "SpatialContext") -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``top`` rows above and the ``bottom`` rows below this rank's
    band ``x`` [B, C, h, W]: its neighbours' last and first rows, or
    ``fill`` beyond the image's first and last band."""
    b, c, h, w = x.shape
    if h < max(top, bottom):
        raise ValueError(f"a band of {h} rows is thinner than its halo "
                         f"({top}, {bottom})")
    k, last = space.index, space.shards - 1
    nhwc = x.permute(0, 2, 3, 1)
    # Slot k: my last `top` rows (rank k+1's top halo), then my first
    # `bottom` rows (rank k-1's bottom halo).
    buf = x.new_zeros((space.shards, b, top + bottom, w, c))
    buf[k, :, :top] = nhwc[:, h - top:]
    buf[k, :, top:] = nhwc[:, :bottom]
    _all_reduce(buf, space, "halo")
    above = (buf[k - 1, :, :top].clone() if k > 0
             else x.new_full((b, top, w, c), fill))
    below = (buf[k + 1, :, top:].clone() if k < last
             else x.new_full((b, bottom, w, c), fill))
    return above.permute(0, 3, 1, 2), below.permute(0, 3, 1, 2)


def _padded(above: torch.Tensor, x: torch.Tensor, below: torch.Tensor,
            fmt) -> torch.Tensor:
    b, c, h, w = x.shape
    top = above.shape[2]
    out = _empty((b, c, top + h + below.shape[2], w), x, fmt)
    out[:, :, :top] = above
    out[:, :, top:top + h] = x
    out[:, :, top + h:] = below
    return out


def _halo_grad(grad: torch.Tensor, top: int, bottom: int,
               space: "SpatialContext", fmt) -> torch.Tensor:
    """The band's gradient from its padded copy's: the middle rows, plus
    what the neighbours' halos hold of its first and last rows."""
    k, last = space.index, space.shards - 1
    b, c, rows, w = grad.shape
    h = rows - top - bottom
    nhwc = grad.permute(0, 2, 3, 1)
    # Slot k: my top halo's gradient (rank k-1's last rows), then my
    # bottom halo's (rank k+1's first rows); the fill's is dropped.
    buf = grad.new_zeros((space.shards, b, top + bottom, w, c))
    if k > 0:
        buf[k, :, :top] = nhwc[:, :top]
    if k < last:
        buf[k, :, top:] = nhwc[:, top + h:]
    _all_reduce(buf, space, "halo")
    gx = _empty((b, c, h, w), grad, fmt)
    gx.copy_(grad[:, :, top:top + h])
    if k < last and top:
        gx[:, :, h - top:] += buf[k + 1, :, :top].permute(0, 3, 1, 2)
    if k > 0 and bottom:
        gx[:, :, :bottom] += buf[k - 1, :, top:].permute(0, 3, 1, 2)
    return gx


class _HaloExchange(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, fill, space):
        ctx.top, ctx.bottom, ctx.space = top, bottom, space
        ctx.fmt = _format(x)
        above, below = _exchange(x, top, bottom, fill, space)
        return _padded(above, x, below, ctx.fmt)

    @staticmethod
    def backward(ctx, grad):
        return (_halo_grad(grad, ctx.top, ctx.bottom, ctx.space, ctx.fmt),
                None, None, None, None)


class _HaloConv(torch.autograd.Function):
    """A convolution over a band and its halo that keeps, for its
    backward, the band (which the layer before keeps too) and the halo
    rows, not the padded copy: that copy would hold each activation
    twice. Under autocast it computes in autocast's dtype, as
    ``F.conv2d`` would."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv, top, bottom, space):
        above, below = _exchange(x, top, bottom, 0.0, space)
        dev = x.device.type
        dtype = torch.get_autocast_dtype(dev) \
            if torch.is_autocast_enabled(dev) else x.dtype
        w = weight.to(dtype)
        ctx.fmt, ctx.conv, ctx.space = _format(x), conv, space
        ctx.dtypes = (x.dtype, weight.dtype,
                      None if bias is None else bias.dtype)
        xp = _padded(above, x, below, ctx.fmt).to(dtype)
        with torch.autocast(dev, enabled=False):
            y = F.conv2d(xp, w, None if bias is None else bias.to(dtype),
                         conv.stride, (0, conv.padding[1]), conv.dilation)
        ctx.save_for_backward(x, w, above, below)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, above, below = ctx.saved_tensors
        conv, (x_dtype, w_dtype, b_dtype) = ctx.conv, ctx.dtypes
        xp = _padded(above, x, below, ctx.fmt).to(w.dtype)
        needs = ctx.needs_input_grad
        gi, gw, gb = torch.ops.aten.convolution_backward(
            gy.to(w.dtype), xp, w,
            None if b_dtype is None else [w.shape[0]], list(conv.stride),
            [0, conv.padding[1]], list(conv.dilation), False, [0, 0], 1,
            [needs[0], needs[1], b_dtype is not None and needs[2]])
        gx = None if gi is None else _halo_grad(
            gi, above.shape[2], below.shape[2], ctx.space,
            ctx.fmt).to(x_dtype)
        return (gx, None if gw is None else gw.to(w_dtype),
                None if gb is None else gb.to(b_dtype), None, None, None,
                None)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, space):
        ctx.space, ctx.fmt = space, _format(x)
        b, c, h, w = x.shape
        k = space.index
        out = _empty((b, c, space.shards * h, w), x, ctx.fmt).zero_()
        out[:, :, k * h:(k + 1) * h] = x
        _all_reduce(out, space, "gather")
        return out

    @staticmethod
    def backward(ctx, grad):
        space = ctx.space
        g = grad.clone(memory_format=ctx.fmt)
        _all_reduce(g, space, "gather")
        start, stop = band(g.shape[2], space.index, space.shards)
        return g[:, :, start:stop].contiguous(memory_format=ctx.fmt), None


class _TakeRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, space):
        ctx.space, ctx.fmt, ctx.shape = space, _format(x), x.shape
        start, stop = band(x.shape[2], space.index, space.shards)
        return x[:, :, start:stop].contiguous(memory_format=ctx.fmt)

    @staticmethod
    def backward(ctx, grad):
        space = ctx.space
        start, stop = band(ctx.shape[2], space.index, space.shards)
        g = _empty(ctx.shape, grad, ctx.fmt).zero_()
        g[:, :, start:stop] = grad
        return g, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int,
                  space: "SpatialContext", fill: float = 0.0
                  ) -> torch.Tensor:
    """A band ``[B, C, h, W]`` padded to ``top + h + bottom`` rows with
    its neighbours' rows, and with ``fill`` above the image's first band
    and below its last."""
    return _HaloExchange.apply(x, top, bottom, fill, space)


def halo_conv2d(x: torch.Tensor, conv: nn.Conv2d, top: int, bottom: int,
                space: "SpatialContext") -> torch.Tensor:
    """``conv`` over a band ``[B, C, h, W]`` with ``top`` rows of halo
    above and ``bottom`` below (zeros beyond the image), its height
    padding replaced by them: the band's rows of ``conv`` on the whole
    image."""
    return _HaloConv.apply(x, conv.weight, conv.bias, conv, top, bottom,
                           space)


def gather_rows(x: torch.Tensor, space: "SpatialContext") -> torch.Tensor:
    """Every space rank's band, stacked along H: the full-height tensor,
    on every space rank."""
    return _GatherRows.apply(x, space)


def take_rows(x: torch.Tensor, space: "SpatialContext") -> torch.Tensor:
    """This rank's band of a full-height tensor that every space rank
    holds."""
    return _TakeRows.apply(x, space)


# -- the network under a plan -------------------------------------------------

class SpatialContext:
    """A plan on this rank of a grid: what ``RefineDet.forward`` takes to
    run its layers over the space group, and the bytes this rank handed
    to ``all_reduce`` (``bytes["halo"]``, ``bytes["gather"]``)."""

    def __init__(self, plan: SpatialPlan, grid: Grid):
        if plan.shards != grid.shards:
            raise ValueError(f"a plan of {plan.shards} bands on a grid of "
                             f"{grid.shards}")
        self.plan, self.grid = plan, grid
        self.group, self.index, self.shards = \
            grid.space_group, grid.space_index, grid.shards
        self.bytes = {"halo": 0, "gather": 0}

    def check(self, images: torch.Tensor) -> None:
        """Raise unless ``images`` (NHWC) are this plan's bands."""
        rows = self.plan.size // self.shards
        if images.shape[1] != rows or images.shape[2] != self.plan.size:
            raise ValueError(f"images {tuple(images.shape)} are not bands "
                             f"of {rows} rows of a {self.plan.size}² image")

    def call(self, name: str, module: nn.Module,
             x: torch.Tensor) -> torch.Tensor:
        """``module(x)`` as the plan places the layer ``name``: gathered
        first, over a halo, and sliced to the band after, as it says."""
        layer = self.plan.layers[name]
        if layer.gather:
            x = gather_rows(x, self)
        if layer.sharded and any(layer.halo):
            if not isinstance(module, nn.Conv2d):
                raise TypeError(f"{name}: a halo for {type(module)}")
            y = halo_conv2d(x, module, *layer.halo, self)
        else:
            y = module(x)
        return take_rows(y, self) if layer.take else y

    def full(self, name: str, y: torch.Tensor) -> torch.Tensor:
        """The layer ``name``'s output at full height."""
        return gather_rows(y, self) if self.plan.layers[name].sharded else y

    def sync_batch_norm(self, net: nn.Module) -> None:
        """Each BN's train-mode statistics over the ranks that hold its
        rows once: the whole grid at a sharded level, the data group at a
        replicated one; each keeps only its input for the backward
        (``BatchNorm2d.lean``)."""
        for name, m in net.named_modules():
            if isinstance(m, BatchNorm2d):
                m.group = (self.grid.group if self.plan.layers[name].sharded
                           else self.grid.data_group)
                m.lean = True
