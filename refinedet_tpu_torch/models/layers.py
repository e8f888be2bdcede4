"""Shared model building blocks (NCHW modules).

Port of ``refinedet_tpu/models/layers.py``: the L2Norm tap and the 2x2
stride-2 max pools of the VGG trunk, plus the BatchNorm of the BN variant
with the semantics of the JAX package's ``flax.linen.BatchNorm``, and the
int8 ``QuantConv`` as ``QuantConv2d``. The pools' backward is switched,
as in JAX, by the module-level ``POOL_BACKWARD``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from refinedet_tpu_torch.ops.int8_conv import int8_conv, int8_quantize
from refinedet_tpu_torch.parallel.distributed import all_reduce_sum


class BatchNorm2d(nn.BatchNorm2d):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` as a torch
    module with torch's state_dict (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``).

    Train mode normalises with the batch statistics; eval mode with the
    running ones. The one difference from ``nn.BatchNorm2d``: flax folds
    the *biased* batch variance into ``running_var``, torch the unbiased
    one (larger by n/(n-1), n = B·H·W). The stock kernel's update is kept
    and corrected around it: the kernel updates a copy of the running
    variance scaled up by n/(n-1), and ``running_var`` becomes that result
    scaled down by (n-1)/n, i.e. ``(1-m)·v + m·var_biased``. (The copy
    keeps the tensor autograd saved unchanged.) n comes from the shape, so
    nothing waits for the device. ``num_batches_tracked`` counts but is
    never read (a fixed momentum).

    With a process ``group`` (``sync_batch_norm``), train mode takes the
    statistics of the global batch, every rank's rows, as flax does under
    the JAX package's ``data`` mesh: see ``synced_forward``. Under
    spatial sharding each layer gets the group that holds its rows once
    (``parallel/spatial.py:SpatialContext.sync_batch_norm``): the whole
    grid where the layer runs on bands, the data group where it runs
    replicated on every space rank."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.group: Optional[dist.ProcessGroup] = None
        # keep only the input for the backward (spatial sharding)
        self.lean = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.group is not None:
            return self.synced_forward(x)
        n = x.numel() // x.shape[1]
        if not self.training or n < 2:  # n < 2: the stock module raises
            return super().forward(x)
        var = self.running_var * (n / (n - 1))
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        with torch.no_grad():
            torch.mul(var, (n - 1) / n, out=self.running_var)
            self.num_batches_tracked.add_(1)
        return out

    def synced_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over ``self.group``, with flax's ``_compute_stats``:
        one differentiable all-reduce of the per-channel ``[Σx, Σx²]`` and
        the element count, in float32 (float64 for a float64 input), then
        ``var = max(E[x²] - E[x]², 0)``, ``y = (x - mean) · rsqrt(var +
        eps) · weight + bias`` in the input's dtype, and the *biased*
        global variance folded into ``running_var`` with momentum 0.9.
        Every rank gets the same statistics, so the running ones stay
        equal without a broadcast.

        With ``lean`` the same forward runs inside one autograd function
        that keeps only the input, in its own dtype, and the statistics
        for the backward (the float32 copies above are transient there),
        and all-reduces the statistics' gradient in the backward itself:
        a quarter of the bytes for a bf16 input. Spatial sharding, which
        exists to hold less, sets it."""
        if self.lean:
            out, mean, var = _SyncedBatchNorm.apply(
                x, self.weight, self.bias, self.eps, self.group)
        else:
            out, mean, var = self._synced(x)
        with torch.no_grad():
            m = 1.0 - self.momentum  # flax's momentum, 0.9
            self.running_mean.mul_(m).add_(mean.detach(),
                                           alpha=self.momentum)
            self.running_var.mul_(m).add_(var.detach(), alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)

    def _synced(self, x: torch.Tensor):
        c = x.shape[1]
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = torch.cat([xs.sum((0, 2, 3)), (xs * xs).sum((0, 2, 3)),
                           xs.new_full((1,), x.numel() // c)])
        stats = all_reduce_sum(stats, self.group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xs - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return out, mean, var


class _SyncedBatchNorm(torch.autograd.Function):
    """``BatchNorm2d._synced`` (the same forward, op for op) keeping the
    input and the statistics, not its float32 intermediates; the
    backward is BN's: ``dx = w·invstd·(dy - mean(dy) - x̂·mean(dy·x̂))``,
    the two means over the group, the weight's and bias's gradients this
    rank's share."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = torch.cat([xs.sum((0, 2, 3)), (xs * xs).sum((0, 2, 3)),
                           xs.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        mul = invstd * weight
        out = (xs - mean[:, None, None]) * mul[:, None, None] \
            + bias[:, None, None]
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return out, mean, var

    @staticmethod
    def backward(ctx, grad, _mean, _var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        dy = grad.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean[:, None, None]) \
            * invstd[:, None, None]
        local = torch.cat([dy.sum((0, 2, 3)), (dy * xhat).sum((0, 2, 3))])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = (dy - (sums[:c] / n)[:, None, None]
              - xhat * (sums[c:] / n)[:, None, None]) \
            * (invstd * weight)[:, None, None]
        return (dx.to(x.dtype), local[c:].to(weight.dtype),
                local[:c].to(weight.dtype), None, None)


def sync_batch_norm(net: nn.Module,
                    group: Optional[dist.ProcessGroup]) -> None:
    """Have every ``BatchNorm2d`` of ``net`` take its train-mode
    statistics over ``group`` (None: this rank's batch alone)."""
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learned per-channel scale.

    ``x / (sqrt(sum x^2) + 1e-10) * weight`` over the channel axis (dim 1),
    computed in float32 even when the input is bf16 (the epsilon sits on
    the norm, not on the square), then cast back to the input's dtype.
    """

    def __init__(self, channels: int, initial_scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,),
                                              float(initial_scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True)) + 1e-10
        out = x32 / norm * self.weight.float().view(1, -1, 1, 1)
        return out.to(x.dtype)


# The 2x2 pools' backward, read each time a pool runs (the JAX package's
# switch, for A/B measurement: ``tools/bench_pool_backward.py``):
#   "select_scatter"  ATen's ``max_pool2d`` and its own backward, which
#                     saves the int64 index of each window's max (XLA's
#                     reduce_window VJP, select_and_scatter, in JAX);
#   "slice"           ``MaxPool2dSlice``: the same forward, saving the
#                     pooled output instead of the indices, and a backward
#                     of four strided slices, compares and an interleave.
POOL_BACKWARD = "select_scatter"
POOL_BACKWARDS = ("select_scatter", "slice")


@contextlib.contextmanager
def pool_backward(mode: str) -> Iterator[None]:
    """``POOL_BACKWARD = mode`` inside, the previous value restored on
    exit."""
    global POOL_BACKWARD
    if mode not in POOL_BACKWARDS:
        raise ValueError(f"POOL_BACKWARD must be one of {POOL_BACKWARDS}, "
                         f"got {mode!r}")
    prev, POOL_BACKWARD = POOL_BACKWARD, mode
    try:
        yield
    finally:
        POOL_BACKWARD = prev


class MaxPool2dSlice(torch.autograd.Function):
    """2x2 stride-2 max pool (even sizes) whose backward is the JAX
    package's first-tie-wins ``_pool2x2_bwd``: the first element of each
    window in row-major order ((0,0), (0,1), (1,0), (1,1)) equal to the
    max takes the whole gradient, as ATen's backward gives it (its
    forward keeps the first max). Equality against the output is exact:
    the max is one of the four inputs. So on finite inputs the gradient
    equals ATen's bit for bit, except that a -0 gradient stays -0 here
    (as in JAX's slice VJP) where ATen's sum into a zero gives +0.

    Saves ``(x, y)``: ``x`` is the ReLU's output, which autograd keeps
    anyway, and ``y`` a quarter of its size, where ATen keeps int64
    indices of ``y``'s size. The gradient is written into a buffer laid
    out like ``x`` (channels-last on the card), one strided
    ``torch.where`` per window position, so no layout copy follows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = F.max_pool2d(x, 2, 2)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, y = ctx.saved_tensors
        w00 = x[:, :, 0::2, 0::2] == y
        w01 = (x[:, :, 0::2, 1::2] == y) & ~w00
        taken = w00 | w01
        w10 = (x[:, :, 1::2, 0::2] == y) & ~taken
        w11 = ~(taken | w10)
        gx = torch.empty_like(x)
        zero = g.new_zeros(())
        for (i, j), w in (((0, 0), w00), ((0, 1), w01), ((1, 0), w10),
                          ((1, 1), w11)):
            torch.where(w, g, zero, out=gx[:, :, i::2, j::2])
        return gx


class MaxPool2x2(nn.Module):
    """2x2 stride-2 max pool of the trunk (``max_pool_2x2`` in JAX);
    ``ceil_mode`` rounds odd sizes up (pool3). Parameter-free; its
    backward is the one ``POOL_BACKWARD`` names when the pool runs. Under
    "slice" an odd size is padded bottom and right with -inf first in
    ceil mode, as JAX pads (the same windows as ATen's ceil mode), and
    cropped to even otherwise."""

    def __init__(self, ceil_mode: bool = False):
        super().__init__()
        self.ceil_mode = ceil_mode

    def extra_repr(self) -> str:
        return f"ceil_mode={self.ceil_mode}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if POOL_BACKWARD not in POOL_BACKWARDS:
            raise ValueError(f"POOL_BACKWARD must be one of "
                             f"{POOL_BACKWARDS}, got {POOL_BACKWARD!r}")
        if POOL_BACKWARD == "select_scatter":
            return F.max_pool2d(x, 2, 2, ceil_mode=self.ceil_mode)
        h, w = x.shape[2:]
        if self.ceil_mode and (h % 2 or w % 2):
            x = F.pad(x, (0, w % 2, 0, h % 2), value=-math.inf)
        elif h % 2 or w % 2:  # floor mode drops the odd row and column
            x = x[:, :, :h - h % 2, :w - w % 2]
        return MaxPool2dSlice.apply(x)


class QuantConv2d(nn.Module):
    """Int8 post-training-quantized convolution (inference only), the
    counterpart of ``refinedet_tpu/models/layers.py:QuantConv``.

    Symmetric quantization with per-input-channel activation scales folded
    into the weights (``quant/ptq.py``): ``xq[c] = clamp(round(x[c] *
    (1 / in_scale[c])), -127, 127)`` (the op ``int8_quantize``), then
    ``int8_conv(xq, kernel_q) * w_scale + bias`` (the op ``int8_conv``),
    then the NCHW view of the result. Buffers, not parameters:
    ``kernel_q`` int8 ``[O, kh, kw, C]`` (the kernel's layout; flax's is
    HWIO), ``w_scale`` ``[O]``, ``in_scale`` ``[C]`` and ``bias`` ``[O]``
    float32; ``quant.ptq.quantize_variables`` fills them (here they start
    as flax's init: zeros, ones, ones, zeros).

    Rounding as JAX's: ``1 / in_scale`` by IEEE division in float32, a
    float32 multiply, round half to even, then the clamp
    (``ops/int8_conv.py:int8_quantize_reference``). The input is NCHW
    with channels-last strides, so its NHWC view is contiguous (the
    quantize kernel copies one that is not, and counts it). The output
    dtype is the JAX module's ``dtype``: bfloat16 under bf16 autocast (the
    port's bf16 mode, which does not cast a custom op's output), float32
    otherwise; it is given to the op explicitly.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        k = kernel_size
        self.register_buffer("kernel_q", torch.zeros(
            (out_channels, k, k, in_channels), dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_channels))
        self.register_buffer("in_scale", torch.ones(in_channels))
        self.register_buffer("bias", torch.zeros(out_channels))

    def _apply(self, fn, recurse=True):
        # ``Module.to(memory_format=torch.channels_last)`` restrides every
        # 4-d tensor; the kernel reads each row of kernel_q K-contiguous.
        super()._apply(fn, recurse)
        self.kernel_q = self.kernel_q.contiguous()
        return self

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size="
                f"{self.kernel_size}, stride={self.stride}, padding="
                f"{self.padding}, dilation={self.dilation}")

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, C, H, W]`` -> int8 of the same shape (the NCHW view of
        the quantize op's NHWC result)."""
        return int8_quantize(x.permute(0, 2, 3, 1),
                             self.in_scale).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device.type
        out_dtype = torch.get_autocast_dtype(dev) \
            if torch.is_autocast_enabled(dev) else torch.float32
        xq = self.quantize_input(x).permute(0, 2, 3, 1)
        y = int8_conv(xq, self.kernel_q, self.w_scale, self.bias,
                      self.stride, self.padding, self.dilation, out_dtype)
        return y.permute(0, 3, 1, 2)
