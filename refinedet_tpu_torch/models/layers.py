"""Shared model building blocks (NCHW modules).

Port of ``refinedet_tpu/models/layers.py``: the L2Norm tap and the 2x2
stride-2 max pools of the VGG trunk, plus the BatchNorm of the BN variant
with the semantics of the JAX package's ``flax.linen.BatchNorm``, and the
int8 ``QuantConv`` as ``QuantConv2d``. The slice-backward pool is not
ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from refinedet_tpu_torch.ops.int8_conv import int8_conv, int8_quantize


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
    never read (a fixed momentum)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


def max_pool_2x2(ceil_mode: bool = False) -> nn.MaxPool2d:
    """2x2 stride-2 max pool; ``ceil_mode`` rounds odd sizes up (pool3)."""
    return nn.MaxPool2d(2, 2, ceil_mode=ceil_mode)


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
