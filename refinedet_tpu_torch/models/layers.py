"""Shared model building blocks (NCHW modules).

Port of ``refinedet_tpu/models/layers.py``: the L2Norm tap and the 2x2
stride-2 max pools of the VGG trunk, plus the BatchNorm of the BN variant
with the semantics of the JAX package's ``flax.linen.BatchNorm``. The int8
``QuantConv`` and the slice-backward pool are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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
