"""The reference's post-training int8 quantization (PTQ), worked out again
from the float weights and the calibration images.

The scheme the port's ``quant/ptq.py`` states (symmetric, per channel,
SmoothQuant-style folding), in plain PyTorch float32:

  * calibration: per quantized conv, the ``[amax, p99.99, p99.9, p99]``
    of ``|x|`` per input channel over each batch (the percentiles by
    linear interpolation between sorted ranks, in float32 as
    ``jnp.percentile`` computes them), the running max over the batches;
  * ``in_scale[c] = max(p99.99[c], 1e-3 amax[c]) / 127`` (a channel dead
    on the whole stream takes 5% of the layer's max);
  * ``W' = W * in_scale`` per input channel, ``w_scale[o] = max|W'[o]| /
    127``, ``kernel_q = clip(round(W' / w_scale), -127, 127)``.

``levels`` (127 for int8) is the only knob: 7 gives the int4 control,
with activations and weights both on +/-7.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

PERCENTILES = (99.99, 99.9, 99.0)
DEFAULT_SKIP = ("vgg_conv1_2", "vgg_conv2_1")


def _taps(n: int):
    q = np.asarray(PERCENTILES, np.float32) / np.float32(100)
    qn = q * (np.float32(n) - np.float32(1))
    lo, hi = np.floor(qn), np.ceil(qn)
    hw = qn - lo
    lw = np.float32(1) - hw
    lo = np.clip(lo, 0, n - 1).astype(np.int64)
    hi = np.clip(hi, 0, n - 1).astype(np.int64)
    return [(int(a), int(b), float(c), float(d))
            for a, b, c, d in zip(lo, hi, lw, hw)]


def input_stats(x: torch.Tensor) -> torch.Tensor:
    """[4, C] float32: amax and the three percentiles of |x| per channel
    of NCHW ``x`` over all B·H·W positions."""
    c = x.shape[1]
    xc = x.float().transpose(0, 1).reshape(c, -1).abs()
    n = xc.shape[1]
    taps = _taps(n)
    top = torch.topk(xc, n - min(t[0] for t in taps), dim=1).values
    rows = [top[:, 0]]
    for lo, hi, lw, hw in taps:
        rows.append(top[:, n - 1 - lo] * lw + top[:, n - 1 - hi] * hw)
    return torch.stack(rows)


@torch.no_grad()
def calibrate(net, batches: Iterable[torch.Tensor],
              skip: Sequence[str] = DEFAULT_SKIP) -> Dict[str, torch.Tensor]:
    """{module path: [4, C] stats} of every quantized conv's input, the
    running max over ``batches`` (NHWC float32, preprocessed as served)."""
    from portbench.reference.net import quantizable
    paths = {p for n, p in quantizable().items() if n not in skip}
    stats: Dict[str, torch.Tensor] = {}

    def tap(path, x):
        if path in paths:
            s = input_stats(x)
            stats[path] = s if path not in stats else torch.maximum(
                stats[path], s)

    for images in batches:
        net(images, taps=tap)
    return stats


@torch.no_grad()
def quantize(net, stats: Dict[str, torch.Tensor], levels: int = 127
             ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """{module path: (kernel_q, w_scale, in_scale, bias)} from the float
    weights of ``net`` and the calibration ``stats``."""
    out = {}
    for path, st in stats.items():
        m = net.get_submodule(path)
        amax = st[0]
        clip = torch.maximum(st[1], 1e-3 * amax)
        layer_max = float(amax.max())
        if layer_max > 0:
            clip = torch.where(amax <= 0, 0.05 * layer_max, clip)
        in_scale = torch.clamp(clip / levels, min=1e-12)
        w = m.weight.float() * in_scale.view(1, -1, 1, 1)
        w_scale = torch.clamp(w.abs().amax((1, 2, 3)) / levels, min=1e-12)
        kernel_q = torch.clamp(torch.round(w / w_scale.view(-1, 1, 1, 1)),
                               -levels, levels)
        out[path] = (kernel_q, w_scale, in_scale, m.bias.float().clone())
    return out
