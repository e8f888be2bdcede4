"""The yardstick's peaks, operation counts and kernel bounds.

Peaks are NVIDIA's data sheet for one H100 SXM, dense, at its 700 W
limit. Counts are taken from shapes alone (the reference network on the
meta device), so they read the same whatever implements the work:

  * a convolution is 2 MACs per tap over every tap of its kernel, padding
    included, as ``torch.utils.flop_counter.FlopCounterMode`` counts it
    (the port's ``tools/flops_train_step.py`` counting): ``conv_flops``;
  * a train step is the network's forward and backward under
    ``FlopCounterMode`` (a backward conv is one forward's count for the
    input gradient, where the input needs one, and one for the weights),
    plus the augmentation's two resampling contractions;
  * kernel bounds are those of the port's ``tools/k1_bench.py`` and
    ``tools/int8_bench.py``: K1 the larger of G·K·18 bytes at the HBM
    rate and 15 operations per IoU test at the float32 rate, over the
    least tests greedy NMS needs, sum(kept (kept - 1) / 2 + valid - kept);
    an int8 conv the larger of 2·MACs at the int8 rate and (xq + w + bf16
    out) bytes at the HBM rate; a quantize its bytes (the activation read
    once, int8 written once) at the HBM rate.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from portbench.reference.net import RefineDet

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
IOU_OPS = 15
K1_BYTES_PER_CANDIDATE = 18


def _meta_net(num_classes: int):
    with torch.device("meta"):
        return RefineDet(num_classes)


def conv_shapes(size: int, num_classes: int, batch: int) -> List[dict]:
    """Every conv of one forward at ``batch``: module path, input [B, C, H,
    W], output shape, kernel taps, transposed or not."""
    net = _meta_net(num_classes)
    out = []

    def hook(mod, inputs, y):
        out.append({"path": net.paths[mod], "x": tuple(inputs[0].shape),
                    "y": tuple(y.shape), "k": tuple(mod.kernel_size),
                    "transposed": isinstance(mod, nn.ConvTranspose2d)})

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.no_grad():
        net(torch.empty((batch, size, size, 3), device="meta"))
    for h in handles:
        h.remove()
    return out


def conv_flops(shape: dict) -> int:
    """2·MACs over every kernel tap of one conv (a transposed conv: per
    input position)."""
    kh, kw = shape["k"]
    b, cin = shape["x"][:2]
    cout = shape["y"][1]
    pos = shape["x"][2] * shape["x"][3] if shape["transposed"] else \
        shape["y"][2] * shape["y"][3]
    return 2 * b * pos * cin * cout * kh * kw


def forward_flops(size: int, num_classes: int, batch: int,
                  int8_paths: Sequence[str] = ()) -> Dict[str, int]:
    """{"float": FLOPs, "int8": operations of the convs at ``int8_paths``}
    of one forward."""
    out = {"float": 0, "int8": 0}
    for s in conv_shapes(size, num_classes, batch):
        out["int8" if s["path"] in int8_paths else "float"] += conv_flops(s)
    return out


def train_step_flops(size: int, num_classes: int, batch: int,
                     staging: int) -> int:
    """FLOPs of one train step: forward and backward of the network as
    ``FlopCounterMode`` counts them, and the resampling of the staged
    batch (two contractions, 3 channels)."""
    from torch.utils.flop_counter import FlopCounterMode
    net = _meta_net(num_classes)
    x = torch.empty((batch, size, size, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        heads = net(x)
        sum(h.sum() for h in heads).backward()
    resample = 2 * batch * 3 * (staging * staging * size
                                + staging * size * size)
    return counter.get_total_flops() + resample


def k1_bound_s(groups_kept_valid: Sequence[tuple], top_k: int) -> float:
    """Least seconds of one K1 launch over groups given as (kept, valid)."""
    g = len(groups_kept_valid)
    tests = sum(k * (k - 1) // 2 + (v - k) for k, v in groups_kept_valid)
    return max(g * top_k * K1_BYTES_PER_CANDIDATE / HBM_BYTES,
               IOU_OPS * tests / F32_FLOPS)


def int8_conv_bound_s(shape: dict) -> float:
    """Least seconds of one int8 conv (``conv_shapes`` entry)."""
    b, c, h, w = shape["x"]
    _, o, ho, wo = shape["y"]
    kh, kw = shape["k"]
    ops = 2 * b * ho * wo * o * kh * kw * c
    nbytes = b * h * w * c + o * kh * kw * c + 8 * o + 2 * b * ho * wo * o
    return max(ops / INT8_OPS, nbytes / HBM_BYTES)


def int8_quantize_bound_s(shape: dict) -> float:
    """Least seconds of the quantize before one int8 conv: the bf16
    activation read once (2 bytes), int8 written once, the scales read."""
    b, c, h, w = shape["x"]
    return (b * h * w * c * 3 + 4 * c) / HBM_BYTES
