"""Shapes, inputs and yardsticks for the int8 convolution kernel
(``ops/int8_conv.py``, ``csrc/int8_conv.cu``) on the card.

Used by ``chip_smoke.py`` (phase 11) and ``tests/test_torch_port_gpu.py``:

  * ``conv_shapes``: every quantizable conv of a RefineDet at its real
    input shape, from one forward on the meta device (no FLOPs);
  * ``distinct``: those shapes once each, with how many convs of a
    forward share them;
  * ``random_case``: seeded int8 inputs, weights and epilogue at a shape;
  * ``bound_ms``: the least time the card could take for one such conv;
  * ``int_mm_conv``: the library call the kernel is held against, im2col
    by a strided view of the padded int8 NHWC tensor and one copy, then
    ``torch._int_mm`` (cuBLASLt) and the same epilogue. It is timed
    beside the kernel and used nowhere in the port;
  * ``made_up_stats``: per-channel calibration statistics from a seed, to
    quantize a network without a calibration forward.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from refinedet_tpu_torch.models.refinedet import RefineDet
from refinedet_tpu_torch.ops.int8_conv import output_shape

H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak (data sheet)
H100_BYTES_PER_S = 3.35e12     # HBM3


def conv_shapes(size: int = 320, num_classes: int = 21,
                quant_skip: Sequence[str] = (), use_bn: bool = False
                ) -> List[dict]:
    """Every conv the int8 twin quantizes (all but ``quant_skip``), in
    forward order, at batch 1: name, input ``(H, W, C)``, ``O`` and the
    geometry ``(k, stride, padding, dilation)``."""
    from refinedet_tpu_torch.quant.gptq import module_geometry
    from refinedet_tpu_torch.quant.ptq import conv_input_hooks

    net = RefineDet(num_classes, size, use_bn, quant_skip=quant_skip)
    net = net.to("meta")
    out: List[dict] = []

    def record(name, module, x):
        out.append({"name": name, "hwc": tuple(x.shape[i] for i in (2, 3, 1)),
                    "o": module.out_channels,
                    "geom": module_geometry(module)})

    with conv_input_hooks(net, net.calibrated, record), torch.no_grad():
        net(torch.empty((1, size, size, 3), device="meta"))
    return out


def distinct(shapes: List[dict]) -> List[dict]:
    """One entry per distinct (input, O, geometry), in first-seen order,
    with ``count`` (convs of a forward at that shape) and their names."""
    seen: Dict[tuple, dict] = {}
    for s in shapes:
        key = (s["hwc"], s["o"], s["geom"])
        if key not in seen:
            seen[key] = dict(s, count=0, names=[])
        seen[key]["count"] += 1
        seen[key]["names"].append(s["name"])
    return list(seen.values())


def random_case(shape: dict, batch: int, device, seed: int):
    """(xq [B, H, W, C], w [O, k, k, C], w_scale [O], bias [O]) from a
    seed, the int8 values over their whole range."""
    gen = torch.Generator().manual_seed(seed)
    h, w, c = shape["hwc"]
    k = shape["geom"][0]
    o = shape["o"]
    xq = torch.randint(-127, 128, (batch, h, w, c), generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, k, k, c), generator=gen,
                       dtype=torch.int8)
    ws = torch.rand(o, generator=gen) * 1e-4 + 1e-6
    bias = torch.randn(o, generator=gen)
    return xq.to(device), wq.to(device), ws.to(device), bias.to(device)


def work(shape: dict, batch: int) -> tuple:
    """(operations, bytes) of one conv: 2 per multiply-add, each input
    and the weight read once, the bf16 output written once."""
    h, w, c = shape["hwc"]
    k, s, p, d = shape["geom"]
    _, ho, wo, o = output_shape(torch.empty((batch, h, w, c), device="meta"),
                                torch.empty((shape["o"], k, k, c),
                                            device="meta"), s, p, d)
    macs = batch * ho * wo * o * k * k * c
    nbytes = batch * h * w * c + o * k * k * c + 8 * o + \
        2 * batch * ho * wo * o
    return 2 * macs, nbytes


def bound_ms(shape: dict, batch: int) -> tuple:
    """(least ms, "operations" or "bytes") on the card for one conv."""
    ops, nbytes = work(shape, batch)
    ops_ms = ops / H100_INT8_OPS_PER_S * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"


def int_mm_conv(xq: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor, stride: int, padding: int,
                dilation: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The library yardstick of the same function: im2col of the padded
    NHWC int8 tensor through a strided view and one copy (``F.unfold``
    has no int8 kernel on the card), ``torch._int_mm`` of [M, K] by the
    column-major [K, O] weight, and the epilogue."""
    b, h, wd, c = xq.shape
    o, k = w.shape[0], w.shape[1]
    _, ho, wo, _ = output_shape(xq, w, stride, padding, dilation)
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    sb, sh, sw, sc = xp.stride()
    cols = xp.as_strided((b, ho, wo, k, k, c),
                         (sb, stride * sh, stride * sw, dilation * sh,
                          dilation * sw, sc)).reshape(b * ho * wo, k * k * c)
    acc = torch._int_mm(cols, w.reshape(o, -1).t())
    out = (acc.float() * w_scale + bias).to(out_dtype)
    return out.view(b, ho, wo, o)


def made_up_stats(net, seed: int) -> Dict[str, np.ndarray]:
    """``calibrate_amax``-shaped statistics for every conv ``net``
    quantizes: per channel a max in [0.5, 8) and three percentiles below
    it."""
    from refinedet_tpu_torch.quant.ptq import quant_modules

    rng = np.random.RandomState(seed)
    return {name: np.sort(rng.uniform(0.5, 8, (4, m.in_channels)),
                          axis=0)[::-1].astype(np.float32)
            for name, m in quant_modules(net).items()}
