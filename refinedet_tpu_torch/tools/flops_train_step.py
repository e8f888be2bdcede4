"""Count the FLOPs and the unfused bytes of the RefineDet forward and
train step.

    python -m refinedet_tpu_torch.tools.flops_train_step [BATCH]
        [--device cuda]

The port of ``tools/flops_train_step.py`` (batch 64 by default):
RefineDet320, 2 classes, bf16, the JAX tools' batch
(``profile_train_step.train_setup``). ``forward`` (the train-mode
forward), ``fwd+loss`` (with matching and the mined losses) and ``full
step`` (``make_train_step``'s step: loss, backward, SGD) run once at
batch 4 on the device asked for, and the counts are scaled linearly to
``BATCH``, as the JAX tool does (every FLOP carries the batch).

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which
counts the matrix products and convolutions only, each at 2·MACs over
every tap of its kernel, padding included: the forward's count equals
``tools/train_check.py:conv_flops`` exactly. XLA's ``cost_analysis()``
(the JAX tool's source) counts a convolution's taps over the unpadded
input only, and adds the elementwise ops. The tool prints that count of
the convolutions too (``unpadded_conv_flops``). For the 128-px forward
at batch 1 (``tests/test_torch_port_profile.py``): the port's count
11.998 GFLOP, its convolutions over unpadded taps 11.113 GFLOP, XLA's
11.126 GFLOP (the unpadded taps plus 0.11% of elementwise ops); the
padded taps are 7.4% of the port's count at that size.

Bytes come from a ``TorchDispatchMode`` that adds up every aten op's
input and output tensor bytes (view ops, which move nothing, left out).
They are the bytes an unfused execution moves, one op at a time, printed
as "unfused bytes": XLA's "bytes accessed" is counted after fusion and is
not the same quantity.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from refinedet_tpu_torch.device import resolve_device
from refinedet_tpu_torch.tools.profile_train_step import (device_name,
                                                          train_setup)
from refinedet_tpu_torch.train.train_step import (create_train_state,
                                                  make_train_step,
                                                  train_losses)

SMALL = 4  # the batch counted; scaled up linearly


class UnfusedBytes(TorchDispatchMode):
    """Adds up the bytes of every tensor each aten op reads or writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def _taps(n_in: int, n_out: int, k: int, stride: int, pad: int,
          dilation: int) -> int:
    """Kernel taps that land on the input, summed over the outputs."""
    return sum(0 <= o * stride - pad + t * dilation < n_in
               for o in range(n_out) for t in range(k))


def unpadded_conv_flops(net: nn.Module, images: torch.Tensor) -> int:
    """The convolutions' FLOPs as XLA's cost analysis counts them: 2·MACs
    over the taps that land on the unpadded input (a transposed conv's
    every tap does). Only shapes are read."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        x = inputs[0]
        per = 2 * mod.in_channels * mod.out_channels // mod.groups
        if isinstance(mod, nn.ConvTranspose2d):
            total += per * mod.kernel_size[0] * mod.kernel_size[1] * \
                x.shape[0] * x.shape[2] * x.shape[3]
            return
        th, tw = (_taps(x.shape[2 + i], out.shape[2 + i],
                        mod.kernel_size[i], mod.stride[i], mod.padding[i],
                        mod.dilation[i]) for i in range(2))
        total += per * th * tw * x.shape[0]

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            net(images)
    finally:
        for h in handles:
            h.remove()
    return total


def count(fn) -> tuple:
    """(FLOPs, unfused bytes) of one call of ``fn()``."""
    with FlopCounterMode(display=False) as flops, UnfusedBytes() as moved:
        fn()
    return flops.get_total_flops(), moved.bytes


def counts(batch: int, device) -> dict:
    """name -> (FLOPs, unfused bytes) at batch ``SMALL``, scaled to
    ``batch``, and the forward's convolutions over unpadded taps,
    scaled."""
    model, optimizer, cfg, images, boxes, labels, valid = train_setup(
        SMALL, device)

    def fwd():
        with torch.no_grad():
            model.raw_forward(images, train=True)

    def fwd_loss():
        with torch.no_grad():
            heads = model.raw_forward(images, train=True)
            train_losses(model, heads, boxes, labels, valid, cfg)

    step = make_train_step(model, optimizer, cfg)
    state = create_train_state(model, optimizer)

    def full():
        step(state, images, boxes, labels, valid)

    scale = batch / SMALL
    out = {name: tuple(v * scale for v in count(fn))
           for name, fn in (("forward", fwd), ("fwd+loss", fwd_loss),
                            ("full step", full))}
    out["unpadded_conv_flops"] = unpadded_conv_flops(model.net,
                                                     images) * scale
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    out = counts(args.batch, dev)
    print(f"device: {device_name(dev)}; counted at batch {SMALL}, scaled "
          f"to {args.batch}", flush=True)
    for name in ("forward", "fwd+loss", "full step"):
        fl, by = out[name]
        print(f"{name:>10s} @ b{args.batch}: {fl / 1e12:8.3f} TFLOP   "
              f"{by / 1e9:8.2f} GB unfused bytes   "
              f"{fl / by:6.1f} FLOP/B unfused", flush=True)
    print(f"   forward convolutions over unpadded taps (XLA's count): "
          f"{out['unpadded_conv_flops'] / 1e12:8.3f} TFLOP", flush=True)
    return out


if __name__ == "__main__":
    main()
