"""The convolution epilogue (``ops/conv_epilogue.py``) at a network's
fused convolutions: which convolutions of a forward run as
``conv_bias_relu``, and on the card the epilogue's device time over their
outputs against its bytes bound and aten's ``add_`` + ``relu_`` on the
same tensors (``chip_smoke.py`` phase 17 prints it for each benchmark
cell).

The fused convolutions come from one forward of a net on fake CUDA
tensors (``on_fake_card``: no card, no memory, no FLOPs), so the
engagement rule of ``models/refinedet.py`` is read as it runs. The bound
reads and writes each output once at 3.35 TB/s. Times are CUDA graphs of
``GRAPH_PASSES`` passes over every output (``k1_bench.graph_ms``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from refinedet_tpu_torch.models.refinedet import RefineDet
from refinedet_tpu_torch.ops import conv_epilogue
from refinedet_tpu_torch.tools.int8_bench import H100_BYTES_PER_S

GRAPH_PASSES = 20


class _Record(TorchDispatchMode):
    """Notes each ``conv_bias_relu`` call: its output's shape and the
    convolution's geometry."""

    def __init__(self):
        super().__init__()
        self.calls: List[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.refinedet_tpu_torch.conv_bias_relu.default:
            x, w, _, stride, padding, dilation = args
            self.calls.append({"x": tuple(x.shape), "w": tuple(w.shape),
                               "y": tuple(out.shape), "stride": stride,
                               "padding": padding, "dilation": dilation})
        return out


def fused_calls(net: torch.nn.Module, images: torch.Tensor) -> List[dict]:
    """The ``conv_bias_relu`` calls of one forward of ``net`` on NHWC
    ``images``, in order (no gradient is recorded)."""
    rec = _Record()
    with torch.no_grad(), rec:
        net(images)
    return rec.calls


@contextlib.contextmanager
def on_fake_card(net: RefineDet) -> Iterator[RefineDet]:
    """``net``, built on the meta device, on fake CUDA tensors in eval
    mode without gradients (a fake forward needs neither a card nor
    memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    net.requires_grad_(False).eval()
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        yield net.to_empty(device="cuda")


def fused_shapes(size: int, num_classes: int, batch: int,
                 use_bn: bool = False,
                 quant_skip: Optional[Sequence[str]] = None) -> List[dict]:
    """The ``conv_bias_relu`` calls of one forward of RefineDet``size`` at
    ``batch`` on the card (the int8 twin with ``quant_skip``)."""
    with torch.device("meta"):
        net = RefineDet(num_classes, size, use_bn=use_bn,
                        quant=quant_skip is not None,
                        quant_skip=quant_skip or ())
    with on_fake_card(net) as card_net:
        return fused_calls(card_net, torch.empty((batch, size, size, 3),
                                                 device="cuda"))


def distinct(shapes: Sequence[dict]) -> List[dict]:
    """``shapes`` without repeats of one input, weight and geometry."""
    seen, out = set(), []
    for s in shapes:
        key = (s["x"], s["w"], str((s["stride"], s["padding"],
                                    s["dilation"])))
        if key not in seen:
            seen.add(key)
            out.append(s)
    return out


def conv_inputs(s: dict, generator: torch.Generator, device) -> tuple:
    """Seeded float32 ``x`` and ``weight`` (channels-last, unit-scale
    outputs) and ``bias`` of the conv of a ``fused_shapes`` entry."""
    x = torch.randn(s["x"], generator=generator, device=device)
    w = torch.randn(s["w"], generator=generator, device=device) / \
        s["w"][1] ** 0.5
    b = torch.randn(s["w"][0], generator=generator, device=device)
    return (x.to(memory_format=torch.channels_last),
            w.to(memory_format=torch.channels_last), b)


def bytes_moved(shapes: Sequence[dict], itemsize: int = 2) -> int:
    """Bytes the epilogue reads and writes over ``shapes``' outputs."""
    return sum(2 * itemsize * torch.Size(s["y"]).numel() for s in shapes)


def bound_ms(shapes: Sequence[dict], itemsize: int = 2) -> float:
    return bytes_moved(shapes, itemsize) / H100_BYTES_PER_S * 1e3


def outputs(shapes: Sequence[dict], dtype: torch.dtype, device,
            seed: int = 0) -> List[tuple]:
    """A channels-last output and a bias for each shape, seeded."""
    g = torch.Generator(device).manual_seed(seed)
    out = []
    for s in shapes:
        y = torch.randn(s["y"], generator=g, device=device).to(
            dtype, memory_format=torch.channels_last)
        out.append((y, torch.randn(s["y"][1], generator=g,
                                   device=device).to(dtype)))
    return out


def time_ms(shapes: Sequence[dict], dtype: torch.dtype = torch.bfloat16,
            device="cuda") -> dict:
    """Device ms of one pass over every output of ``shapes``: the
    epilogue (``ms``) and aten's ``add_`` then ``relu_`` (``library_ms``),
    each a CUDA graph of ``GRAPH_PASSES`` passes; with the bound."""
    from refinedet_tpu_torch.tools.k1_bench import graph_ms
    ys = outputs(shapes, dtype, device)

    def epilogue():
        for y, b in ys:
            conv_epilogue.bias_relu_(y, b)

    def aten():
        for y, b in ys:
            y.add_(b.view(1, -1, 1, 1)).relu_()

    itemsize = torch.empty((), dtype=dtype).element_size()
    return {"ms": graph_ms(epilogue, GRAPH_PASSES),
            "library_ms": graph_ms(aten, GRAPH_PASSES),
            "bound_ms": bound_ms(shapes, itemsize),
            "bytes": bytes_moved(shapes, itemsize), "launches": len(ys)}
