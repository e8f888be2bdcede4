"""The convolution epilogue (CUDA C++ on Hopper, ``csrc/conv_epilogue.cu``):
a convolution followed by a ReLU, as cuDNN's convolution without its bias
and one hand-written pass that adds the bias and applies the ReLU in place.

aten's ``_convolution`` runs cuDNN without the bias and then adds it with
``output.add_(bias.view(1, C, 1, 1))``, a broadcast that TensorIterator
does not vectorize; the ReLU after it is one more pass over the same
bytes. ``conv_bias_relu`` keeps the convolution (``aten.convolution`` with
no bias, cuDNN as before) and replaces both passes by
``conv_bias_relu_kernel``, whose result is bitwise that of ``add_`` then
``relu_``: the sum in float32, rounded once to the output's dtype, then
``r <= 0 ? +0 : r`` (NaN passes through). The backward is autograd's for
the two ops it replaces: ``threshold_backward`` on the output, then
``convolution_backward`` with the bias gradient.

Contract: ``x [B, C, H, W]`` and ``weight [O, C, kh, kw]``, channels-last
or contiguous, ``bias [O]``, one group, zero padding; bfloat16 or float32
(under autocast the wrapper casts all three to its dtype, as autocast
casts a convolution's); on the card O a multiple of 8 (``takes``).

It is the PyTorch op ``refinedet_tpu_torch::conv_bias_relu``
(``torch.library.custom_op``), registered when this module is imported.
Its CPU implementation is ``relu(conv2d(x, weight, bias))``, its CUDA one
the convolution and the launch, and a fake one runs ``aten.convolution``
on fake tensors, so ``torch.export`` sees the real kernel's shape, strides
and symbolic batch. ``FlopCounterMode`` counts it as the convolution.
``conv_bias_relu.launches`` counts launches of the epilogue; one recorded
into a CUDA graph counts in ``.captured`` instead, and whoever replays
the graph adds the launches it holds (``serve/export.py:BucketGraph``).

The op's dispatcher is Python (``custom_op``'s layers cost ~50-100 us of
host a call on the card's host, PERF.md). A call that records no autograd
node on a plain CUDA tensor, with nothing compiling, tracing (fake
tensors, a dispatch mode) or profiling it, runs the CUDA kernel's two
steps directly (``_undispatched``): eager inference, the eval CLIs, the
demos. Every other call goes through the op.

The library is compiled by ``nvcc`` for ``sm_90a`` at first use, from the
source in this package only, into ``_build/`` (``ops/cuda_build.py``),
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from refinedet_tpu_torch.ops.cuda_build import BUILD_DIR, HOPPER_FLAGS, \
    KernelLibrary, nvcc_build

SOURCE = BUILD_DIR.parent / "csrc" / "conv_epilogue.cu"
DTYPES = (torch.bfloat16, torch.float32)
C_MULTIPLE = 8  # a 16-byte vector of bf16 lies inside one pixel's channels

_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def load_kernel() -> KernelLibrary:
    """Build (once per source) and load the epilogue's library."""
    global _library
    with _lock:
        if _library is None:
            out, seconds, log = nvcc_build(SOURCE, HOPPER_FLAGS,
                                           "conv_epilogue")
            lib = ctypes.CDLL(str(out))
            lib.conv_bias_relu_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.conv_bias_relu_launch.restype = ctypes.c_int
            _library = KernelLibrary(lib, out, seconds, log)
        return _library


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a convolution of ``x`` computes in: autocast's where it
    is on for ``x``'s device type and would cast ``x`` (a floating dtype
    other than float64), else ``x``'s own."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev) and x.is_floating_point() and \
            x.dtype != torch.float64:
        return torch.get_autocast_dtype(dev)
    return x.dtype


def takes(conv: nn.Conv2d, x: torch.Tensor) -> bool:
    """Whether the epilogue takes ``conv`` on the input ``x``: a bias, one
    group, zero padding given as sizes, O a multiple of 8, and a bfloat16
    or float32 computation."""
    return (conv.bias is not None and conv.groups == 1
            and conv.padding_mode == "zeros"
            and not isinstance(conv.padding, str)
            and conv.out_channels % C_MULTIPLE == 0
            and compute_dtype(x) in DTYPES)


def _check_epilogue(y: torch.Tensor, bias: torch.Tensor) -> int:
    """Raise for what the kernel does not take; returns the layout flag
    (1 channels-last, 0 NCHW-contiguous), read from ``y``'s strides."""
    if y.dim() != 4 or bias.shape != (y.shape[1],):
        raise ValueError(f"need y [N, C, H, W] and bias [C], got "
                         f"{tuple(y.shape)} and {tuple(bias.shape)}")
    if y.dtype not in DTYPES or bias.dtype != y.dtype:
        raise ValueError(f"the epilogue takes bfloat16 or float32 y and a "
                         f"bias of its dtype, got {y.dtype}, {bias.dtype}")
    if y.shape[1] % C_MULTIPLE:
        raise ValueError(f"the epilogue takes C a multiple of {C_MULTIPLE}, "
                         f"got {y.shape[1]}")
    if y.device.type != "cuda" or bias.device != y.device:
        raise ValueError(f"the epilogue runs on one card, got y on "
                         f"{y.device}, bias on {bias.device}")
    if y.data_ptr() % 16:
        raise ValueError("y must be 16-byte aligned (vector loads)")
    if y.is_contiguous(memory_format=torch.channels_last):
        return 1
    if y.is_contiguous():
        return 0
    raise ValueError(f"the epilogue takes a channels-last or contiguous y, "
                     f"got strides {y.stride()}")


def bias_relu_(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``conv_bias_relu_kernel`` in place on ``y [N, C, H, W]`` (bfloat16
    or float32, channels-last or contiguous) with ``bias [C]`` of its
    dtype: bitwise ``y.add_(bias.view(1, C, 1, 1)).relu_()``. Returns
    ``y``; raises on anything the kernel does not take."""
    channels_last = _check_epilogue(y, bias)
    if y.numel() == 0:
        return y
    bias = bias.contiguous()
    kernel = load_kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel.lib.conv_bias_relu_launch(
            y.data_ptr(), bias.data_ptr(), y.numel(), y.shape[1],
            y.shape[2] * y.shape[3], channels_last,
            int(y.dtype == torch.bfloat16), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err:
        raise RuntimeError(f"conv_bias_relu launch failed: CUDA error {err}")
    if capturing:
        conv_bias_relu.captured += 1
    else:
        conv_bias_relu.launches += 1
    return y


def _convolution(x, weight, stride, padding, dilation) -> torch.Tensor:
    return torch.ops.aten.convolution(x, weight, None, stride, padding,
                                      dilation, False, [0, 0], 1)


@torch.library.custom_op("refinedet_tpu_torch::conv_bias_relu",
                         mutates_args=(), device_types="cpu")
def conv_bias_relu_op(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, stride: List[int],
                      padding: List[int], dilation: List[int]
                      ) -> torch.Tensor:
    """The op; on the CPU, the two ops it replaces."""
    return torch.relu(F.conv2d(x, weight, bias, stride, padding, dilation))


@conv_bias_relu_op.register_kernel("cuda")
def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            stride: List[int], padding: List[int], dilation: List[int]
            ) -> torch.Tensor:
    """cuDNN's convolution without the bias, then the epilogue in place
    on its output, which is returned."""
    return bias_relu_(_convolution(x, weight, stride, padding, dilation),
                      bias)


@conv_bias_relu_op.register_fake
def _(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
      stride: List[int], padding: List[int], dilation: List[int]
      ) -> torch.Tensor:
    return _convolution(x, weight, stride, padding, dilation)


def _setup_context(ctx, inputs, output) -> None:
    x, weight, bias, stride, padding, dilation = inputs
    ctx.save_for_backward(x, weight, output)
    ctx.geometry = (stride, padding, dilation)
    ctx.bias_sizes = [bias.shape[0]]


def _backward(ctx, grad: torch.Tensor):
    x, weight, out = ctx.saved_tensors
    stride, padding, dilation = ctx.geometry
    grad = torch.ops.aten.threshold_backward(grad, out, 0)
    gx, gw, gb = torch.ops.aten.convolution_backward(
        grad, x, weight, ctx.bias_sizes, stride, padding, dilation, False,
        [0, 0], 1, list(ctx.needs_input_grad[:3]))
    return gx, gw, gb, None, None, None


conv_bias_relu_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.refinedet_tpu_torch.conv_bias_relu)
def _flops(x_shape, w_shape, bias_shape, stride, padding, dilation, *,
           out_shape=None, **kwargs) -> int:
    return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)


def _undispatched(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` may skip the op's dispatcher: a plain CUDA
    tensor (not fake, not a subclass), no gradient recorded, nothing
    compiling, no dispatch mode and no profiler (a trace files the kernel
    under the op's name)."""
    return (type(x) is torch.Tensor and x.is_cuda
            and not torch.is_grad_enabled()
            and not torch.compiler.is_compiling()
            and _get_current_dispatch_mode() is None
            and not torch._C._autograd._profiler_enabled())


def conv_bias_relu(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, stride: Sequence[int] = (1, 1),
                   padding: Sequence[int] = (0, 0),
                   dilation: Sequence[int] = (1, 1)) -> torch.Tensor:
    """``relu(conv2d(x, weight, bias, stride, padding, dilation))`` through
    the op (see the module docstring). Under autocast ``x``, ``weight``
    and ``bias`` are cast to its dtype first, as autocast casts a
    convolution's. CUDA tensors launch the epilogue, which adds one to
    ``conv_bias_relu.launches``; without the dispatcher where
    ``_undispatched``."""
    dtype = compute_dtype(x)
    if dtype != x.dtype or dtype != weight.dtype or dtype != bias.dtype:
        x, weight, bias = x.to(dtype), weight.to(dtype), bias.to(dtype)
    if _undispatched(x):
        return bias_relu_(_convolution(x, weight, stride, padding, dilation),
                          bias)
    return conv_bias_relu_op(x, weight, bias, list(stride), list(padding),
                             list(dilation))


conv_bias_relu.launches = 0
conv_bias_relu.captured = 0
