"""The int8 convolution of the quantized network (CUDA C++ on Hopper).

Replaces XLA's int8 x int8 -> int32 ``conv_general_dilated`` in
``refinedet_tpu/models/layers.py:QuantConv`` (lines 83-89), which JAX left
to the compiler: torch has no int8 convolution on the card, so the port
writes it by hand (``csrc/int8_conv.cu``, a tiled implicit GEMM on
``mma.sync`` int8 tensor-core instructions; the source says what bounds it).

Contract: ``xq [B, H, W, C]`` int8 (NHWC), ``w [O, kh, kw, C]`` int8,
``w_scale`` and ``bias`` float32 ``[O]``, a square kernel's stride, padding
and dilation -> ``[B, Ho, Wo, O]`` in ``out_dtype``: float32 or bfloat16
``float(acc) * w_scale + bias`` (rounded after the product and after the
sum), or with ``torch.int32`` the exact int32 sums themselves. C must be a
multiple of 32 and O of 64.

The convolution is the PyTorch op ``refinedet_tpu_torch::int8_conv``
(``torch.library.custom_op``), registered when this module is imported:
its CPU implementation is the plain version ``int8_conv_reference``, its
CUDA one the launch, and a fake one gives ``torch.export`` the output's
shape and dtype (which autocast does not decide for a custom op), so an
exported program keeps each quantized conv as one node. A loader of such
a program imports ``refinedet_tpu_torch.ops`` first. For a CPU tensor the
wrapper computes the plain version; for a CUDA tensor it launches the
kernel or raises, and never falls back. ``int8_conv.launches`` counts
launches; a launch recorded into a CUDA graph counts in
``int8_conv.captured`` instead, and whoever replays the graph adds the
launches it holds (``serve/export.py:BucketGraph``).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use, from the
source in this package only, into ``_build/`` (``ops/cuda_build.py``),
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from refinedet_tpu_torch.ops.cuda_build import BUILD_DIR, HOPPER_FLAGS, \
    nvcc_build

SOURCE = BUILD_DIR.parent / "csrc" / "int8_conv.cu"
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
C_MULTIPLE = 32  # a K step of the kernel lies inside one tap
O_MULTIPLE = 64  # the block's output channels


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded int8-conv library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when this source's library was already built
    build_log: str        # nvcc's output, with ptxas -v ("" when reused)


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def load_kernel() -> KernelLibrary:
    """Build (once per source) and load the int8-conv library."""
    global _library
    with _lock:
        if _library is None:
            out, seconds, log = nvcc_build(SOURCE, HOPPER_FLAGS, "int8_conv")
            lib = ctypes.CDLL(str(out))
            lib.int8_conv_launch.argtypes = [ctypes.c_void_p] * 5 + \
                [ctypes.c_int] * 13 + [ctypes.c_void_p]
            lib.int8_conv_launch.restype = ctypes.c_int
            _library = KernelLibrary(lib, out, seconds, log)
        return _library


def out_size(n: int, k: int, stride: int, padding: int,
             dilation: int) -> int:
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def output_shape(xq: torch.Tensor, w: torch.Tensor, stride: int,
                 padding: int, dilation: int) -> Tuple[int, int, int, int]:
    b, h, wd, _ = xq.shape
    k = w.shape[1]
    return (b, out_size(h, k, stride, padding, dilation),
            out_size(wd, k, stride, padding, dilation), w.shape[0])


def _check(xq, w, w_scale, bias, stride, padding, dilation, out_dtype):
    if xq.dim() != 4 or w.dim() != 4:
        raise ValueError(f"need xq [B, H, W, C] and w [O, kh, kw, C], got "
                         f"{tuple(xq.shape)} and {tuple(w.shape)}")
    o, kh, kw, c = w.shape
    if kh != kw or xq.shape[-1] != c:
        raise ValueError(f"w {tuple(w.shape)} does not fit xq "
                         f"{tuple(xq.shape)} (square kernels, C last)")
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"need int8 xq and w, got {xq.dtype}, {w.dtype}")
    if w_scale.shape != (o,) or bias.shape != (o,) or \
            w_scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"need float32 w_scale and bias of shape ({o},)")
    if out_dtype not in OUT_KINDS:
        raise ValueError(f"out_dtype must be one of {list(OUT_KINDS)}, got "
                         f"{out_dtype}")
    if min(stride, dilation) < 1 or padding < 0:
        raise ValueError(f"bad geometry: stride {stride}, padding "
                         f"{padding}, dilation {dilation}")
    devices = {t.device for t in (xq, w, w_scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 conv for device {xq.device}")
    if xq.device.type == "cuda" and (c % C_MULTIPLE or o % O_MULTIPLE):
        raise ValueError(f"the int8 conv kernel takes C a multiple of "
                         f"{C_MULTIPLE} and O a multiple of {O_MULTIPLE}, "
                         f"got C={c}, O={o}")
    if min(output_shape(xq, w, stride, padding, dilation)[1:3]) < 1:
        raise ValueError(f"empty output for input {tuple(xq.shape)}")


def int8_conv_accumulate(xq: torch.Tensor, w: torch.Tensor, stride: int,
                         padding: int, dilation: int) -> torch.Tensor:
    """The plain int32 sums ``[B, Ho, Wo, O]``: a float64 convolution of
    the integer-valued tensors, exact (every partial sum is an integer
    below 2^31 < 2^53), then cast. On the card cuDNN is kept out of it:
    the native im2col-and-GEMM convolution is exact in any order."""
    x = xq.permute(0, 3, 1, 2).double()
    k = w.permute(0, 3, 1, 2).double()
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x, k, None, stride, padding, dilation)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def int8_conv_reference(xq: torch.Tensor, w: torch.Tensor,
                        w_scale: torch.Tensor, bias: torch.Tensor,
                        stride: int, padding: int, dilation: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: ``int8_conv_accumulate``, then
    ``(acc.float() * w_scale + bias).to(out_dtype)``, two roundings as in
    the kernel's epilogue (``torch.int32``: the sums)."""
    acc = int8_conv_accumulate(xq, w, stride, padding, dilation)
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * w_scale + bias).to(out_dtype)


@torch.library.custom_op("refinedet_tpu_torch::int8_conv", mutates_args=(),
                         device_types="cpu")
def int8_conv_op(xq: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor, stride: int, padding: int,
                 dilation: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The op; on the CPU, the plain version."""
    return int8_conv_reference(xq, w, w_scale, bias, stride, padding,
                               dilation, out_dtype)


@int8_conv_op.register_kernel("cuda")
def _launch(xq: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor, stride: int, padding: int, dilation: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel on the tensors' card; raises on anything it cannot
    take."""
    _check(xq, w, w_scale, bias, stride, padding, dilation, out_dtype)
    # An exported program calls the op with the strides the card's kernels
    # produce, which its trace (on fake tensors) may not have seen.
    xq, w = xq.contiguous(), w.contiguous()
    w_scale, bias = w_scale.contiguous(), bias.contiguous()
    if xq.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("xq and w must be 16-byte aligned (16-byte copies)")
    b, ho, wo, o = output_shape(xq, w, stride, padding, dilation)
    out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    kernel = load_kernel()
    _, h, wd, c = xq.shape
    k = w.shape[1]
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel.lib.int8_conv_launch(
            xq.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, h, wd, c, o, k, k, stride,
            padding, dilation, ho, wo, OUT_KINDS[out_dtype], stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err}")
    if capturing:
        int8_conv.captured += 1
    else:
        int8_conv.launches += 1
    return out


@int8_conv_op.register_fake
def _(xq: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
      bias: torch.Tensor, stride: int, padding: int, dilation: int,
      out_dtype: torch.dtype) -> torch.Tensor:
    return xq.new_empty(output_shape(xq, w, stride, padding, dilation),
                        dtype=out_dtype)


def int8_conv(xq: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor, stride: int = 1, padding: int = 0,
              dilation: int = 1,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, Ho, Wo, O]`` int8 convolution of NHWC ``xq`` by ``w [O, kh,
    kw, C]`` with the per-channel epilogue, through the op (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the kernel, which adds one to ``int8_conv.launches``."""
    _check(xq, w, w_scale, bias, stride, padding, dilation, out_dtype)
    return int8_conv_op(xq, w, w_scale, bias, int(stride), int(padding),
                        int(dilation), out_dtype)


int8_conv.launches = 0
int8_conv.captured = 0
