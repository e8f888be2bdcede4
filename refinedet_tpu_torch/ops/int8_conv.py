"""The int8 path's two kernels (CUDA C++ on Hopper, ``csrc/int8_conv.cu``):
the int8 convolution and the activation quantize in front of it.

The convolution replaces XLA's int8 x int8 -> int32
``conv_general_dilated`` in ``refinedet_tpu/models/layers.py:QuantConv``
(lines 83-89), which JAX left to the compiler: torch has no int8
convolution on the card. The kernel is an implicit GEMM on ``wgmma``
(s8, both operands in shared memory) fed by TMA, with a persistent grid
and split K where the tiles alone do not fill the card; ``plan`` computes
its tiling here, so the CPU tests reach everything around the kernel.
The source says what bounds it.

Contract: ``xq [B, H, W, C]`` int8 (NHWC), ``w [O, kh, kw, C]`` int8,
``w_scale`` and ``bias`` float32 ``[O]``, a square kernel's stride, padding
and dilation -> ``[B, Ho, Wo, O]`` in ``out_dtype``: float32 or bfloat16
``float(acc) * w_scale + bias`` rounded once, as one fused multiply-add
(XLA computes ``QuantConv``'s epilogue so), or with ``torch.int32`` the
exact int32 sums themselves. On the card
C must be a multiple of 32, O of 64, the stride 1 or 2, and the input at
least as wide and high as the stride.

The quantize replaces ``clip(round(x * (1 / in_scale)), -127, 127)`` of
``QuantConv`` (lines 79-80), which XLA fuses: NHWC ``x`` bfloat16 or
float32, ``in_scale [C]`` float32 -> int8 of ``x``'s shape, in one pass
(``int8_quantize``).

Each is a PyTorch op (``torch.library.custom_op``), registered when this
module is imported: ``refinedet_tpu_torch::int8_conv`` and
``refinedet_tpu_torch::int8_quantize``. The CPU implementation is the
plain version (``int8_conv_reference``, ``int8_quantize_reference``), the
CUDA one the launch, and a fake one gives ``torch.export`` the output's
shape and dtype (which autocast does not decide for a custom op), so an
exported program keeps each as one node. A loader of such a program
imports ``refinedet_tpu_torch.ops`` first. For a CPU tensor the wrapper
computes the plain version; for a CUDA tensor it launches the kernel or
raises, and never falls back. ``int8_conv.launches`` and
``int8_quantize.launches`` count launches; a launch recorded into a CUDA
graph counts in ``.captured`` instead, and whoever replays the graph adds
the launches it holds (``serve/export.py:BucketGraph``).

The library is compiled by ``nvcc`` for ``sm_90a`` at first use, from the
source in this package only, into ``_build/`` (``ops/cuda_build.py``),
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from refinedet_tpu_torch.ops.cuda_build import BUILD_DIR, HOPPER_FLAGS, \
    KernelLibrary, nvcc_build

SOURCE = BUILD_DIR.parent / "csrc" / "int8_conv.cu"
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
C_MULTIPLE = 32  # a K step of the kernel lies inside one tap
O_MULTIPLE = 64  # the smallest N tile
STRIDES = (1, 2)  # stride 2 reads four parity planes of the input
QUANT_DTYPES = (torch.bfloat16, torch.float32)  # the quantize kernel's


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def load_kernel() -> KernelLibrary:
    """Build (once per source) and load the library of both int8
    kernels."""
    global _library
    with _lock:
        if _library is None:
            out, seconds, log = nvcc_build(SOURCE, HOPPER_FLAGS, "int8_conv")
            lib = ctypes.CDLL(str(out))
            lib.int8_conv_launch.argtypes = [ctypes.c_void_p] * 6 + \
                [ctypes.c_int] * 20 + [ctypes.c_void_p]
            lib.int8_conv_launch.restype = ctypes.c_int
            lib.int8_quantize_launch.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.int8_quantize_launch.restype = ctypes.c_int
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


# -- the kernel's tile plan ---------------------------------------------------

NUM_SMS = 132       # an H100 SXM's; the wrapper asks the card
MAX_ROWS = 128      # an M tile: two consumer warpgroups of 64 rows
MAX_STAGES = 8
RING_BYTES = 200 * 1024  # the stages' budget (a block may take 227 KB)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel tiles one convolution. An M tile is a box of
    ``bw x bh x bb`` output pixels (W fastest), an N tile ``bn`` output
    channels, a K step ``bk`` bytes of channels inside one tap; the K
    steps of a tile are cut into ``splits`` ranges; ``grid`` persistent
    blocks walk the ``units`` (M tile, N tile, split) and each keeps
    ``stages`` K steps in flight."""

    b: int
    h: int
    w: int
    c: int
    o: int
    k: int
    stride: int
    padding: int
    dilation: int
    ho: int
    wo: int
    bk: int
    bn: int
    box: Tuple[int, int, int]  # (bw, bh, bb)
    splits: int
    grid: int
    stages: int

    @property
    def rows(self) -> int:
        bw, bh, bb = self.box
        return bw * bh * bb

    @property
    def tiles(self) -> Tuple[int, int, int]:
        """M tiles along W, H and the batch."""
        bw, bh, bb = self.box
        return (-(-self.wo // bw), -(-self.ho // bh), -(-self.b // bb))

    @property
    def n_tiles(self) -> int:
        return self.o // self.bn

    @property
    def ksteps(self) -> int:
        return self.k * self.k * self.c // self.bk

    @property
    def units(self) -> int:
        tw, th, tb = self.tiles
        return tw * th * tb * self.n_tiles * self.splits

    def unit(self, u):
        """The kernel's decode of unit ``u`` (an int or an integer numpy
        array): ``(b0, oh0, ow0, n0, k0, k1, split)``, the tile's first
        pixel and channel and its K steps ``[k0, k1)``. N tile fastest,
        then the split, then the M tile (W, H, batch)."""
        nt = u % self.n_tiles
        r = u // self.n_tiles
        split = r % self.splits
        mt = r // self.splits
        tw, th, _ = self.tiles
        bw, bh, bb = self.box
        ow0 = (mt % tw) * bw
        oh0 = (mt // tw % th) * bh
        b0 = (mt // tw // th) * bb
        k0 = split * self.ksteps // self.splits
        k1 = (split + 1) * self.ksteps // self.splits
        return b0, oh0, ow0, nt * self.bn, k0, k1, split

    def tap(self, ks: int) -> Tuple[int, int, int, int]:
        """K step ``ks`` -> ``(plane, c0, qh, qw)``: the input plane of the
        stride phase the tap falls on (``plane = ph * stride + pw``, the
        pixels ``(stride * i + ph, stride * j + pw)``), the first channel,
        and the shift of the box in that plane's coordinates."""
        cchunks = self.c // self.bk
        tap, chunk = divmod(ks, cchunks)
        r, s = divmod(tap, self.k)
        qh, ph = divmod(r * self.dilation - self.padding, self.stride)
        qw, pw = divmod(s * self.dilation - self.padding, self.stride)
        return ph * self.stride + pw, chunk * self.bk, qh, qw


def _check_kernel_shape(h, w, c, o, stride) -> None:
    """Raise for what the kernel does not take (the batch may be
    symbolic under ``torch.export``; these sizes are not)."""
    if c % C_MULTIPLE or o % O_MULTIPLE or c <= 0 or o <= 0:
        raise ValueError(f"the int8 conv kernel takes C a multiple of "
                         f"{C_MULTIPLE} and O a multiple of {O_MULTIPLE}, "
                         f"got C={c}, O={o}")
    if stride not in STRIDES or min(h, w) < stride:
        raise ValueError(f"the int8 conv kernel takes stride 1 or 2 on an "
                         f"input at least that large, got stride {stride} "
                         f"on {h}x{w}")


def _largest_divisor(n: int, options) -> int:
    return next(v for v in options if n % v == 0)


def _m_box(b: int, ho: int, wo: int) -> Tuple[int, int, int]:
    """The box of output pixels that needs the fewest M tiles; among
    those the widest, then the tallest."""
    best = None
    for bw in range(1, min(wo, MAX_ROWS) + 1):
        for bh in range(1, min(ho, MAX_ROWS // bw) + 1):
            bb = min(b, MAX_ROWS // (bw * bh))
            tiles = -(-wo // bw) * -(-ho // bh) * -(-b // bb)
            key = (tiles, -bw, -bh)
            if best is None or key < best[0]:
                best = (key, (bw, bh, bb))
    return best[1]


def _splits(tiles: int, ksteps: int, step: float, mo: int,
            num_sms: int) -> int:
    """Split K where the tiles alone leave SMs idle. The cost of a split
    count, in units of one K step of the largest tile (128 x 256 x 128,
    ~0.6 us at the card's peak rate): the waves of units times a unit's
    steps plus ~2 for its pipeline fill and epilogue, and for a split the
    reducing kernel (~4 for its launch, plus its int32 reads). A
    heuristic; PERF.md holds what each plan measured."""
    best = None
    for s in range(1, min(ksteps, 64) + 1):
        waves = -(-tiles * s // num_sms)
        cost = waves * (-(-ksteps // s) * step + 2.0)
        if s > 1:
            cost += 4.0 + s * mo / 2 ** 19
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


@functools.lru_cache(maxsize=1024)
def plan(b: int, h: int, w: int, c: int, o: int, k: int, stride: int,
         padding: int, dilation: int, num_sms: int = NUM_SMS) -> Plan:
    """The kernel's tiling of one convolution of ``[b, h, w, c]`` by
    ``[o, k, k, c]``; raises for a shape the kernel does not take."""
    _check_kernel_shape(h, w, c, o, stride)
    ho = out_size(h, k, stride, padding, dilation)
    wo = out_size(w, k, stride, padding, dilation)
    if min(b, ho, wo) < 1:
        raise ValueError(f"empty output for input {(b, h, w, c)}")
    bk = _largest_divisor(c, (128, 64, 32))
    bn = _largest_divisor(o, (256, 128, 64))
    box = _m_box(b, ho, wo)
    tw, th, tb = (-(-wo // box[0]), -(-ho // box[1]), -(-b // box[2]))
    tiles = tw * th * tb * (o // bn)
    ksteps = k * k * c // bk
    splits = _splits(tiles, ksteps, bn * bk / (256 * 128), b * ho * wo * o,
                     num_sms)
    stages = min(MAX_STAGES, RING_BYTES // ((MAX_ROWS + bn) * bk))
    return Plan(b, h, w, c, o, k, stride, padding, dilation, ho, wo, bk, bn,
                box, splits, min(tiles * splits, num_sms), stages)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if min(output_shape(xq, w, stride, padding, dilation)[1:3]) < 1:
        raise ValueError(f"empty output for input {tuple(xq.shape)}")
    if xq.device.type == "cuda":
        _check_kernel_shape(*xq.shape[1:3], c, o, stride)


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


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as one
    fused multiply-add (``fmaf``), computed in float64 on any device.

    The product is exact in float64 (24 + 24 significant bits). The sum
    ``s`` is rounded to 53 bits; TwoSum gives its exact error ``e``. Where
    ``e`` is not 0 and ``s``'s last significand bit is even, ``s`` steps
    one float64 ulp toward ``e``: that rounds the exact sum to odd. Rounding
    to odd at 53 bits, then to nearest at 24, is one rounding to nearest
    at 24 (Boldo and Melquiond, 2008). A bare float64 sum rounds twice and
    misses where it lands on a float32 halfway point."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def int8_conv_reference(xq: torch.Tensor, w: torch.Tensor,
                        w_scale: torch.Tensor, bias: torch.Tensor,
                        stride: int, padding: int, dilation: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: ``int8_conv_accumulate``, then
    ``fma_f32(acc.float(), w_scale, bias).to(out_dtype)``, one rounding as
    in the kernel's epilogue (``torch.int32``: the sums)."""
    acc = int8_conv_accumulate(xq, w, stride, padding, dilation)
    if out_dtype == torch.int32:
        return acc
    return fma_f32(acc.float(), w_scale, bias).to(out_dtype)


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
        raise ValueError("xq and w must be 16-byte aligned (TMA)")
    b, ho, wo, o = output_shape(xq, w, stride, padding, dilation)
    out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    kernel = load_kernel()
    _, h, wd, c = xq.shape
    k = w.shape[1]
    p = plan(b, h, wd, c, o, k, stride, padding, dilation,
             _sm_count(xq.device.index or 0))
    ws = torch.empty((p.splits, b, ho, wo, o), dtype=torch.int32,
                     device=xq.device) if p.splits > 1 else None
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel.lib.int8_conv_launch(
            xq.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, h, wd, c, o, k,
            stride, padding, dilation, ho, wo, OUT_KINDS[out_dtype], p.bk,
            p.bn, *p.box, p.splits, p.grid, p.stages, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err}"
                           + (" (tensor map)" if err >= 1000 else ""))
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


# -- the activation quantize --------------------------------------------------

def _check_quantize(x: torch.Tensor, in_scale: torch.Tensor) -> None:
    if x.dim() != 4 or in_scale.shape != (x.shape[-1],):
        raise ValueError(f"need x [B, H, W, C] and in_scale [C], got "
                         f"{tuple(x.shape)} and {tuple(in_scale.shape)}")
    if not x.is_floating_point() or in_scale.dtype != torch.float32:
        raise ValueError(f"need floating x and float32 in_scale, got "
                         f"{x.dtype} and {in_scale.dtype}")
    if x.device != in_scale.device:
        raise ValueError(f"x on {x.device}, in_scale on {in_scale.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 quantize for device {x.device}")
    if x.device.type == "cuda" and x.dtype not in QUANT_DTYPES:
        raise ValueError(f"the quantize kernel takes bfloat16 or float32, "
                         f"got {x.dtype}")


def int8_quantize_reference(x: torch.Tensor,
                            in_scale: torch.Tensor) -> torch.Tensor:
    """The plain version: ``1 / in_scale`` by IEEE division (a tensor
    divided by a tensor, which the card also divides; a tensor divided by
    a Python float it would turn into a reciprocal multiply), a float32
    multiply, round half to even, the clamp, int8."""
    inv = torch.div(torch.ones_like(in_scale), in_scale)
    xq = torch.round(x.float() * inv)
    return torch.clamp(xq, -127.0, 127.0).to(torch.int8)


@torch.library.custom_op("refinedet_tpu_torch::int8_quantize",
                         mutates_args=(), device_types="cpu")
def int8_quantize_op(x: torch.Tensor,
                     in_scale: torch.Tensor) -> torch.Tensor:
    """The op; on the CPU, the plain version."""
    return int8_quantize_reference(x, in_scale)


@int8_quantize_op.register_kernel("cuda")
def _launch_quantize(x: torch.Tensor,
                     in_scale: torch.Tensor) -> torch.Tensor:
    """The kernel on the tensors' card; raises on anything it cannot
    take. A strided ``x`` is copied first (counted in
    ``int8_quantize.copies``)."""
    _check_quantize(x, in_scale)
    if not x.is_contiguous():
        x = x.contiguous()
        int8_quantize.copies += 1
    in_scale = in_scale.contiguous()
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    kernel = load_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel.lib.int8_quantize_launch(
            x.data_ptr(), in_scale.data_ptr(), out.data_ptr(), x.numel(),
            x.shape[-1], int(x.dtype == torch.bfloat16), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err:
        raise RuntimeError(f"int8_quantize launch failed: CUDA error {err}")
    if capturing:
        int8_quantize.captured += 1
    else:
        int8_quantize.launches += 1
    return out


@int8_quantize_op.register_fake
def _(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    return x.new_empty(x.shape, dtype=torch.int8)


def int8_quantize(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """``clamp(round(x * (1 / in_scale)), -127, 127)`` as int8, ``x [B,
    H, W, C]`` (NHWC) bfloat16 or float32 (any float on the CPU),
    ``in_scale [C]`` float32, through the op (see the module docstring).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which adds one to ``int8_quantize.launches``."""
    _check_quantize(x, in_scale)
    return int8_quantize_op(x, in_scale)


int8_quantize.launches = 0
int8_quantize.captured = 0
int8_quantize.copies = 0
