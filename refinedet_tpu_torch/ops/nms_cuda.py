"""K1 on Hopper: the batched greedy-NMS suppression sweep (CUDA C++).

Replaces ``refinedet_tpu/ops/nms_pallas.py:_nms_sweep_kernel``: from G
groups of K score-descending candidates (``boxes [G, K, 4]`` float32,
``valid [G, K]`` bool) it computes the greedy hard-NMS keep mask
``[G, K]``, bitwise equal to ``ops.nms.nms_sweep_reference``.

What bounds it on this card: neither bytes (18 per candidate: 16 in, one
valid flag in, one keep flag out) nor the serial chain of the greedy
sweep, but the pairwise IoU tests. The design (``csrc/nms_sweep.cu``)
runs one block per group. Seven producer warps build the upper-triangle
suppression bitmask in stripes of 64 rows, into a ring in shared memory,
and spare most pairs the IEEE division with an exact one-FMA prefilter;
one sweep warp consumes the stripes as they arrive, a 64-column word at a
time, settling the greedy inside each word as a fixed point with warp
OR-reductions, so no barrier of the block is taken per kept row and no
chain of dependent steps is as long as the number of kept rows. The hand-off
is one full and one empty ``mbarrier`` per stripe.

The library is compiled by ``nvcc`` for ``sm_90a`` at first use, from the
source in this package only, into ``_build/`` beside it, and loaded with
``ctypes``. For a CPU tensor the wrapper computes the plain version; for a
CUDA tensor it launches the kernel or raises, and never falls back.

The sweep is the PyTorch op ``refinedet_tpu_torch::nms_sweep``
(``torch.library.custom_op``), registered when this module is imported:
its CPU implementation is the plain version, its CUDA one the launch,
and a fake one gives ``torch.export`` the ``[G, K]`` bool result, so an
exported program keeps the sweep as one node. A loader of such a program
imports ``refinedet_tpu_torch.ops`` first. ``nms_sweep.launches`` counts
launches; a launch recorded into a CUDA graph is counted in
``nms_sweep.captured`` instead, and whoever replays the graph adds the
launches it holds (``serve/export.py:ServingModel``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path
from typing import Optional

import torch

from refinedet_tpu_torch.ops.cuda_build import BUILD_DIR, HOPPER_FLAGS, \
    nvcc_build
from refinedet_tpu_torch.ops.nms import as_f32, nms_sweep_reference

SOURCE = BUILD_DIR.parent / "csrc" / "nms_sweep.cu"
# --fmad=false and the default IEEE division keep the IoU op for op equal
# to the plain version's.
NVCC_FLAGS = HOPPER_FLAGS + ("--fmad=false",)


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded K1 library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when this source's library was already built
    build_log: str        # nvcc's output, with ptxas -v ("" when reused)
    max_k: int            # largest K the kernel takes


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def build_library(source: Path = SOURCE) -> KernelLibrary:
    """Build (once per source text and flags) and load a K1 library from
    ``source``. The main path takes ``SOURCE``; a measurement may build a
    variant of it."""
    out, seconds, log = nvcc_build(source, NVCC_FLAGS, "nms_sweep")
    lib = ctypes.CDLL(str(out))
    lib.nms_sweep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.nms_sweep_launch.restype = ctypes.c_int
    lib.nms_sweep_max_k.argtypes = []
    lib.nms_sweep_max_k.restype = ctypes.c_int
    return KernelLibrary(lib, out, seconds, log, lib.nms_sweep_max_k())


def load_kernel() -> KernelLibrary:
    """Build (once per source) and load the K1 library."""
    global _library
    with _lock:
        if _library is None:
            _library = build_library()
        return _library


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [G, K, 4], got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2]:
        raise ValueError(f"valid must be {tuple(boxes.shape[:2])}, got "
                         f"{tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"need float32 boxes and bool valid, got "
                         f"{boxes.dtype} and {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS sweep for device {boxes.device}")
    if boxes.device.type == "cuda" and not (boxes.is_contiguous()
                                            and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")


@torch.library.custom_op("refinedet_tpu_torch::nms_sweep", mutates_args=(),
                         device_types="cpu")
def nms_sweep_op(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thresh: float, plus_one: bool) -> torch.Tensor:
    """The op; on the CPU, the plain version."""
    return nms_sweep_reference(boxes, valid, iou_thresh, plus_one)


@nms_sweep_op.register_kernel("cuda")
def _launch(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
            plus_one: bool) -> torch.Tensor:
    """K1 on the tensors' card; raises on anything it cannot take."""
    # ``nms_sweep`` refuses strided inputs, but an exported program calls
    # the op directly, with the strides the card's kernels produce; its
    # trace saw other (fake) strides and dropped ``.contiguous()`` as a
    # no-op. A copy here costs 17 bytes a candidate.
    boxes, valid = boxes.contiguous(), valid.contiguous()
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    g, k = valid.shape
    kernel = load_kernel()
    if k > kernel.max_k:
        raise ValueError(f"K={k} exceeds the kernel's limit {kernel.max_k}")
    keep = torch.empty((g, k), dtype=torch.bool, device=boxes.device)
    if g == 0 or k == 0:
        return keep
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel.lib.nms_sweep_launch(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), g, k,
            as_f32(iou_thresh), int(bool(plus_one)), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err:
        raise RuntimeError(f"nms_sweep launch failed: CUDA error {err}")
    if capturing:
        nms_sweep.captured += 1
    else:
        nms_sweep.launches += 1
    return keep


@nms_sweep_op.register_fake
def _(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
      plus_one: bool) -> torch.Tensor:
    return torch.empty_like(valid)


def nms_sweep(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
              plus_one: bool = False) -> torch.Tensor:
    """Keep mask ``[G, K]`` bool of the greedy sweep over score-descending
    candidates ``boxes [G, K, 4]`` float32 and ``valid [G, K]`` bool,
    through the op.

    CPU tensors take the plain version; CUDA tensors launch K1, which
    adds one to ``nms_sweep.launches``.
    """
    _check(boxes, valid)
    return nms_sweep_op(boxes, valid, as_f32(iou_thresh), bool(plus_one))


nms_sweep.launches = 0
nms_sweep.captured = 0
