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
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from refinedet_tpu_torch.ops.nms import as_f32, nms_sweep_reference

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "nms_sweep.cu"
BUILD_DIR = _PKG / "_build"
# --fmad=false and the default IEEE division keep the IoU op for op equal
# to the plain version's; -Xptxas -v reports registers and shared memory.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


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


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin",
                                                      "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       f"{cuda_home}); it is needed to build the NMS kernel")


def build_library(source: Path = SOURCE) -> KernelLibrary:
    """Build (once per source text and flags) and load a K1 library from
    ``source``. The main path takes ``SOURCE``; a measurement may build a
    variant of it."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libnms_sweep_{tag}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed with code {proc.returncode} "
                               f"building {source}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
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


def nms_sweep(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
              plus_one: bool = False) -> torch.Tensor:
    """Keep mask ``[G, K]`` bool of the greedy sweep over score-descending
    candidates ``boxes [G, K, 4]`` float32 and ``valid [G, K]`` bool.

    CPU tensors take the plain version; CUDA tensors launch K1, which
    adds one to ``nms_sweep.launches``.
    """
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
    if boxes.device.type == "cpu":
        return nms_sweep_reference(boxes, valid, iou_thresh, plus_one)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS sweep for device {boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
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
    if err:
        raise RuntimeError(f"nms_sweep launch failed: CUDA error {err}")
    nms_sweep.launches += 1
    return keep


nms_sweep.launches = 0
