"""ctypes bindings for the host NMS library (``csrc/nms_host.cpp``).

Port of ``refinedet_tpu/ops/nms_native.py``, the counterpart of the
reference's ``utils/nms_wrapper.py`` cpu path: greedy hard NMS and
soft-NMS over ``[N, 5]`` (x1, y1, x2, y2, score) numpy rows, on the host.
The card's NMS is kernel K1 (``ops/nms_cuda.py``); this library is for
host-side tooling.

The library is built by ``g++`` at first use, from the source in this
package only, into ``_build/`` beside it (never into ``native/``, whose
library belongs to the JAX package). Unlike the JAX package's loader, a
failed build raises: nothing falls back to numpy quietly.
``_numpy_nms`` is the plain version the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "nms_host.cpp"
BUILD_DIR = _PKG / "_build"
# native/build.sh's flags: with the same FMA contraction the two libraries
# round alike, so their keep lists and soft-NMS scores are equal.
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_INT_P = ctypes.POINTER(ctypes.c_int)


def _host_identity() -> bytes:
    """The CPU's model and flags: code built with -march=native runs only
    on CPUs like the one that built it, so they are part of the library's
    name."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
    except OSError:
        lines = []
    return (platform.machine() + "".join(lines[:2])).encode()


def build_library(source: Path = SOURCE) -> ctypes.CDLL:
    """Build (once per source text, flags and host CPU) and load the
    library."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + _host_identity()).hexdigest()[:16]
    out = BUILD_DIR / f"libnms_host_{tag}.so"
    if not out.exists():
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH; it is "
                               "needed to build the host NMS library")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"{cxx} failed with code {proc.returncode} building "
                f"{source}:\n{(proc.stdout + proc.stderr).strip()}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(out))
    lib.nms_hard.restype = ctypes.c_int
    lib.nms_hard.argtypes = [_FLOAT_P, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, _INT_P]
    lib.nms_soft.restype = ctypes.c_int
    lib.nms_soft.argtypes = [_FLOAT_P, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_float, ctypes.c_int,
                             _INT_P]
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the host NMS library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build_library(SOURCE)
        return _lib


def _rows(dets: np.ndarray) -> np.ndarray:
    dets = np.ascontiguousarray(dets, np.float32)
    if dets.ndim != 2 or dets.shape[1] != 5:
        raise ValueError(f"dets must be [N, 5], got {dets.shape}")
    return dets


def _numpy_nms(dets: np.ndarray, thresh: float, plus_one: bool):
    """Plain greedy NMS in numpy (py_cpu_nms.py semantics)."""
    off = 1.0 if plus_one else 0.0
    x1, y1, x2, y2, sc = (dets[:, i] for i in range(5))
    areas = (x2 - x1 + off) * (y2 - y1 + off)
    order = np.argsort(-sc, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        iw = np.maximum(
            0.0, np.minimum(x2[i], x2[rest]) -
            np.maximum(x1[i], x1[rest]) + off)
        ih = np.maximum(
            0.0, np.minimum(y2[i], y2[rest]) -
            np.maximum(y1[i], y1[rest]) + off)
        inter = iw * ih
        iou = inter / (areas[i] + areas[rest] - inter)
        order = rest[iou <= thresh]
    return keep


def nms(dets: np.ndarray, thresh: float, force_cpu: bool = True,
        plus_one: bool = True) -> list:
    """Greedy hard NMS over [N, 5] (x1, y1, x2, y2, score) rows.

    Signature mirrors the reference's ``nms_wrapper.nms``; ``force_cpu``
    is accepted for API parity (this path is always the host's). Returns
    kept indices, score-descending.
    """
    del force_cpu
    dets = _rows(dets)
    if dets.shape[0] == 0:
        return []
    lib = load_library()
    keep = np.empty(dets.shape[0], np.int32)
    count = lib.nms_hard(dets.ctypes.data_as(_FLOAT_P), dets.shape[0],
                         ctypes.c_float(thresh), int(plus_one),
                         keep.ctypes.data_as(_INT_P))
    return keep[:count].tolist()


def soft_nms(dets: np.ndarray, iou_thresh: float = 0.3, sigma: float = 0.5,
             score_thresh: float = 0.001, method: str = "linear") -> list:
    """Soft-NMS (cpu_nms.pyx:70-163 semantics, +1 areas). Rescores
    ``dets`` in place and returns surviving indices in processing
    order."""
    caller_dets = dets
    dets = _rows(dets)
    if dets.shape[0] == 0:
        return []
    methods = {"hard": 0, "linear": 1, "gaussian": 2}
    if method not in methods:
        raise ValueError(f"method must be one of {sorted(methods)}, got "
                         f"{method!r}")
    lib = load_library()
    keep = np.empty(dets.shape[0], np.int32)
    count = lib.nms_soft(dets.ctypes.data_as(_FLOAT_P), dets.shape[0],
                         ctypes.c_float(iou_thresh), ctypes.c_float(sigma),
                         ctypes.c_float(score_thresh), methods[method],
                         keep.ctypes.data_as(_INT_P))
    if caller_dets is not dets:
        # _rows copied (non-contiguous or non-f32 input): write the
        # rescored, reordered rows back so the in-place contract holds.
        caller_dets[...] = dets
    return keep[:count].tolist()
