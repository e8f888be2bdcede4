"""``nvcc`` builds of the port's CUDA kernels, at first use, on the card's
host: each source becomes a shared library with a plain C interface in
``_build/`` beside the package (git-ignored), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
reused. The wrappers load the library with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# Hopper's own target (``wgmma`` and ``setmaxnreg`` need the ``a``);
# -Xptxas -v reports registers and shared memory.
HOPPER_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin",
                                                      "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       f"{cuda_home}); it is needed to build the port's "
                       "CUDA kernels")


def nvcc_build(source: Path, flags: Sequence[str], stem: str
               ) -> Tuple[Path, float, str]:
    """Build ``source`` into ``_build/lib<stem>_<hash>.so`` unless that
    library exists; returns its path, the build's seconds (0.0 when it was
    reused) and nvcc's output ("" when reused)."""
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *flags, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed with code {proc.returncode} "
                           f"building {source}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out, seconds, log


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded library of kernels and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when this source's library was already built
    build_log: str        # nvcc's output, with ptxas -v ("" when reused)
