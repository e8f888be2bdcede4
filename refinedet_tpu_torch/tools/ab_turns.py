"""Two variants timed in turns on one card: the shared core of
``bench_stem_s2d`` and ``bench_pool_backward``.

``card(device)`` checks that ``device`` is a CUDA device that exists (the
benches time the card and nothing else) and reads its name and power
limit from ``nvidia-smi``; ``in_turns`` times two variants A, B, B, A and
records each turn's peak memory.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict, Tuple

import torch

from refinedet_tpu_torch.device import DeviceLike, resolve_device


def nvidia_smi() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def card(device: DeviceLike, tool: str) -> Tuple[torch.device, str]:
    """(the CUDA device, ``nvidia_smi()``); raises for any other device
    or without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit(f"{tool} times the card: --device must be a CUDA "
                         f"device, got {device!r}")
    return dev, nvidia_smi()


def cuda_ms(fn: Callable[[], object], iters: int,
            dev: torch.device) -> float:
    """Device ms per call over ``iters`` back-to-back calls of ``fn``,
    between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def in_turns(variants: Dict[str, Callable[[], object]], iters: int,
             dev: torch.device) -> Dict[str, dict]:
    """Each of the two ``variants`` warmed up once, then timed in turns
    A, B, B, A (``cuda_ms`` over ``iters`` calls). Per variant: each
    turn's ms, the bytes allocated before it and its peak
    (``max_memory_allocated`` after ``reset_peak_memory_stats``)."""
    if len(variants) != 2:
        raise ValueError("in_turns times two variants")
    a, b = variants
    for fn in variants.values():
        fn()
    out = {name: {"ms": [], "base_bytes": [], "peak_bytes": []}
           for name in variants}
    for name in (a, b, b, a):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out[name]["base_bytes"].append(torch.cuda.memory_allocated(dev))
        out[name]["ms"].append(cuda_ms(variants[name], iters, dev))
        out[name]["peak_bytes"].append(torch.cuda.max_memory_allocated(dev))
    return out


def report(results: Dict[str, dict], batch: int, what: str) -> None:
    """Prints each turn and each variant's mean: ms, images/s, peak
    memory."""
    gib = 2.0 ** 30
    for name, r in results.items():
        mean = sum(r["ms"]) / len(r["ms"])
        turns = ", ".join(f"{ms:.3f}" for ms in r["ms"])
        print(f"{name:>15s}: {mean:8.3f} ms/{what} ({batch / mean * 1e3:8.1f} "
              f"img/s; turns {turns} ms), peak "
              f"{max(r['peak_bytes']) / gib:.3f} GiB (allocated before: "
              f"{max(r['base_bytes']) / gib:.3f} GiB)", flush=True)
