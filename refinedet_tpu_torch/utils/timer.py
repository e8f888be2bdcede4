"""Wall-clock timers and profiler hooks.

Port of ``refinedet_tpu/utils/timer.py``: the reference's ``Timer``
(``eval_refinedet_voc.py:81-103``) as it is, and the profiler scope on
``torch.profiler`` in place of ``jax.profiler``. ``profile_trace``
writes a Chrome trace (``*.pt.trace.json``) that
``utils/trace_summary.py`` reads, and that TensorBoard's profiler plugin
or ``chrome://tracing`` show.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from refinedet_tpu_torch.device import DeviceLike, resolve_device


class Timer:
    """tic/toc accumulator (average_time, total_time, calls)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average: bool = True) -> float:
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device: DeviceLike = "cuda"
                  ) -> Iterator[Optional[profile]]:
    """``torch.profiler`` scope writing a Chrome trace into ``log_dir``;
    a no-op (yielding None) when ``log_dir`` is None.

    On the card it records CPU and CUDA activity (the card's kernels,
    copies and fills, each tied to the host call that launched it) and
    waits for the card before it stops, so the trace holds every kernel
    issued inside the scope. ``device="cpu"`` records CPU activity only.
    There is no card-less fallback: ``cuda`` without a card raises.

    View with TensorBoard's profiler plugin or ``chrome://tracing``;
    ``utils/trace_summary.summarize(log_dir, batch)`` condenses it.
    """
    if not log_dir:
        yield None
        return
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


@contextlib.contextmanager
def step_annotation(name: str) -> Iterator[None]:
    """A named range around one step or execution in the profiler's
    timeline (``record_function``); ``trace_summary`` splits the trace at
    these ranges."""
    with record_function(name):
        yield
