"""The profiler scope and the program's spans.

Port of ``refinedet_tpu/utils/timer.py``'s profiler scope on
``torch.profiler`` in place of ``jax.profiler``. ``profile_trace``
writes a Chrome trace (``*.pt.trace.json``) that
``utils/trace_summary.py`` reads, and that TensorBoard's profiler plugin
or ``chrome://tracing`` show.

``span(name)`` marks a piece of the program's work: the train step and
its phases (``train/train_step.py``), the serving call and its copies
(``serve/export.py``). With no ``torch.profiler`` session active it is
one flag check and a shared null context. Under a profiler it opens a
``record_function`` range (a ``user_annotation`` event in the Chrome
trace, on the device trace's clock) and appends a ``SpanRecord`` to a
bounded ring in host memory: the name, the enclosing span, the
outermost one, the id of the step or call, the host start and end and,
with ``device=True``, a pair of CUDA timing events on the current
stream. ``span_records`` resolves the
events' elapsed times (one synchronize) and ``span_summary`` adds them
up per name.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from refinedet_tpu_torch.device import DeviceLike, resolve_device

# Records kept: a traced stretch of a few dozen steps (six spans each) or
# calls (four each) fits many times over.
SPAN_RING = 8192

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_ring: collections.deque = collections.deque(maxlen=SPAN_RING)
_lock = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans


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


@dataclasses.dataclass(eq=False)
class SpanRecord:
    """One span: ``root`` is the outermost span's name (with ``id``, the
    step or call it belongs to); host times from ``time.perf_counter_ns``;
    ``child_ns`` is the host time of its direct children; ``device_ms``
    the elapsed time of its event pair, once ``span_records`` has
    resolved it."""

    name: str
    parent: Optional[str]
    root: str
    id: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None
    child_ns: int = 0
    events: Optional[tuple] = None
    device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_host_ms(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6


def span(name: str, device: bool = False, id: Optional[int] = None):
    """A context manager around one piece of work, recorded only while a
    ``torch.profiler`` session is active (otherwise a shared null
    context). ``id`` names the step or call; a span without one takes
    its enclosing span's. ``device=True`` (for work on a CUDA stream)
    adds timing events on the current stream, except while it captures
    a graph. Adds no host sync."""
    if not _profiler_enabled():
        return _OFF
    return _span(name, device, id)


@contextlib.contextmanager
def _span(name: str, device: bool, id: Optional[int]):
    stack = _open.__dict__.setdefault("stack", [])
    parent = stack[-1] if stack else None
    if parent is not None:
        root = parent.root
        if id is None:
            id = parent.id
    else:
        root = name
    timed = device and not torch.cuda.is_current_stream_capturing()
    with record_function(name):
        rec = SpanRecord(name, parent and parent.name, root, id,
                         time.perf_counter_ns())
        if timed:  # the stream asked once: each ask costs ~10 µs
            stream = torch.cuda.current_stream()
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record(stream)
        with _lock:
            _ring.append(rec)
        stack.append(rec)
        try:
            yield rec
        finally:
            stack.pop()
            if timed:
                rec.events[1].record(stream)
            rec.end_ns = time.perf_counter_ns()
            if parent is not None:
                parent.child_ns += rec.end_ns - rec.start_ns


def span_records(last_ids: Optional[int] = None) -> List[SpanRecord]:
    """The ring's finished records, oldest first; with ``last_ids`` only
    those of the last ``last_ids`` steps or calls, each a (root, id)
    (the ring may hold fewer). Waits for the card once if any record's
    events are unresolved."""
    with _lock:
        recs = [r for r in _ring if r.end_ns is not None]
    if last_ids is not None:
        keys = [k for k in dict.fromkeys((r.root, r.id)
                                         for r in reversed(recs))
                if k[1] is not None][:last_ids]
        keep = set(keys)
        recs = [r for r in recs if (r.root, r.id) in keep]
    pending = [r for r in recs if r.events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return recs


def span_summary(records: List[SpanRecord]) -> Dict[str, dict]:
    """Per name: ``count``, ``host_ms``, ``self_host_ms`` (less the
    children's host time) and ``device_ms`` (None where no record of the
    name was timed on the card), summed over ``records``."""
    out: Dict[str, dict] = {}
    for r in records:
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "self_host_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += r.host_ms
        s["self_host_ms"] += r.self_host_ms
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
    return out
