"""Reduction of a ``torch.profiler`` trace to the benchmark's device
numbers: busy and idle time, device time by launching op and by kernel
name, and the idle gaps by what the host was doing.

The arithmetic is a frozen copy of the port's ``utils/trace_summary.py``
as it stood when the benchmark was written: times are the trace's µs
floats taken as integer nanoseconds, so unions are exact and busy never
exceeds its span; a kernel is tied to its launch by correlation id and to
the aten ops whose host ranges hold the launch; the first op category
that matches, from the innermost op outwards, names it. A CUDA graph's
replay launches its kernels under one ``cudaGraphLaunch``: they are seen
by name, under "no launching op".
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = {"kernel": None, "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OP_CATEGORIES = [
    (re.compile(r"convolution_backward|cudnn_convolution_backward"),
     "convolution backward"),
    (re.compile(r"conv|cudnn_convolution"), "convolution"),
    (re.compile(r"max_pool2d.*backward|MaxPool2dSliceBackward"),
     "max_pool2d backward"),
    (re.compile(r"max_pool2d"), "max_pool2d"),
    (re.compile(r"softmax.*backward"), "softmax backward"),
    (re.compile(r"softmax"), "softmax"),
    (re.compile(r"^(sort|topk|argsort)$"), "sort/top-k"),
    (re.compile(r"^(sum|mean|amax|amin|max|min|argmax|argmin|norm|prod|any"
                r"|all|var|std|linalg_vector_norm|_foreach_norm|cumsum)$"),
     "reduction"),
    (re.compile(r"index|gather|scatter|masked|nonzero|take"),
     "index/gather"),
    (re.compile(r"^(mm|addmm|bmm|matmul|linear|_int_mm|einsum)$"),
     "matmul"),
]
HANDWRITTEN = {"refinedet_tpu_torch::nms_sweep": "nms_sweep (K1)",
               "refinedet_tpu_torch::int8_conv": "int8_conv",
               "refinedet_tpu_torch::int8_quantize": "int8_quantize"}


def ns(x: float) -> int:
    return int(round(x * 1000.0))


def union_ns(intervals: List[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _short(name: str) -> str:
    return name.split("::", 1)[1] if name.startswith("aten::") else name


def categorize(chain: List[str]) -> str:
    """Category of a kernel from the ops that launched it, outermost
    first (``[]``: no launching op)."""
    for name in chain:
        if name in HANDWRITTEN:
            return HANDWRITTEN[name]
    if not chain:
        return "no launching op"
    short = [_short(n) for n in chain]
    for i in range(len(short) - 1, -1, -1):
        op = short[i]
        if op in ("copy_", "_to_copy", "to", "contiguous", "clone"):
            up = short[:i + 1]
            if "_to_copy" in up:
                return "cast (_to_copy)"
            if "contiguous" in up or "clone" in up:
                return "layout copy"
            continue
        for pattern, cat in OP_CATEGORIES:
            if pattern.search(op):
                return cat
    return "copy_" if short[-1] == "copy_" else "elementwise"


def _op_chains(ops: List[dict], launches: List[dict]) -> Dict[int, List[str]]:
    """For each launch (by index), the names of the ops on its thread
    whose ranges hold it, outermost first."""
    by_tid = defaultdict(list)
    for op in ops:
        by_tid[(op["pid"], op["tid"])].append(
            (ns(op["ts"]), -ns(op["dur"]), op["name"]))
    pending = defaultdict(list)
    for i, ev in enumerate(launches):
        pending[(ev["pid"], ev["tid"])].append((ns(ev["ts"]), i))
    chains = {}
    for key, events in pending.items():
        seq = sorted(by_tid.get(key, []))
        stack: List[Tuple[int, str]] = []
        j = 0
        for ts, i in sorted(events):
            while j < len(seq) and seq[j][0] <= ts:
                start, neg_dur, name = seq[j]
                while stack and stack[-1][0] <= start:
                    stack.pop()
                stack.append((start - neg_dur, name))
                j += 1
            while stack and stack[-1][0] < ts:
                stack.pop()
            chains[i] = [name for _, name in stack]
    return chains


def _host_at(ops: List[dict], times: List[int]) -> List[str]:
    """For each of the sorted ``times``, the innermost host op (or
    annotation) whose range holds it: of those open, the latest started."""
    seq = sorted((ns(op["ts"]), ns(op["ts"]) + ns(op["dur"]), op["name"])
                 for op in ops)
    out, open_, j = [], [], 0
    for t in times:
        while j < len(seq) and seq[j][0] <= t:
            open_.append(seq[j])
            j += 1
        open_ = [o for o in open_ if o[1] > t]
        out.append(max(open_)[2] if open_ else "host outside any op")
    return out


def reduce(events: List[dict], window_ns: int) -> dict:
    """The device numbers of one trace whose stretch lasted ``window_ns``
    on the host clock: ``busy_ns``, ``categories`` (ns by launching op),
    ``kernels`` (ns and count by kernel name), ``kernel_ops`` (ns by
    "[category] kernel"), ``idle_gaps`` (ns by host op)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not any(e["cat"] == "kernel" for e in dev):
        raise RuntimeError("the trace holds no kernel events (no CUDA "
                           "activity was recorded)")
    ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    cpu_ops = [e for e in ops if e.get("cat") == "cpu_op"]
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})]
    chains = _op_chains(cpu_ops, launches)
    by_corr = {e["args"]["correlation"]: i for i, e in enumerate(launches)}
    cats, kernels, kernel_ops = defaultdict(int), {}, defaultdict(int)
    intervals = []
    for ev in dev:
        s, d = ns(ev["ts"]), ns(ev["dur"])
        intervals.append((s, s + d))
        li = by_corr.get(ev.get("args", {}).get("correlation"))
        cat = DEVICE_CATS[ev["cat"]] or categorize(
            chains.get(li, []) if li is not None else [])
        cats[cat] += d
        if ev["cat"] == "kernel":
            k = kernels.setdefault(ev["name"], [0, 0])
            k[0] += d
            k[1] += 1
            kernel_ops[f"[{cat}] {ev['name'][:100]}"] += d
    busy = merged(intervals)
    gaps = defaultdict(int)
    holes = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    names = _host_at(ops, [(e0 + s1) // 2 for e0, s1 in holes])
    for (e0, s1), name in zip(holes, names):
        gaps[name] += s1 - e0
    return {"busy_ns": union_ns(intervals),
            "window_ns": window_ns, "categories": dict(cats),
            "kernels": kernels, "kernel_ops": dict(kernel_ops),
            "idle_gaps": dict(gaps)}


def kernel_ns(stats: dict, *names: str) -> int:
    """Device ns of the kernels whose name holds any of ``names``."""
    return sum(v[0] for k, v in stats["kernels"].items()
               if any(n in k for n in names))


def top(items: Dict[str, int], n: int = 10) -> List[list]:
    """The ``n`` largest entries as [name, seconds]."""
    return [[k, v / 1e9] for k, v in sorted(items.items(),
                                            key=lambda kv: -kv[1])[:n]]


class Profiler:
    """The profiler over a stretch (host ops and the card): ``start()``,
    then ``stop(sync)`` ends the stretch with ``sync()`` and returns the
    reduced trace. The trace file is written under ``TMPDIR`` and
    deleted."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t0 = None

    def start(self) -> None:
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, sync: Callable[[], None]) -> dict:
        sync()
        window_ns = int((time.perf_counter() - self.t0) * 1e9)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return reduce(events, window_ns)


def capture(stretch: Callable[[], None], sync: Callable[[], None]) -> dict:
    """``stretch()`` under the ``Profiler``, ended by ``sync()``."""
    p = Profiler()
    p.start()
    stretch()
    return p.stop(sync)
