"""Summary of a ``torch.profiler`` Chrome trace, for the trace tools.

The port's counterpart of the JAX repo's ``tools/xplane_summary.py``: it
reads the ``*.pt.trace.json`` that ``utils/timer.profile_trace`` writes
(the newest one under a directory) and reports, on the card:

  * per annotated execution (each top-level ``utils/timer.span`` range
    on the host) the card's kernels, copies and fills it launched, tied
    to it through the correlation id of the launch (the runtime call
    inside the range), their union as the execution's device-busy ms,
    and the gap from its last device event to the next execution's
    first;
  * device busy over the traced span (the first execution's first device
    event to the last one's last) as the idle %, and with the batch the
    images/s the device time implies;
  * a split of kernel time by the aten op that launched each kernel (the
    counterpart of XLA's HLO opcode): convolution and its backward, the
    dtype casts and layout copies (``copy_`` under ``_to_copy``, and under
    ``contiguous``/``clone``), pooling, softmax, reductions, sorts,
    indexing, elementwise, memcpy/memset, and the three hand-written ops
    under their own names; a kernel with no launching op (a CUDA graph's
    replay: its kernels sit under one ``cudaGraphLaunch``) is counted as
    such;
  * the hand-written ops' calls that launched device work, and their
    kernels counted by name;
  * the top 15 kernels by time, each with its launching op's category,
    and the top 10 layout copies (NCHW<->NHWC
    transposes and the kernels of layout ``copy_`` calls), in place of
    XLA's copy signatures.

Times are the trace's µs floats taken as integer nanoseconds, so unions
and sums are exact and busy never exceeds its span. On the card a trace
without kernel events (CUDA activity missing) raises: it is never
summarized as CPU work. ``device="cpu"`` summarizes a CPU trace instead:
per execution its host ms, and the ops' self time by the same
categories.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Tuple

from refinedet_tpu_torch.device import DeviceLike

HANDWRITTEN = {"refinedet_tpu_torch::nms_sweep": "nms_sweep (K1)",
               "refinedet_tpu_torch::int8_conv": "int8_conv",
               "refinedet_tpu_torch::int8_quantize": "int8_quantize"}
# Each hand-written op launches one of these per call (the int8 conv's
# split-K reduction besides).
HANDWRITTEN_KERNELS = {"nms_sweep (K1)": "nms_sweep_kernel",
                       "int8_conv": "int8_conv_kernel",
                       "int8_quantize": "int8_quantize_kernel"}
DEVICE_CATS = {"kernel": None, "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TRANSPOSE = re.compile(r"nchwToNhwc|nhwcToNchw|transpose", re.I)
# Op name (without its "aten::" namespace) -> category, checked from the
# innermost op that launched a kernel outwards; the first match wins.
OP_CATEGORIES = [
    (re.compile(r"convolution_backward|cudnn_convolution_backward"),
     "convolution backward"),
    (re.compile(r"conv|cudnn_convolution"), "convolution"),
    # ``models/layers.py:MaxPool2dSlice``'s backward, under
    # POOL_BACKWARD="slice", is the autograd node of that name
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
    (re.compile(r"^(mm|addmm|bmm|matmul|linear|_int_mm)$"), "matmul"),
]


def _ns(x: float) -> int:
    return int(round(x * 1000.0))


def trace_path(logdir: str) -> str:
    """The newest ``*.pt.trace.json`` under ``logdir``."""
    paths = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    return max(paths, key=os.path.getmtime)


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
    if short[-1] == "copy_":
        return "copy_"
    return "elementwise"


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _op_chains(ops: List[dict], launches: List[dict]) -> Dict[int, List]:
    """For each launch event (by index), the (name, start ns) of the ops
    on its thread whose range holds it, outermost first."""
    by_tid = defaultdict(list)
    for op in ops:
        by_tid[(op["pid"], op["tid"])].append(
            (_ns(op["ts"]), -_ns(op["dur"]), op["name"]))
    pending = defaultdict(list)
    for i, ev in enumerate(launches):
        pending[(ev["pid"], ev["tid"])].append((_ns(ev["ts"]), i))
    chains = {}
    for key, events in pending.items():
        seq = sorted(by_tid.get(key, []))
        stack: List[Tuple[int, str, int]] = []  # (end, name, start)
        j = 0
        for ts, i in sorted(events):
            while j < len(seq) and seq[j][0] <= ts:
                start, neg_dur, name = seq[j]
                while stack and stack[-1][0] <= start:
                    stack.pop()
                stack.append((start - neg_dur, name, start))
                j += 1
            while stack and stack[-1][0] < ts:
                stack.pop()
            chains[i] = [(name, start) for _, name, start in stack]
    return chains


def _executions(events: List[dict]) -> List[dict]:
    """Top-level ``user_annotation`` ranges on the host, in time order."""
    ann = sorted((e for e in events if e.get("cat") == "user_annotation"
                  and e.get("ph") == "X"), key=lambda e: e["ts"])
    out, end = [], None
    for e in ann:
        s = _ns(e["ts"])
        if end is not None and s < end:
            continue  # nested inside the previous one
        end = s + _ns(e["dur"])
        out.append({"name": e["name"], "start": s, "end": end})
    return out


def trace_stats(logdir: str, device: DeviceLike = "cuda") -> dict:
    """The numbers ``summarize`` prints, as a dict (times in ms)."""
    path = trace_path(logdir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    execs = _executions(events)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    if str(device).startswith("cpu"):
        return _cpu_stats(path, execs, ops)
    dev_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not any(e["cat"] == "kernel" for e in dev_events):
        raise RuntimeError(
            f"{path}: no kernel events; the trace holds no CUDA activity "
            "(is CUPTI tracing available?). Not summarizing host ops as "
            "the card's.")
    launches = [e for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})]
    chains = _op_chains(ops, launches)
    by_corr = {e["args"]["correlation"]: i for i, e in enumerate(launches)}
    starts = [x["start"] for x in execs]

    per_exec = [[] for _ in execs]
    cats, kernels, layout = (defaultdict(int), defaultdict(lambda: [0, 0]),
                             defaultdict(int))
    by_kernel_op = defaultdict(int)
    ops_called = defaultdict(set)
    total = 0
    for ev in dev_events:
        s, d = _ns(ev["ts"]), _ns(ev["dur"])
        li = by_corr.get(ev.get("args", {}).get("correlation"))
        calls = chains.get(li, []) if li is not None else []
        chain = [name for name, _ in calls]
        cat = DEVICE_CATS[ev["cat"]] or categorize(chain)
        cats[cat] += d
        total += d
        if ev["cat"] == "kernel":
            kernels[ev["name"]][0] += d
            kernels[ev["name"]][1] += 1
            by_kernel_op[f"[{cat}] {ev['name']}"] += d
            if cat == "layout copy" or TRANSPOSE.search(ev["name"]):
                via = " > ".join(map(_short, chain[-2:])) or "-"
                layout[f"{ev['name'][:60]} <- {via}"] += d
        if li is None:
            continue
        for name, start in calls:
            if name in HANDWRITTEN:  # one call may launch several kernels
                ops_called[HANDWRITTEN[name]].add(
                    (launches[li]["pid"], launches[li]["tid"], start))
        t = _ns(launches[li]["ts"])
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= execs[k]["end"]:
            per_exec[k].append((s, s + d))

    rows = []
    for x, iv in zip(execs, per_exec):
        if not iv:
            continue
        rows.append({"name": x["name"], "first": min(s for s, _ in iv),
                     "last": max(e for _, e in iv),
                     "busy_ns": _union_ns(iv), "events": len(iv)})
    if not rows:
        raise RuntimeError(f"{path}: no device event falls inside a "
                           "top-level span")
    gaps = [(b["first"] - a["last"]) / 1e6 for a, b in zip(rows, rows[1:])]
    span = rows[-1]["last"] - rows[0]["first"]
    busy = _union_ns([iv for ivs in per_exec for iv in ivs])
    return {
        "trace": path, "device": "cuda",
        "executions": [{"name": r["name"], "events": r["events"],
                        "busy_ms": r["busy_ns"] / 1e6,
                        "span_ms": (r["last"] - r["first"]) / 1e6}
                       for r in rows],
        "gaps_ms": gaps, "busy_ms": busy / 1e6, "span_ms": span / 1e6,
        "idle_pct": 100.0 * (span - busy) / span if span else 0.0,
        "categories_ms": {c: v / 1e6 for c, v in cats.items()},
        "device_total_ms": total / 1e6,
        "kernel_counts": {n: v[1] for n, v in kernels.items()},
        "kernel_ops_ms": {n: v / 1e6 for n, v in by_kernel_op.items()},
        "layout_copies_ms": {n: v / 1e6 for n, v in layout.items()},
        "handwritten_calls": {n: len(v) for n, v in ops_called.items()},
        "handwritten_kernels": {
            n: sum(c for name, (_, c) in kernels.items() if k in name)
            for n, k in HANDWRITTEN_KERNELS.items()},
    }


def _cpu_stats(path: str, execs: List[dict], ops: List[dict]) -> dict:
    """Host-side numbers of a CPU trace: per execution its ms, and each
    op's self time (its range less its children's) by category."""
    if not execs:
        raise RuntimeError(f"{path}: no top-level span")
    by_tid = defaultdict(list)
    for op in ops:
        by_tid[(op["pid"], op["tid"])].append(
            (_ns(op["ts"]), -_ns(op["dur"]), op["name"]))
    cats, by_op = defaultdict(int), defaultdict(int)
    for seq in by_tid.values():
        stack: List[list] = []  # [end, name, self, chain]

        def close(item):
            cats[categorize(item[3])] += item[2]
            by_op[item[1]] += item[2]

        for start, neg_dur, name in sorted(seq):
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            dur = -neg_dur
            if stack:
                stack[-1][2] -= dur
            chain = (stack[-1][3] if stack else []) + [name]
            stack.append([start + dur, name, dur, chain])
        while stack:
            close(stack.pop())
    gaps = [(b["start"] - a["end"]) / 1e6 for a, b in zip(execs, execs[1:])]
    return {
        "trace": path, "device": "cpu",
        "executions": [{"name": x["name"],
                        "host_ms": (x["end"] - x["start"]) / 1e6}
                       for x in execs],
        "gaps_ms": gaps,
        "categories_ms": {c: v / 1e6 for c, v in cats.items()},
        "ops_ms": {n: v / 1e6 for n, v in by_op.items()},
    }


def _split(out: List[str], title: str, items: Dict[str, float],
           top: int = 0) -> None:
    tot = sum(items.values())
    out.append(f"\n{title} ({tot:.3f} ms):")
    rows = sorted(items.items(), key=lambda kv: -kv[1])
    for name, ms in rows[:top] if top else rows:
        share = 100.0 * ms / tot if tot else 0.0
        out.append(f"  {ms:9.3f} ms  ({share:5.1f}%)  {name[:120]}")


def format_summary(stats: dict, batch: int) -> str:
    """``trace_stats``'s numbers as the text the tools print."""
    ex = stats["executions"]
    out = [f"trace: {stats['trace']}", f"executions: {len(ex)}"]
    gaps = ", ".join(f"{g:.3f}" for g in stats["gaps_ms"]) or "n/a"
    if stats["device"] == "cpu":
        out.append("per-execution host time (ms): "
                   + ", ".join(f"{x['host_ms']:.2f}" for x in ex))
        out.append(f"host gaps between executions (ms): {gaps}")
        _split(out, "CPU op self time by category", stats["categories_ms"])
        _split(out, "top 15 ops by self time", stats["ops_ms"], 15)
        return "\n".join(out)
    out.append("per-execution device busy (ms): "
               + ", ".join(f"{x['busy_ms']:.3f}" for x in ex))
    out.append("per-execution device span (ms): "
               + ", ".join(f"{x['span_ms']:.3f}" for x in ex))
    out.append(f"device gaps between executions (ms): {gaps}")
    out.append(f"device busy {stats['busy_ms']:.3f} ms / span "
               f"{stats['span_ms']:.3f} ms -> idle {stats['idle_pct']:.2f}% "
               "of the traced window")
    per = stats["busy_ms"] / len(ex)
    out.append(f"throughput implied by device time: "
               f"{batch / per * 1000:.1f} img/s (batch {batch})")
    if stats["handwritten_calls"]:
        out.append("hand-written op calls with device work: " + ", ".join(
            f"{n} {c}" for n, c in sorted(stats["handwritten_calls"].items())))
    if any(stats["handwritten_kernels"].values()):
        out.append("hand-written kernels by name: " + ", ".join(
            f"{n} {c}" for n, c in sorted(
                stats["handwritten_kernels"].items())))
    _split(out, "device time by launching op", stats["categories_ms"])
    _split(out, "top 15 kernels by accumulated device time, [launching "
           "op's category]", stats["kernel_ops_ms"], 15)
    _split(out, "top 10 layout copies (kernel <- launching ops)",
           stats["layout_copies_ms"], 10)
    return "\n".join(out)


def summarize(logdir: str, batch: int, device: DeviceLike = "cuda") -> str:
    """The summary of the newest trace under ``logdir`` (see the module
    docstring); ``batch`` images per execution."""
    return format_summary(trace_stats(logdir, device), batch)
