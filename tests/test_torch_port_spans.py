"""The port's spans (``utils/timer.span``) on the CPU.

With no profiler a span is one flag check and records nothing. Under a
CPU ``torch.profiler`` one train step gives ``train.step`` and its five
phases in order, all with the step's id, self time its duration less its
children's, every name a ``user_annotation`` range of the Chrome trace;
a call into a serving artifact on the CPU gives ``serve.call`` with
``serve.eager`` and ``serve.d2h``; a step and a call of one id stay
apart. No span name of the program falls under an op category of the
trace readers (``utils/trace_summary.py``, ``portbench/trace.py``), the
ring stays bounded, and threads that share it keep their own nesting.
"""

import ast
import collections
import dataclasses
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import trace as bench_trace
from refinedet_tpu_torch.boxes.priors import generate_priors
from refinedet_tpu_torch.config import TrainConfig
from refinedet_tpu_torch.models import build_refinedet
from refinedet_tpu_torch.serve.export import ServingModel
from refinedet_tpu_torch.tools.profile_train_step import MAX_BOXES, \
    train_batch
from refinedet_tpu_torch.train.train_step import (create_train_state,
                                                  make_optimizer,
                                                  make_train_step)
from refinedet_tpu_torch.utils import timer, trace_summary

REPO = Path(__file__).resolve().parent.parent
SMALL = 128
PHASES = ["train.augment", "train.forward", "train.loss", "train.backward",
          "train.optimizer"]
PROGRAM_SPANS = {"train.step", *PHASES, "serve.call", "serve.h2d",
                 "serve.replay", "serve.d2h", "serve.eager"}


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring of the module's size, so that records of other tests
    do not show."""
    fresh = collections.deque(maxlen=timer.SPAN_RING)
    monkeypatch.setattr(timer, "_ring", fresh)
    return fresh


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _step(seed=0):
    """``make_train_step``'s step on RefineDet320 (2 classes, f32) with
    the anchors of a 128-px input, one image, and its state."""
    model = build_refinedet("train", 320, 2, device="cpu", seed=seed)
    model.priors = torch.from_numpy(generate_priors(dataclasses.replace(
        model.cfg, min_dim=SMALL, feature_maps=(16, 8, 4, 2))))
    opt = make_optimizer(model.net.parameters(), lambda s: 1e-3)
    step = make_train_step(model, opt, TrainConfig(batch_size=1,
                                                   max_boxes=MAX_BOXES))
    return step, create_train_state(model, opt)


class _Sum(torch.nn.Module):
    def forward(self, x):
        return x.float().sum((1, 2, 3))


def _cpu_serving():
    """A ``ServingModel`` over a tiny exported program on the CPU: the
    spans are the call's, whatever the program computes."""
    x = torch.zeros((2, 4, 4, 3), dtype=torch.uint8)
    program = torch.export.export(_Sum(), (x,))
    return ServingModel({"device": "cpu", "input_dtype": "uint8",
                         "input_size": 4, "batch_size": None}, program)


def test_off_is_one_flag_check(ring, monkeypatch):
    """No profiler: ``span`` asks the flag once and hands back the shared
    null context; no ``record_function`` opens, nothing is recorded."""
    asked = []

    def flag():
        asked.append(1)
        return False

    def refuse(*a, **k):
        raise AssertionError("span did more than a flag check")

    monkeypatch.setattr(timer, "_profiler_enabled", flag)
    monkeypatch.setattr(timer, "_span", refuse)
    monkeypatch.setattr(timer, "record_function", refuse)
    a = timer.span("train.step", id=3)
    b = timer.span("serve.h2d", device=True)
    assert a is b is timer._OFF and len(asked) == 2
    with a:
        with b:
            torch.ones(2).sum()
    assert not ring and timer.span_records() == []


def test_off_through_a_train_step_records_nothing(ring, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record_function opened with no profiler")

    monkeypatch.setattr(timer, "record_function", refuse)
    step, state = _step()
    images, boxes, labels, valid = train_batch(1, SMALL, "cpu")
    state, metrics = step(state, images, boxes, labels, valid)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert not ring


def test_train_step_spans(ring, tmp_path):
    """Two steps under a CPU profiler: per step ``train.step`` (its id the
    step count) and the five phases in order inside it, contiguous on the
    host; self time is duration less children; no device time on the
    CPU; the names are ``user_annotation`` ranges of the Chrome trace;
    ``last_ids`` keeps the last step's records."""
    step, state = _step()
    batch = train_batch(1, SMALL, "cpu")
    with _cpu_profile() as prof:
        for _ in range(2):
            state, _ = step(state, *batch)
    recs = timer.span_records()
    assert [r.name for r in recs] == ["train.step", *PHASES] * 2
    assert [r.id for r in recs] == [0] * 6 + [1] * 6
    for k in (0, 6):
        top, phases = recs[k], recs[k + 1:k + 6]
        assert top.parent is None
        assert all(r.parent == "train.step" for r in phases)
        assert all(r.device_ms is None for r in recs[k:k + 6])
        assert top.start_ns <= phases[0].start_ns
        assert phases[-1].end_ns <= top.end_ns
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns <= b.start_ns
        assert top.child_ns == sum(r.end_ns - r.start_ns for r in phases)
        assert top.self_host_ms == pytest.approx(
            top.host_ms - sum(r.host_ms for r in phases), abs=1e-9)
        assert all(r.self_host_ms == r.host_ms for r in phases)
    summary = timer.span_summary(recs)
    assert set(summary) == {"train.step", *PHASES}
    assert all(s["count"] == 2 and s["device_ms"] is None
               for s in summary.values())
    top = summary["train.step"]
    assert top["self_host_ms"] == pytest.approx(
        top["host_ms"] - sum(summary[p]["host_ms"] for p in PHASES))
    last = timer.span_records(last_ids=1)
    assert [r.name for r in last] == ["train.step", *PHASES]
    assert {r.id for r in last} == {1}

    path = tmp_path / "step.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = collections.Counter(e["name"] for e in events
                                 if e.get("cat") == "user_annotation")
    assert all(ranges[n] == 2 for n in ["train.step", *PHASES]), ranges


def test_trace_summary_splits_at_the_step_span(ring, tmp_path):
    """``trace_summary`` takes the top-level ``train.step`` ranges as the
    trace's executions and leaves the phases nested in them."""
    step, state = _step()
    batch = train_batch(1, SMALL, "cpu")
    logdir = str(tmp_path / "cpu")
    with timer.profile_trace(logdir, "cpu"):
        for _ in range(2):
            state, _ = step(state, *batch)
    stats = trace_summary.trace_stats(logdir, "cpu")
    assert [x["name"] for x in stats["executions"]] == ["train.step"] * 2


def test_serving_call_spans_on_the_cpu(ring):
    """The eager path: ``serve.call`` (its id the model's call count)
    around ``serve.eager`` and ``serve.d2h``; nothing with the profiler
    off, though the count goes on."""
    serving = _cpu_serving()
    images = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    want = images.reshape(2, -1).sum(1).astype(np.float32)
    np.testing.assert_array_equal(serving(images), want)
    assert not ring and serving.calls == 1
    with _cpu_profile():
        for _ in range(2):
            np.testing.assert_array_equal(serving(images), want)
    recs = timer.span_records()
    assert [(r.name, r.parent, r.id) for r in recs] == [
        ("serve.call", None, 2), ("serve.eager", "serve.call", 2),
        ("serve.d2h", "serve.call", 2),
        ("serve.call", None, 3), ("serve.eager", "serve.call", 3),
        ("serve.d2h", "serve.call", 3)]
    assert all(r.device_ms is None for r in recs)
    assert [r.id for r in timer.span_records(last_ids=1)] == [3] * 3
    assert timer.span_summary(recs)["serve.call"]["count"] == 2


def test_a_step_and_a_call_of_one_id_stay_apart(ring):
    """Train steps 0 and 1, then a serving call whose count is 1: the
    last step or call is the call alone, the last two take step 1 too."""
    step, state = _step()
    batch = train_batch(1, SMALL, "cpu")
    serving = _cpu_serving()
    images = np.zeros((2, 4, 4, 3), np.uint8)
    with _cpu_profile():
        for _ in range(2):
            state, _ = step(state, *batch)
        serving(images)
    last = timer.span_records(last_ids=1)
    assert [(r.root, r.id) for r in last] == [("serve.call", 1)] * 3
    two = timer.span_records(last_ids=2)
    assert [(r.root, r.id) for r in two] == [("train.step", 1)] * 6 + \
        [("serve.call", 1)] * 3


def _span_names(root: Path):
    """Every constant name passed to ``span`` in the package's source."""
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    getattr(node.func, "id", getattr(node.func, "attr",
                                                     None)) == "span":
                names.add(node.args[0].value)
    return names


def test_span_names_fall_under_no_op_category():
    """An op category matched by a span name would take its kernels, or
    its idle gaps, from the op that launched them."""
    names = _span_names(REPO / "refinedet_tpu_torch")
    assert PROGRAM_SPANS <= names
    for name in names:
        for pattern, cat in (trace_summary.OP_CATEGORIES
                             + bench_trace.OP_CATEGORIES):
            assert not pattern.search(name), (name, cat)


def test_the_ring_stays_bounded(ring):
    """Past ``SPAN_RING`` records the oldest go."""
    n = timer.SPAN_RING + 10
    with _cpu_profile():
        for i in range(n):
            with timer.span("serve.call", id=i):
                pass
    recs = timer.span_records()
    assert len(ring) == len(recs) == timer.SPAN_RING
    assert recs[0].id == 10 and recs[-1].id == n - 1
    assert len(timer.span_records(last_ids=n)) == timer.SPAN_RING


def test_threads_share_the_ring(ring, monkeypatch):
    """Sixteen threads, each nesting its own spans with its own ids, on a
    short switch interval: every record lands, each child names its own
    thread's parent and id, and every parent's child time is the sum of
    its children's. (The flag is forced on: the profiler follows only
    the threads it starts in.)"""
    monkeypatch.setattr(timer, "_profiler_enabled", lambda: True)
    threads, rounds = 16, 50
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for k in range(rounds):
                with timer.span("serve.call", id=(t, k)):
                    with timer.span("serve.h2d"):
                        pass
                    with timer.span("serve.d2h"):
                        pass

        pool = [threading.Thread(target=work, args=(t,))
                for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    recs = timer.span_records()
    assert len(recs) == 3 * threads * rounds
    by_id = collections.defaultdict(list)
    for r in recs:
        by_id[r.id].append(r)
    assert len(by_id) == threads * rounds
    for group in by_id.values():
        top = [r for r in group if r.parent is None]
        kids = [r for r in group if r.parent is not None]
        assert [r.name for r in top] == ["serve.call"]
        assert sorted(r.name for r in kids) == ["serve.d2h", "serve.h2d"]
        assert top[0].child_ns == sum(r.end_ns - r.start_ns for r in kids)
