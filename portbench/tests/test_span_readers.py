"""The six readers of the program's spans on a fabricated ring: each
takes the records of the traced stretch's ids (the last ones), returns
its span's device ms per step or call, and None where the ring holds
fewer ids, where the span was not timed on the card, or where the
program has no spans at all (the parent of the change that added them).
Each reader's layer and unit are its entry's. The shared reader gives
None for the spans the program times on the host alone."""

import collections

import pytest

from portbench import harness
from portbench.span_metric import read_span
from refinedet_tpu_torch.utils import timer

ROOT = harness.ROOT
READERS = {
    "augment_ms.train": "train.augment",
    "forward_ms.train": "train.forward",
    "loss_ms.train": "train.loss",
    "backward_ms.train": "train.backward",
    "optimizer_ms.train": "train.optimizer",
    "h2d_ms.detect": "serve.h2d",
}
SIBLINGS = {"train": ["train.augment", "train.forward", "train.loss",
                      "train.backward", "train.optimizer"],
            "detect": ["serve.h2d", "serve.replay", "serve.d2h"]}


def reader(name):
    return harness.load_module(harness.metric_path(name, ROOT),
                               f"reader_{name}")


HOST_ONLY = {"serve.replay", "serve.d2h"}


def fill(ring, group, ids, device=True):
    """Spans of steps or calls ``ids``: the top span and its children,
    child k of id i timed at (i + 1) * (k + 1) ms on the card, except
    those the program times on the host alone."""
    top = "train.step" if group == "train" else "serve.call"
    t = 0
    for i in ids:
        ring.append(timer.SpanRecord(top, None, top, i, t, t + 100))
        for k, name in enumerate(SIBLINGS[group]):
            timed = device and name not in HOST_ONLY
            ring.append(timer.SpanRecord(
                name, top, top, i, t + k, t + k + 1,
                device_ms=(i + 1) * (k + 1) if timed else None))
        t += 100


def record(steps, untraced):
    return {"window": {"steps": steps, "untraced_steps": untraced}}


@pytest.fixture
def ring(monkeypatch):
    fresh = collections.deque(maxlen=timer.SPAN_RING)
    monkeypatch.setattr(timer, "_ring", fresh)
    return fresh


@pytest.mark.parametrize("name", sorted(READERS))
def test_reads_the_last_ids(ring, name):
    group = name.rsplit(".", 1)[1]
    k = SIBLINGS[group].index(READERS[name])
    fill(ring, group, range(10))  # ids 0-9; the traced stretch is 6-9
    got = reader(name).read(record(50, 46))
    assert got == pytest.approx(sum((i + 1) * (k + 1)
                                    for i in range(6, 10)) / 4)


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_when_short_or_untimed(ring, name):
    group = name.rsplit(".", 1)[1]
    fill(ring, group, range(3))
    r = reader(name)
    assert r.read(record(50, 46)) is None  # 4 ids asked, 3 held
    assert r.read(record(50, 50)) is None  # no traced stretch
    ring.clear()
    fill(ring, group, range(4), device=False)
    assert r.read(record(50, 46)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_without_the_programs_spans(monkeypatch, name):
    monkeypatch.delattr(timer, "span_records")
    assert reader(name).read(record(50, 46)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_layer_and_unit_are_the_entrys(name):
    bench = harness.benchmark(ROOT)
    entry, = [m for m in bench["per_layer"] if m["name"] == name]
    r = reader(name)
    assert (r.LAYER, r.UNIT, r.SPAN) == (entry["layer"], entry["unit"],
                                        READERS[name])
    assert entry["source"] == "program_span"


@pytest.mark.parametrize("name", ["serve.call", "serve.replay", "serve.d2h",
                                  "serve.none"])
def test_untimed_or_absent_spans_read_none(ring, name):
    """Spans the program times on the host alone, and a name it never
    records, give no device ms, though the stretch's ids are all held."""
    fill(ring, "detect", range(10))
    assert read_span(record(50, 46), "serve.h2d") is not None
    assert read_span(record(50, 46), name) is None
