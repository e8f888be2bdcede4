"""A numpy model of kernel K1's algorithm, held against its plain version.

K1 (``refinedet_tpu_torch/csrc/nms_sweep.cu``) cannot run on the CPU, so
this file models what it does in numpy ``uint64`` words and checks the
model against ``ops.nms.nms_sweep_reference`` (and, once, against the JAX
package's Pallas sweep in interpret mode):

* the upper-triangle suppression bitmask, built in stripes of 64 rows that
  hold only the words at or right of the diagonal (the words left of it,
  and the stripes without a valid row, are garbage), with the bits of
  invalid rows and columns left clear;
* the sweep's "removed" words, seeded with the invalid columns and those
  at or past K, taken a word at a time: the greedy inside a word settled
  as a fixed point over its diagonal words, then the kept rows ORed into
  every later word;
* the prefilter that spares the division for pairs whose IoU cannot
  exceed the threshold, checked at the edges: quotients a few ulps either
  side of the threshold, zero and negative unions, NaN and infinities;
* the ring of stripes between several producers and the sweep, with a full
  and an empty barrier a slot, under random interleavings: the hand-off
  protocol must neither deadlock nor let a slot be overwritten before the
  sweep has handed it back.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.ops.nms_pallas import nms_sweep_pallas  # noqa: E402

from refinedet_tpu_torch.ops.nms import nms_sweep_reference  # noqa: E402
from refinedet_tpu_torch.ops.nms_cuda import SOURCE  # noqa: E402
from refinedet_tpu_torch.tools.k1_bench import variants  # noqa: E402

STRIPE = 64
ALL = (1 << 64) - 1
GARBAGE = np.uint64(ALL)  # what a ring word nobody wrote may hold
THRESH = 0.45


def _pack(bits):
    """[n, 64 W] bool -> [n, W] uint64, bit b of word w = column 64 w + b."""
    return np.packbits(bits, axis=-1, bitorder="little").view("<u8")


def _plus(x, p):
    """The kernel adds p = 1 and leaves out the plain version's + 0.0."""
    return x + p if p else x


def _area(b, p):
    return _plus(b[:, 2] - b[:, 0], p) * _plus(b[:, 3] - b[:, 1], p)


def _overlap(rows, cols, p):
    """Intersection and union, op for op as the kernel computes them."""
    iw = np.maximum(_plus(np.minimum(rows[:, None, 2], cols[None, :, 2])
                          - np.maximum(rows[:, None, 0], cols[None, :, 0]),
                          p), np.float32(0))
    ih = np.maximum(_plus(np.minimum(rows[:, None, 3], cols[None, :, 3])
                          - np.maximum(rows[:, None, 1], cols[None, :, 1]),
                          p), np.float32(0))
    inter = iw * ih
    return inter, (_area(rows, p)[:, None] + _area(cols, p)[None, :]) - inter


def _prefilter_scale(t):
    t = np.float32(t)
    if 2.0 ** -20 <= t <= 1.0:
        return np.float32(t * np.float32(1.0 - 2.0 ** -20))
    return np.float32(0.0)


def _may_suppress(inter, uni, tc):
    """The kernel's prefilter, False only where the IoU cannot exceed t.

    The kernel passes a pair where ``fmaf(-tc, uni, inter) >= 0``, and
    every pair where tc = 0. Where ``inter >= tc * uni`` exactly (float64
    holds the product of two float32 exactly) the fused result is >= 0
    too, so the kernel passes every pair passed here, and a few more (a
    tiny negative difference may round to -0): if the pairs skipped here
    hold no hit, neither do the kernel's. A NaN fails both."""
    if tc == 0:
        return np.ones(np.broadcast(inter, uni).shape, bool)
    with np.errstate(invalid="ignore", over="ignore"):
        return inter.astype(np.float64) >= np.float64(tc) \
            * uni.astype(np.float64)


def _sure_scale(t):
    t = np.float32(t)
    if 2.0 ** -20 <= t <= 1.0:
        return np.float32(t * np.float32(1.0 + 2.0 ** -20))
    return np.float32(np.inf)


def _surely_suppresses(inter, uni, th):
    """The kernel's clear-hit test, which spares the division: True only
    where the IoU is surely above t. The kernel takes a pair as a hit where
    ``uni > 0`` and ``fmaf(-th, uni, inter) > 0``; a positive fused result
    means ``inter > th * uni`` exactly, so the pairs taken here, where that
    exact comparison holds, include all the kernel takes."""
    with np.errstate(invalid="ignore", over="ignore"):
        return (uni > 0) & (inter.astype(np.float64)
                            > np.float64(th) * uni.astype(np.float64))


def _iou_above(inter, uni, t):
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return inter / uni > t  # a NaN IoU is False: it never suppresses


def _hits(rows, cols, p, t):
    """iou(row, col) > t as the kernel decides it: the prefilter, then the
    clear-hit test, then the IEEE division for the rest."""
    inter, uni = _overlap(rows, cols, p)
    tc = _prefilter_scale(t)
    divide = (inter > 0) if tc else np.ones(inter.shape, bool)
    return _may_suppress(inter, uni, tc) & (
        _surely_suppresses(inter, uni, _sure_scale(t))
        | (divide & _iou_above(inter, uni, t)))


class Group:
    """One group's inputs as the kernel sees them."""

    def __init__(self, boxes, valid, plus_one):
        self.k = valid.shape[0]
        self.nw = -(-self.k // STRIPE)
        self.boxes = np.zeros((self.nw * STRIPE, 4), np.float32)
        self.boxes[:self.k] = boxes  # columns past K read as zero boxes
        padded = np.zeros(self.nw * STRIPE, bool)
        padded[:self.k] = valid
        self.vwords = _pack(padded[None])[0]
        valid_idx = np.flatnonzero(valid)
        self.n_rows = int(valid_idx[-1]) + 1 if valid_idx.size else 0
        self.stripes = -(-self.n_rows // STRIPE)
        self.p = np.float32(1.0 if plus_one else 0.0)
        self.t = np.float32(THRESH)

    def tasks(self, s):
        """A stripe's (half, word) tasks, as the producer warps take them:
        32 rows by one word at or right of the diagonal, none for a half
        without a valid row."""
        halves = min(2, (self.n_rows - s * STRIPE + 31) // 32)
        return [(h, w) for w in range(s, self.nw) for h in range(halves)
                if (int(self.vwords[s]) >> (32 * h)) & 0xFFFFFFFF]

    def task_words(self, s, h, w):
        """Word w of rows i = 64 s + 32 h + 0..31: of a valid row its valid
        columns j > i, and 0 for an invalid row."""
        i = s * STRIPE + 32 * h + np.arange(32)
        j = w * STRIPE + np.arange(STRIPE)
        bit = np.arange(STRIPE, dtype=np.uint64)
        row_valid = (self.vwords[s] >> bit[32 * h:32 * h + 32]) & 1 == 1
        col_valid = (self.vwords[w] >> bit) & 1 == 1
        if _prefilter_scale(self.t):  # boxes without a positive area
            area = _area(self.boxes, self.p)
            row_valid &= area[i] > 0
            col_valid &= area[j] > 0
        want = row_valid[:, None] & col_valid[None] & (j[None] > i[:, None])
        return _pack(_hits(self.boxes[i], self.boxes[j], self.p, self.t)
                     & want)[:, 0]

    def stripe(self, s):
        """Stripe s as the producers leave it in its ring slot."""
        out = np.full((STRIPE, self.nw), GARBAGE)
        for h, w in self.tasks(s):
            out[32 * h:32 * h + 32, w] = self.task_words(s, h, w)
        return out

    def removed(self):
        """The sweep's starting words: invalid, or at or past K."""
        return [~int(v) & ALL for v in self.vwords]


def _bits(word):
    return [b for b in range(STRIPE) if (word >> b) & 1]


def _settle_word(word, diag):
    """The greedy inside one word, as the sweep warp runs it: a fixed point.
    ``word`` is the word's removed bits on entry, ``diag[b]`` the diagonal
    word of its row b. A row that no row still possibly kept suppresses is
    kept; a row that a kept row suppresses is removed. Returns the kept
    bits."""
    kept, undecided = 0, ~word & ALL
    for _ in range(STRIPE):  # a round settles at least one row
        if not undecided:
            break
        maybe = sure = 0
        for b in _bits(kept | undecided):  # what lanes b, b - 32 hold
            maybe |= int(diag[b])
        for b in _bits(kept):
            sure |= int(diag[b])
        kept |= undecided & ~maybe
        undecided &= maybe & ~sure
    assert not undecided, "the fixed point did not settle in 64 rounds"
    return kept


def _take_word(removed, s, rows):
    """Settle word s from stripe s's rows, then OR the rows kept in it into
    every later word. Returns False when no later column is left open."""
    kept = _settle_word(removed[s], rows[:, s])
    removed[s] = ~kept & ALL
    for w in range(s + 1, len(removed)):
        for b in _bits(kept):
            removed[w] |= int(rows[b, w])
    return any(removed[w] != ALL for w in range(s + 1, len(removed)))


def _keep(removed, k):
    bits = np.asarray([(removed[j // STRIPE] >> (j % STRIPE)) & 1
                       for j in range(k)], bool)
    return ~bits


def model_sweep(group):
    """The bitmask algorithm with the whole mask at hand."""
    removed = group.removed()
    for s in range(group.stripes):
        if not _take_word(removed, s, group.stripe(s)):
            break
    return _keep(removed, group.k)


class Mbarrier:
    """Arrival count and phase, as ``mbarrier`` keeps them."""

    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        self.pending -= 1
        assert self.pending >= 0
        if self.pending == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def passed(self, parity):
        """try_wait.parity: has the phase of this parity completed?"""
        return (self.phase & 1) != parity


def ring_sweep(group, depth, producers, rng):
    """The kernel's two phases through a ring of `depth` slots, with the
    producers and the sweep interleaved at random. Returns the keep mask."""
    ring = np.full((depth, STRIPE, group.nw), GARBAGE)
    full = [Mbarrier(producers) for _ in range(depth)]
    empty = [Mbarrier(1) for _ in range(depth)]
    state = {"done": False, "released": 0, "keep": None}

    def producer(pid):
        for s in range(group.stripes):
            slot = s % depth
            if s >= depth:
                while not empty[slot].passed(((s // depth) & 1) ^ 1):
                    yield False
            if not state["done"]:
                for h, w in group.tasks(s)[pid::producers]:
                    assert state["released"] > s - depth, \
                        "a slot was written before it was handed back"
                    ring[slot, 32 * h:32 * h + 32, w] = \
                        group.task_words(s, h, w)
                    yield True
            full[slot].arrive()
            yield True

    def sweep():
        ready = 0

        def need(s):
            nonlocal ready
            while ready <= s:
                while state["released"] < ready:
                    empty[state["released"] % depth].arrive()
                    state["released"] += 1
                while not full[ready % depth].passed((ready // depth) & 1):
                    yield False
                ready += 1

        removed = group.removed()
        for s in range(group.stripes):
            yield from need(s)
            if not _take_word(removed, s, ring[s % depth]):
                break
            yield True
        state["done"] = True
        state["keep"] = _keep(removed, group.k)
        if group.stripes:
            yield from need(group.stripes - 1)

    live = [sweep()] + [producer(p) for p in range(producers)]
    stalled = 0
    while live:
        gen = live[rng.randint(len(live))]
        try:
            stalled = 0 if next(gen) else stalled + 1
        except StopIteration:
            live.remove(gen)
            stalled = 0
        assert stalled < 1000, "the ring's hand-off deadlocked"
    return state["keep"]


def _inputs(rng, g, k, plus_one, clustered=True):
    """Candidates around a few centres (many suppressions), a non-prefix
    valid mask, and a few identical and zero-area boxes."""
    scale = 320.0 if plus_one else 1.0
    centres = rng.uniform(0.1, 0.7, (g, 4, 2)) if clustered else None
    if clustered:
        pick = rng.randint(4, size=(g, k))
        xy = np.take_along_axis(centres, pick[..., None], 1) \
            + rng.normal(0, 0.03, (g, k, 2))
    else:
        xy = rng.uniform(0, 0.8, (g, k, 2))
    wh = rng.uniform(0.02, 0.3, (g, k, 2))
    boxes = (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)
    if k > 4:
        boxes[:, 3] = boxes[:, 1]          # an identical pair
        boxes[:, 4, 2:] = boxes[:, 4, :2]  # a zero-area box
    valid = rng.uniform(size=(g, k)) < 0.8
    return boxes, valid


def _reference(boxes, valid, plus_one):
    return nms_sweep_reference(torch.from_numpy(boxes),
                               torch.from_numpy(valid), THRESH,
                               plus_one).numpy()


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("k", [1, 5, 63, 64, 65, 127, 128, 129, 200, 257])
def test_model_matches_reference(k, plus_one):
    rng = np.random.RandomState(k + 1000 * plus_one)
    for clustered in (True, False):
        boxes, valid = _inputs(rng, 3, k, plus_one, clustered)
        want = _reference(boxes, valid, plus_one)
        got = np.stack([model_sweep(Group(b, v, plus_one))
                        for b, v in zip(boxes, valid)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth,producers", [(1, 1), (2, 3), (3, 2), (5, 7)])
def test_ring_handoff_matches_reference(depth, producers):
    rng = np.random.RandomState(depth * 10 + producers)
    for k in (65, 200, 321):
        boxes, valid = _inputs(rng, 2, k, False)
        want = _reference(boxes, valid, False)
        for b, v, w in zip(boxes, valid, want):
            got = ring_sweep(Group(b, v, False), depth, producers, rng)
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("plus_one", [False, True])
def test_model_edge_cases(plus_one):
    k = 200
    same = np.tile(np.float32([10, 10, 50, 60]), (k, 1))
    zero = np.tile(np.float32([5, 5, 5, 5]), (k, 1))
    idx = np.arange(k)
    masks = {"all": np.ones(k, bool), "none": np.zeros(k, bool),
             "sparse": idx % 7 == 3, "last": idx == k - 1,
             "first_and_last": (idx == 0) | (idx == k - 1)}
    rng = np.random.RandomState(7)
    # A chain: each box suppresses only the next, so the greedy keeps every
    # other one and the fixed point needs a round for every two rows.
    shift = np.float32(0.3) * np.arange(k, dtype=np.float32)
    chain = np.stack([shift, np.zeros(k, np.float32), shift + 1,
                      np.ones(k, np.float32)], -1) * np.float32(10)
    # Signed zeros: widths of -0 and +0, which the plain version's + 0.0
    # turns into +0 and the kernel leaves as they are.
    signed = np.tile(np.float32([[-0.0, -0.0, 0.0, 0.0],
                                 [0.0, 0.0, -0.0, 1.0],
                                 [-0.0, 0.0, 1.0, -0.0],
                                 [0.0, -0.0, 0.0, 2.0]]), (k // 4, 1))
    for boxes in (same, zero, chain, signed):
        for valid in masks.values():
            want = _reference(boxes[None], valid[None], plus_one)[0]
            group = Group(boxes, valid, plus_one)
            np.testing.assert_array_equal(model_sweep(group), want)
            # The sweep ends early (identical boxes) while producers still
            # have stripes to hand over: the drain must not deadlock.
            np.testing.assert_array_equal(
                ring_sweep(group, 2, 3, rng), want)


def test_model_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    boxes, valid = _inputs(rng, 4, 256, False)
    want = np.asarray(nms_sweep_pallas(jnp.asarray(boxes),
                                       jnp.asarray(valid), THRESH,
                                       interpret=True))
    got = np.stack([model_sweep(Group(b, v, False))
                    for b, v in zip(boxes, valid)])
    np.testing.assert_array_equal(got, want)


def _near(x, n):
    """Every float32 within n ulps of each value of x."""
    steps = np.arange(-n, n + 1, dtype=np.int64)
    bits = x.astype(np.float32).view(np.int32).astype(np.int64)
    near = (bits[:, None] + steps[None]).clip(0, 0x7F7FFFFF)
    return near.astype(np.int32).view(np.float32).ravel()


@pytest.mark.parametrize("t", [0.45, 0.49, 0.5, 0.3, 0.7, 1.0, 2.0 ** -20,
                               0.0, 1.5, -0.2])
def test_prefilters_never_change_a_hit(t):
    rng = np.random.RandomState(11)
    t32, tc, th = np.float32(t), _prefilter_scale(t), _sure_scale(t)
    # Unions over the whole exponent range, subnormals included.
    uni = np.concatenate([
        np.float32(2.0) ** rng.uniform(-149, 127, 400).astype(np.float32),
        _near(np.asarray([2.0 ** -100, 2.0 ** -126, 2.0 ** -149, 1.0,
                          3.0e38]), 3),
        rng.uniform(0.01, 2.0, 200).astype(np.float32),
        np.float32([1e-45, 2.0 ** -120])])
    uni = uni[np.isfinite(uni)]
    # Intersections within 40 ulps of t * uni and of tc * uni: quotients
    # just under, at and just over the threshold and its rounding midpoint.
    with np.errstate(over="ignore", invalid="ignore"):
        anchors = (t32 * uni, tc * uni, th * uni)
    for anchor in anchors:
        inter = _near(anchor, 40).reshape(len(uni), -1)
        u = np.broadcast_to(uni[:, None], inter.shape)
        hit = _iou_above(inter, u, t32)
        assert not (hit & ~_may_suppress(inter, u, tc)).any()
        assert not (~hit & _surely_suppresses(inter, u, th)).any()
    # Zero intersections, zero and negative unions, NaN and infinities. An
    # intersection is a product of two clamped widths: >= 0, -0 or NaN.
    odd = np.float32([0.0, -0.0, 1.0, -1.0, 1e-30, 3.0, np.inf, -np.inf,
                      np.nan, 2.0 ** -101, 2.0 ** -149, 1e38])
    inter, u = np.meshgrid(odd[~(odd < 0)], odd)
    hit = _iou_above(inter, u, t32)
    assert not (hit & ~_may_suppress(inter, u, tc)).any()
    assert not (~hit & _surely_suppresses(inter, u, th)).any()
    if 2.0 ** -20 <= t <= 1.0:  # and the filter does spare divisions
        boxes, _ = _inputs(rng, 1, 256, False, clustered=False)
        inter, u = _overlap(boxes[0], boxes[0], np.float32(0))
        assert (~_may_suppress(inter, u, tc)).mean() > 0.5


def test_design_variants_apply_to_the_source():
    """tools/k1_bench.py measures its variants as text substitutions of the
    shipped kernel; each must still find its text there."""
    src = SOURCE.read_text()
    table = variants(src)
    assert set(table) == {"shipped", "build_only", "no_prefilter",
                          "row_step"}
    for name, (text, exact) in table.items():
        assert (text == src) == (name == "shipped")
        assert exact == (name != "build_only")
    assert "__reduce_min_sync(" in table["row_step"][0]
    assert "__reduce_min_sync(" not in src
