"""Port parity: the plain NMS sweep (the plain version of kernel K1),
``class_parallel_nms`` and the on-device ``soft_nms`` against the JAX
package's, on the CPU.

The JAX side runs the Pallas kernel in interpret mode and the XLA
formulation, as ``tests/test_nms_pallas.py`` does. The Pallas path rounds
K up to a multiple of 128 and marks the extra ranks invalid; the port
takes exactly ``min(top_k, N)`` candidates, so the first ranks are
compared and the JAX pad must keep nothing.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.ops import nms as jnms  # noqa: E402
from refinedet_tpu.ops import soft_nms as jsoft_nms  # noqa: E402
from refinedet_tpu.ops.dispatch import \
    class_parallel_nms as jclass_parallel_nms  # noqa: E402
from refinedet_tpu.ops.nms_pallas import nms_pallas  # noqa: E402

from refinedet_tpu_torch.ops import nms_cuda  # noqa: E402
from refinedet_tpu_torch.ops.dispatch import (  # noqa: E402
    batched_nms_auto, class_parallel_nms)
from refinedet_tpu_torch.ops.nms import (nms, nms_sweep_reference,  # noqa: E402
                                         select_candidates, soft_nms)

from oracles import np_greedy_nms  # noqa: E402
from test_boxes import random_boxes  # noqa: E402


def _dets(rng, n, scale=300.0):
    boxes = random_boxes(rng, n, scale=scale)
    scores = rng.uniform(0.01, 1.0, size=n).astype(np.float32)
    return boxes, scores


def _port_sweep(boxes, scores, top_k, score_thresh=-np.inf, plus_one=False,
                iou=0.45):
    idx, _, cand, valid = select_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), top_k,
        score_thresh)
    keep = nms_sweep_reference(cand[None], valid[None], iou,
                               plus_one=plus_one)[0]
    return idx.numpy(), keep.numpy()


@pytest.mark.parametrize("plus_one", [False, True])
def test_sweep_matches_pallas_xla_and_oracle(rng, plus_one):
    for _ in range(3):
        boxes, scores = _dets(rng, 200)
        idx, keep = _port_sweep(boxes, scores, 256, plus_one=plus_one)
        assert idx.shape == (200,)
        res_p = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                           top_k=256, plus_one=plus_one, interpret=True)
        p_idx, p_keep = np.asarray(res_p.indices), np.asarray(res_p.keep)
        np.testing.assert_array_equal(idx, p_idx[:200])
        np.testing.assert_array_equal(keep, p_keep[:200])
        assert not p_keep[200:].any()
        res_x = jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                     top_k=200, plus_one=plus_one)
        np.testing.assert_array_equal(idx, np.asarray(res_x.indices))
        np.testing.assert_array_equal(keep, np.asarray(res_x.keep))
        dets = np.hstack([boxes, scores[:, None]])
        assert sorted(idx[keep].tolist()) == sorted(
            np_greedy_nms(dets, 0.45, plus_one=plus_one))


def test_batched_matches_pallas_and_xla(rng):
    boxes = np.stack([random_boxes(rng, 128, 300.0) for _ in range(6)])
    scores = rng.uniform(0, 1, (6, 128)).astype(np.float32)
    res = batched_nms_auto(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.5, top_k=128)
    res_p = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                       top_k=128, interpret=True)
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(res_p.indices))
    np.testing.assert_array_equal(res.keep.numpy(), np.asarray(res_p.keep))
    for g in range(6):
        res_x = jnms(jnp.asarray(boxes[g]), jnp.asarray(scores[g]), 0.5,
                     top_k=128)
        np.testing.assert_array_equal(res.keep[g].numpy(),
                                      np.asarray(res_x.keep))


def test_score_thresh_and_padding(rng):
    boxes, scores = _dets(rng, 100)  # N=100 < 128: the Pallas pad path
    scores[:40] = 0.001
    idx, keep = _port_sweep(boxes, scores, 128, score_thresh=0.01)
    assert keep.shape == (100,)
    assert (idx[keep] >= 40).all()
    res_p = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                       top_k=128, score_thresh=0.01, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(res_p.indices)[:100])
    np.testing.assert_array_equal(keep, np.asarray(res_p.keep)[:100])
    res_x = jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.45, top_k=128,
                 score_thresh=0.01)
    np.testing.assert_array_equal(keep, np.asarray(res_x.keep))


@pytest.mark.parametrize("top_k", [50, 300])  # below and above N
def test_class_parallel_nms_matches_jax(rng, top_k):
    b, c, n = 2, 3, 240
    boxes = np.stack([random_boxes(rng, n) for _ in range(b)])[:, None]
    scores = rng.uniform(0, 1, (b, c, n)).astype(np.float32)
    scores[scores < 0.3] = 0.0  # filtered scores: exact zeros, many ties
    bx, sc = class_parallel_nms(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.45, top_k=top_k,
                                score_thresh=0.01)
    jbx, jsc = jclass_parallel_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                   0.45, top_k=top_k, score_thresh=0.01,
                                   backend="cpu")
    assert bx.shape == (b, c, top_k, 4) and sc.shape == (b, c, top_k)
    np.testing.assert_array_equal(bx.numpy(), np.asarray(jbx))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_ties_keep_lower_index_first(rng):
    boxes = random_boxes(rng, 64, 300.0)
    boxes[10] = boxes[3]  # an exact duplicate at a tied score
    scores = np.full(64, 0.5, np.float32)
    scores[::7] = 0.9
    res = nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45,
              top_k=64)
    res_x = jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.45, top_k=64)
    np.testing.assert_array_equal(res.indices.numpy(),
                                  np.asarray(res_x.indices))
    np.testing.assert_array_equal(res.keep.numpy(), np.asarray(res_x.keep))
    kept = res.indices[res.keep].tolist()
    assert 3 in kept and 10 not in kept  # the lower index survives


def _sweep(boxes, valid, plus_one=False):
    return nms_sweep_reference(torch.tensor(boxes), torch.tensor(valid), 0.45,
                               plus_one=plus_one)


def test_sweep_edge_cases():
    same = np.tile(np.asarray([[10.0, 10.0, 50.0, 60.0]], np.float32),
                   (1, 8, 1))
    all_valid = np.ones((1, 8), bool)
    # identical boxes: one survivor, the first
    assert _sweep(same, all_valid)[0].tolist() == [True] + [False] * 7
    # no valid rows: nothing kept
    assert not _sweep(same, np.zeros((1, 8), bool)).any()
    # non-prefix valid mask: invalid rows neither suppress nor are kept
    mask = np.asarray([[False, True, False, True, True, False, False, True]])
    assert _sweep(same, mask)[0].tolist() == \
        [False, True] + [False] * 6
    # zero-area boxes: IoU 0/0 is NaN, which must not suppress
    zero = np.tile(np.asarray([[5.0, 5.0, 5.0, 5.0]], np.float32), (1, 4, 1))
    assert _sweep(zero, np.ones((1, 4), bool)).all()
    # ... while under +1 areas the same boxes are 1x1 and overlap fully
    assert _sweep(zero, np.ones((1, 4), bool), plus_one=True)[0].tolist() \
        == [True, False, False, False]


def test_wrapper_cpu_path_and_checks(rng):
    boxes = torch.from_numpy(np.stack([random_boxes(rng, 50, 300.0)
                                       for _ in range(3)]))
    valid = torch.from_numpy(rng.uniform(size=(3, 50)) < 0.7)
    before = nms_cuda.nms_sweep.launches
    keep = nms_cuda.nms_sweep(boxes, valid, 0.45)
    assert torch.equal(keep, nms_sweep_reference(boxes, valid, 0.45))
    assert nms_cuda.nms_sweep.launches == before  # the plain version ran
    with pytest.raises(ValueError, match="valid must be"):
        nms_cuda.nms_sweep(boxes, valid[:, :10], 0.45)
    with pytest.raises(ValueError, match="float32"):
        nms_cuda.nms_sweep(boxes.double(), valid, 0.45)
    with pytest.raises(ValueError, match=r"\[G, K, 4\]"):
        nms_cuda.nms_sweep(boxes[0], valid, 0.45)


# Largest score gap to JAX's soft_nms, in units in the last place, on
# sets drawn as below (measured over seeds 0-19 jitted, 0-3 op by op; the
# test runs seed 0): op by op (jax's disable_jit) linear and hard are
# bitwise, gaussian is 7 ulps off (XLA's
# exp against torch's, compounded over a box's decays). Jitted, XLA
# contracts the IoU's ``area_a + area_b`` into an FMA with area_b's
# product (1 ulp in 1135 of 40000 IoUs of one set), so the decayed scores
# drift up to 14 ulps (linear) and 17 (gaussian); hard stays bitwise.
SOFT_NMS_ULPS = {"linear": (0, 16), "gaussian": (8, 20), "hard": (0, 0)}


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("method", ["linear", "gaussian", "hard"])
def test_soft_nms_matches_jax(method):
    """Indices and keep equal JAX's, op by op and jitted; scores within
    ``SOFT_NMS_ULPS`` (bitwise where it says 0), on seeded sets of 200
    boxes, with the defaults and with a pool that loses boxes below a
    score threshold of 0.2 at ``top_k`` 150."""
    boxes, scores = _dets(np.random.RandomState(0), 200)
    for score_thresh, top_k in ((0.001, 200), (0.2, 150)):
        kw = dict(iou_thresh=0.3, score_thresh=score_thresh,
                  method=method, top_k=top_k)
        got = soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       **kw)
        assert 0 < int(got.keep.sum()) < top_k
        with jax.disable_jit():
            eager = jsoft_nms(jnp.asarray(boxes), jnp.asarray(scores),
                              **kw)
        jitted = jsoft_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
        for want, ulps in zip((eager, jitted), SOFT_NMS_ULPS[method]):
            np.testing.assert_array_equal(got.indices.numpy(),
                                          np.asarray(want.indices))
            np.testing.assert_array_equal(got.keep.numpy(),
                                          np.asarray(want.keep))
            assert _ulps(got.scores.numpy(),
                         np.asarray(want.scores)) <= ulps


def test_soft_nms_refuses_unknown_method():
    with pytest.raises(ValueError, match="linear, gaussian or hard"):
        soft_nms(torch.zeros(3, 4), torch.zeros(3), method="exp")
