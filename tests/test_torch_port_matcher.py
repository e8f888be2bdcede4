"""Port parity: ``refinedet_tpu_torch.boxes.matcher`` against the JAX
package's matcher, on the CPU, on the same numpy-seeded problems.

Tolerances: ``conf_t`` exactly, ``loc_t`` to 1e-5 (relative and
absolute). Each problem first asserts that no IoU lies within 1e-6 of the
threshold and no GT's best anchor wins by less than 1e-6, so a last-ulp
difference between the two frameworks' arithmetic cannot flip a match.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.boxes import matcher as jm  # noqa: E402
from refinedet_tpu.boxes.codec import decode as jdecode  # noqa: E402
from refinedet_tpu.boxes.geometry import jaccard as jjaccard  # noqa: E402
from refinedet_tpu.boxes.geometry import point_form as jpoint_form  # noqa: E402

from refinedet_tpu_torch.boxes import matcher as tm  # noqa: E402
from refinedet_tpu_torch.boxes.priors import generate_priors  # noqa: E402
from refinedet_tpu_torch.config import coco_refinedet  # noqa: E402

from test_boxes import random_boxes  # noqa: E402

VAR = (0.1, 0.2)
THRESH = 0.5
PRIORS = generate_priors(coco_refinedet["320"])  # [6375, 4]
MODES = ("ssd", "arm", "odm")


def _problem(seed, b=3, m=8):
    """GT tables [b, m] with 1..m-2 valid rows each, labels, valid, and
    ARM offsets [b, P, 4] for the ODM mode."""
    rng = np.random.RandomState(seed)
    truths = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        n = rng.randint(1, m - 1)
        truths[i, :n] = random_boxes(rng, n)
        labels[i, :n] = rng.randint(1, 20, size=n)
        valid[i, :n] = True
    arm_loc = (rng.randn(b, len(PRIORS), 4) * 0.3).astype(np.float32)
    return truths, labels, valid, arm_loc


def _anchors(mode, arm_loc_i):
    if mode == "odm":
        return np.asarray(jdecode(jnp.asarray(arm_loc_i), PRIORS, VAR))
    return np.asarray(jpoint_form(jnp.asarray(PRIORS)))


def _assert_separated(truths, valid, arm_loc, mode):
    """No IoU within 1e-6 of the threshold. Against the raw priors the two
    frameworks' IoU must be bitwise equal (the grid has exact ties, which
    then break alike); against ARM-decoded anchors, whose exp may differ
    in the last ulp, each valid GT's best anchor must beat its second best
    by more than 1e-6."""
    for i in range(truths.shape[0]):
        anchors = _anchors(mode, arm_loc[i])
        iou = np.asarray(jjaccard(jnp.asarray(truths[i][valid[i]]),
                                  jnp.asarray(anchors)))
        assert np.abs(iou - THRESH).min() > 1e-6
        if mode == "odm":
            top2 = np.sort(iou, axis=1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).min() > 1e-6
        else:
            mine = tm.jaccard(torch.from_numpy(truths[i][valid[i]]),
                              torch.from_numpy(np.array(anchors))).numpy()
            np.testing.assert_array_equal(mine, iou)


def _jax(mode, t, l, v, a, batch):
    if mode == "ssd":
        fn = jm.match_batch if batch else jm.match
        return fn(t, l - 1, v, PRIORS, VAR, THRESH)
    fn = jm.refine_match_batch if batch else jm.refine_match
    if mode == "arm":
        return fn(t, jnp.ones_like(l), v, PRIORS, VAR, THRESH)
    return fn(t, l, v, PRIORS, VAR, THRESH, a)


def _port(mode, t, l, v, a, batch):
    priors = torch.from_numpy(PRIORS)
    if mode == "ssd":
        fn = tm.match_batch if batch else tm.match
        return fn(t, l - 1, v, priors, VAR, THRESH)
    fn = tm.refine_match_batch if batch else tm.refine_match
    if mode == "arm":
        return fn(t, torch.ones_like(l), v, priors, VAR, THRESH)
    return fn(t, l, v, priors, VAR, THRESH, a)


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.conf_t.numpy(),
                                  np.asarray(want.conf_t))
    np.testing.assert_allclose(got.loc_t.numpy(), np.asarray(want.loc_t),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_and_single_forms_match_jax(mode, seed):
    truths, labels, valid, arm_loc = _problem(seed)
    _assert_separated(truths, valid, arm_loc, mode)
    tt = [torch.from_numpy(x) for x in (truths, labels, valid, arm_loc)]
    jj = [jnp.asarray(x) for x in (truths, labels, valid, arm_loc)]
    got = _port(mode, *tt, batch=True)
    want = _jax(mode, *jj, batch=True)
    assert got.conf_t.shape == (3, len(PRIORS))
    assert int((got.conf_t > 0).sum()) > 0
    _assert_equal(got, want)
    for i in range(truths.shape[0]):
        single = _port(mode, *(x[i] for x in tt), batch=False)
        _assert_equal(single, _jax(mode, *(x[i] for x in jj), batch=False))
        _assert_equal(single, tm.MatchResult(got.loc_t[i], got.conf_t[i]))


@pytest.mark.parametrize("batch", [False, True])
def test_forced_assignment_last_gt_wins(batch):
    # Both GTs have prior 0 as their best anchor: the last one wins.
    priors = np.array([[0.5, 0.5, 0.2, 0.2],
                       [0.9, 0.9, 0.1, 0.1]], np.float32)
    truths = np.zeros((4, 4), np.float32)
    truths[:2] = [[0.42, 0.42, 0.58, 0.58], [0.40, 0.40, 0.60, 0.60]]
    labels = np.array([3, 7, 0, 0], np.int32)
    valid = np.array([True, True, False, False])
    args = [truths, labels, valid]
    if batch:
        args = [x[None] for x in args]
        jfn, tfn = jm.match_batch, tm.match_batch
    else:
        jfn, tfn = jm.match, tm.match
    want = jfn(*(jnp.asarray(x) for x in args), jnp.asarray(priors), VAR,
               THRESH)
    got = tfn(*(torch.from_numpy(x) for x in args), torch.from_numpy(priors),
              VAR, THRESH)
    assert int(got.conf_t.reshape(-1)[0]) == 8  # GT 1 (label 7) + 1
    _assert_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_padding_rows_have_no_effect(mode):
    truths, labels, valid, arm_loc = _problem(2, b=2, m=6)
    wide = [np.zeros((2, 32) + x.shape[2:], x.dtype)
            for x in (truths, labels, valid)]
    for w, x in zip(wide, (truths, labels, valid)):
        w[:, :6] = x
    wide[0][:, 6:] = 0.77  # poisoned padding rows
    wide[1][:, 6:] = 19
    narrow = _port(mode, *(torch.from_numpy(x) for x in
                           (truths, labels, valid, arm_loc)), batch=True)
    padded = _port(mode, *(torch.from_numpy(x) for x in wide),
                   torch.from_numpy(arm_loc), batch=True)
    assert torch.equal(narrow.conf_t, padded.conf_t)
    torch.testing.assert_close(narrow.loc_t, padded.loc_t, rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_all_invalid_gt_is_all_background(mode):
    _, _, _, arm_loc = _problem(3, b=2)
    t = torch.zeros(2, 8, 4)
    l = torch.zeros(2, 8, dtype=torch.int32)
    v = torch.zeros(2, 8, dtype=torch.bool)
    got = _port(mode, t, l, v, torch.from_numpy(arm_loc), batch=True)
    want = _jax(mode, *(jnp.asarray(x.numpy()) for x in (t, l, v)),
                jnp.asarray(arm_loc), batch=True)
    assert int(got.conf_t.abs().sum()) == 0
    np.testing.assert_array_equal(got.conf_t.numpy(),
                                  np.asarray(want.conf_t))
