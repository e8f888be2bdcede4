"""Port parity: ``refinedet_tpu_torch.losses`` against the JAX package's
losses, on the CPU, on identical numpy-seeded heads and targets.

Tolerances: loss values rtol 1e-5; gradients with respect to the heads
rtol 1e-4 (absolute floor 1e-4 of the largest gradient); positive counts
and the mined selection exactly.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.losses import multibox_loss as jmultibox  # noqa: E402
from refinedet_tpu.losses import \
    refinedet_multibox_loss as jrefinedet  # noqa: E402

from refinedet_tpu_torch.boxes.matcher import \
    refine_match_batch  # noqa: E402
from refinedet_tpu_torch.boxes.priors import generate_priors  # noqa: E402
from refinedet_tpu_torch.config import coco_refinedet  # noqa: E402
from refinedet_tpu_torch.losses import (RefineDetMultiBoxLoss,  # noqa: E402
                                        multibox_loss,
                                        refinedet_multibox_loss)

from test_boxes import random_boxes  # noqa: E402

C = 4
B = 2
M = 8
PRIORS = generate_priors(coco_refinedet["320"])  # [6375, 4]
P = len(PRIORS)


def _inputs(seed, b=B):
    """Heads (arm_loc, arm_conf, odm_loc, odm_conf, priors) and padded
    targets (boxes, 1-based labels, valid) as numpy arrays."""
    rng = np.random.RandomState(seed)
    heads = [(rng.randn(b, P, 4) * 0.5).astype(np.float32),
             rng.randn(b, P, 2).astype(np.float32),
             (rng.randn(b, P, 4) * 0.5).astype(np.float32),
             rng.randn(b, P, C).astype(np.float32), PRIORS]
    boxes = np.zeros((b, M, 4), np.float32)
    labels = np.zeros((b, M), np.int32)
    valid = np.zeros((b, M), bool)
    for i in range(b):
        n = rng.randint(2, M)
        boxes[i, :n] = random_boxes(rng, n)
        labels[i, :n] = rng.randint(1, C, size=n)
        valid[i, :n] = True
    return heads, (boxes, labels, valid)


def _port_loss(heads, targets, use_arm, theta=0.01):
    heads = [torch.tensor(h, requires_grad=i < 4)
             for i, h in enumerate(heads)]
    out = refinedet_multibox_loss(
        tuple(heads), *(torch.from_numpy(t) for t in targets),
        num_classes=C if use_arm else 2, use_arm=use_arm, theta=theta)
    (out.loss_l + out.loss_c).backward()
    return type(out)(*(x.detach() for x in out)), [h.grad for h in heads[:4]]


def _jax_loss(heads, targets, use_arm, theta=0.01):
    def f(*h):
        out = jrefinedet(tuple(h) + (jnp.asarray(heads[4]),),
                         *(jnp.asarray(t) for t in targets),
                         num_classes=C if use_arm else 2, use_arm=use_arm,
                         theta=theta)
        return out.loss_l + out.loss_c, out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        *(jnp.asarray(h) for h in heads[:4]))
    return out, [np.asarray(g) for g in grads]


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def _assert_grads(got, want):
    for g, w in zip(got, want):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("use_arm", [False, True], ids=["arm", "odm"])
@pytest.mark.parametrize("seed", [0, 1])
def test_refinedet_loss_and_grads_match_jax(use_arm, seed):
    heads, targets = _inputs(seed)
    got, ggrads = _port_loss(heads, targets, use_arm)
    want, wgrads = _jax_loss(heads, targets, use_arm)
    assert float(want.num_pos) > 0 and float(want.loss_l) > 0
    _assert_same(got, want)
    _assert_grads(ggrads, wgrads)
    # The ODM loss reads the ARM heads only through detached matching and
    # the detached theta filter.
    if use_arm:
        assert ggrads[0] is None and ggrads[1] is None


def test_ssd_multibox_loss_matches_jax():
    heads, (boxes, labels, valid) = _inputs(2)
    loc, conf = heads[2], heads[3]
    labels0 = labels - 1
    t = [torch.tensor(x, requires_grad=True) for x in (loc, conf)]
    got = multibox_loss((*t, torch.from_numpy(PRIORS)),
                        torch.from_numpy(boxes), torch.from_numpy(labels0),
                        torch.from_numpy(valid), num_classes=C)
    (got.loss_l + got.loss_c).backward()
    got = type(got)(*(x.detach() for x in got))

    def f(loc, conf):
        out = jmultibox((loc, conf, jnp.asarray(PRIORS)), jnp.asarray(boxes),
                        jnp.asarray(labels0), jnp.asarray(valid),
                        num_classes=C)
        return out.loss_l + out.loss_c, out

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(loc), jnp.asarray(conf))
    assert float(want.loss_l) > 0
    _assert_same(got, want)
    _assert_grads([x.grad for x in t], [np.asarray(g) for g in grads])


def test_theta_filter_keeps_only_confident_arm_positives():
    heads, targets = _inputs(3)
    rng = np.random.RandomState(3)
    # P(object) spread over (0, 1): theta = 0.5 drops about half.
    heads[1] = np.stack([np.zeros((B, P)), rng.randn(B, P) * 2],
                        -1).astype(np.float32)
    unfiltered, _ = _port_loss(heads, targets, True, theta=0.0)
    got, ggrads = _port_loss(heads, targets, True, theta=0.5)
    want, wgrads = _jax_loss(heads, targets, True, theta=0.5)
    _assert_same(got, want)
    _assert_grads(ggrads, wgrads)
    # By hand: ODM positives whose softmax(arm_conf)[..., 1] > theta.
    with torch.no_grad():
        _, conf_t = refine_match_batch(
            *(torch.from_numpy(t) for t in targets), torch.from_numpy(PRIORS),
            (0.1, 0.2), 0.5, arm_loc=torch.from_numpy(heads[0]))
        obj = torch.softmax(torch.from_numpy(heads[1]), -1)[..., 1]
    assert float(got.num_pos) == float(((conf_t > 0) & (obj > 0.5)).sum())
    assert 0 < float(got.num_pos) < float(unfiltered.num_pos)


@pytest.mark.parametrize("use_arm", [False, True], ids=["arm", "odm"])
def test_no_positive_gives_zero_losses(use_arm):
    heads, (boxes, labels, valid) = _inputs(4)
    valid = np.zeros_like(valid)
    got, ggrads = _port_loss(heads, (boxes, labels, valid), use_arm)
    want, _ = _jax_loss(heads, (boxes, labels, valid), use_arm)
    assert float(got.num_pos) == float(want.num_pos) == 0
    assert float(got.loss_l) == float(got.loss_c) == 0.0
    assert all(g is None or float(g.abs().sum()) == 0 for g in ggrads)


def test_mining_ties_select_the_same_priors():
    """Confidence logits from a few levels make many equal mining losses;
    the stable order decides which negatives are mined. The selected set
    shows as the rows with a non-zero gradient, and must equal JAX's."""
    heads, targets = _inputs(5)
    rng = np.random.RandomState(5)
    heads[1] = rng.randint(0, 2, (B, P, 2)).astype(np.float32)
    heads[3] = rng.randint(0, 2, (B, P, C)).astype(np.float32)
    for use_arm, conf in ((False, 1), (True, 3)):
        got, ggrads = _port_loss(heads, targets, use_arm)
        want, wgrads = _jax_loss(heads, targets, use_arm)
        _assert_same(got, want)
        sel = ggrads[conf].abs().sum(-1).numpy() > 0
        np.testing.assert_array_equal(sel, np.abs(wgrads[conf]).sum(-1) > 0)
        # ties exist among the selected rows' losses and at the boundary
        assert 0 < sel.sum() < sel.size


def test_degenerate_arm_boxes_keep_gradients_finite():
    heads, targets = _inputs(6)
    # Far-off ARM offsets: decoded anchors whose width and height round to
    # zero, so the ODM targets against them are not finite.
    heads[0][:, ::7, :2] = 1e9
    heads[0][:, ::7, 2:] = -200.0
    with torch.no_grad():
        loc_t, _ = refine_match_batch(
            *(torch.from_numpy(t) for t in targets), torch.from_numpy(PRIORS),
            (0.1, 0.2), 0.5, arm_loc=torch.from_numpy(heads[0]))
    assert not bool(torch.isfinite(loc_t).all())
    got, ggrads = _port_loss(heads, targets, True)
    want, wgrads = _jax_loss(heads, targets, True)
    assert np.isfinite(float(got.loss_l)) and float(got.num_pos) > 0
    _assert_same(got, want)
    for g in ggrads[2:]:
        assert bool(torch.isfinite(g).all())
    _assert_grads(ggrads, wgrads)


def test_class_dim_is_checked_and_shim_matches():
    heads, targets = _inputs(7)
    th = tuple(torch.from_numpy(h) for h in heads)
    tt = [torch.from_numpy(t) for t in targets]
    with pytest.raises(ValueError, match="class dim"):
        refinedet_multibox_loss(th, *tt, num_classes=C + 1, use_arm=True)
    crit = RefineDetMultiBoxLoss(C, 0.5, True, 0, True, 3, 0.5, False,
                                 use_ARM=True)
    loss_l, loss_c = crit(th, *tt)
    out = refinedet_multibox_loss(th, *tt, num_classes=C, use_arm=True)
    assert float(loss_l) == float(out.loss_l)
    assert float(loss_c) == float(out.loss_c)
