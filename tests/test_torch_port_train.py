"""Port parity: the training slice of ``refinedet_tpu_torch`` (schedule,
optimizer, EMA, the full train step, checkpoints and the host data
pipeline) against the JAX package's, on the CPU. The Trainer, the train
CLI and ``--basenet`` are held against JAX's in
``tests/test_torch_port_trainer.py``.

Tolerances: the lr schedule rtol 1e-6; two optimizer steps rtol 1e-6;
full steps (320, 3 classes, batch 2, ``max_boxes`` 8, f32, constant lr
0.01, global-norm clip 1.0, EMA 0.9): losses rtol 2e-4 and each
parameter's update a relative L2 norm of 2e-2 (the reference-parity
tolerance; oneDNN and XLA sum the convolutions in different orders); the
host data pipeline bit for bit. The augmented step (on-device augmentation from
staging 640, then the same step) against JAX's on JAX's augmented batch:
the augmented images 2e-2 absolute (JAX's own float32 error there), boxes
1e-6, losses rtol 2e-4; the port's augmenting step against
augment-then-step: bitwise.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from refinedet_tpu.data import augment_jax  # noqa: E402
from refinedet_tpu.data import augmentations as jaug  # noqa: E402
from refinedet_tpu.data.loader import DataLoader as JDataLoader  # noqa: E402
from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.train import make_lr_schedule as jschedule  # noqa: E402
from refinedet_tpu.train import make_optimizer as joptimizer  # noqa: E402
from refinedet_tpu.train import make_train_step as jmake_step  # noqa: E402
from refinedet_tpu.train.train_step import TrainState as JState  # noqa: E402

from refinedet_tpu_torch.config import MEANS, TrainConfig  # noqa: E402
from refinedet_tpu_torch.data import (BaseTransform,  # noqa: E402
                                      DataLoader, SSDAugmentation)
from refinedet_tpu_torch.data.augment import (augment_batch,  # noqa: E402
                                              sample_draws, step_generator)
from refinedet_tpu_torch.models import (RefineDet,  # noqa: E402
                                        build_refinedet,
                                        state_dict_from_flax)
from refinedet_tpu_torch.train import (CheckpointManager,  # noqa: E402
                                       create_train_state, make_lr_schedule,
                                       make_optimizer, make_train_step)
from refinedet_tpu_torch.train.train_step import ema_update_  # noqa: E402

from test_torch_port_augment import replay, staged_batch  # noqa: E402

NUM_CLASSES = 3
LR = 0.01
STEP_CFG = dict(batch_size=2, max_boxes=8, ema_decay=0.9, grad_clip_norm=1.0)


# -- schedule, optimizer, EMA -------------------------------------------------

@pytest.mark.parametrize("epoch_size,max_epoch", [(10, 9), (7, 300), (3, 4)])
def test_lr_schedule_matches_jax(epoch_size, max_epoch):
    args = (1e-3, 0.1, epoch_size, max_epoch, 5, 1e-6)
    mine, theirs = make_lr_schedule(*args), jschedule(*args)
    warm = 5 * epoch_size
    s1 = max_epoch * 2 // 3 * epoch_size
    s2 = max_epoch * 8 // 9 * epoch_size
    steps = {0, 1, warm - 1, warm, s1 - 1, s1, s2 - 1, s2,
             max_epoch * epoch_size}
    for t in sorted(s for s in steps if s >= 0):
        np.testing.assert_allclose(mine(t), float(theirs(t)), rtol=1e-6,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("clip", [0.0, 0.02])
def test_two_optimizer_steps_match_optax(clip):
    """torch SGD (+ the hand-written clip) against the JAX package's optax
    chain; with clip 0.02 the first step clips and the second does not.
    Small parameters keep the updates exact enough to compare on their
    own, at a tolerance that an epsilon on the norm would break."""
    import optax
    rng = np.random.RandomState(0)
    params = [(rng.randn(3, 4) * 0.01).astype(np.float32),
              (rng.randn(5) * 0.01).astype(np.float32)]
    grads = [[g * 0.015 for g in (rng.randn(3, 4), rng.randn(5))],
             [g * 0.0015 for g in (rng.randn(3, 4), rng.randn(5))]]
    grads = [[g.astype(np.float32) for g in step] for step in grads]
    sched = lambda t: (0.1, 0.05)[t]  # noqa: E731

    tensors = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make_optimizer(tensors, sched, grad_clip_norm=clip)
    tx = joptimizer(lambda t: jnp.where(t == 0, 0.1, 0.05),
                    grad_clip_norm=clip)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    norms = []
    for t, step_grads in enumerate(grads):
        norms.append(np.sqrt(sum((g ** 2).sum() for g in step_grads)))
        for p, g in zip(tensors, step_grads):
            p.grad = torch.from_numpy(g.copy())
        opt.apply_gradients(t)
        up, jstate = tx.update([jnp.asarray(g) for g in step_grads], jstate,
                               jparams)
        jparams = optax.apply_updates(jparams, up)
        for p, jp, p0 in zip(tensors, jparams, params):
            got, want = p.detach().numpy(), np.asarray(jp)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            np.testing.assert_allclose(got - p0, want - p0, rtol=2e-6,
                                       atol=0)
    assert norms[0] > 0.02 > norms[1]


def test_ema_follows_its_formula():
    net = torch.nn.Linear(4, 3)
    ema = {n: p.detach().clone() for n, p in net.named_parameters()}
    expect = {n: p.detach().numpy().copy() for n, p in ema.items()}
    rng = np.random.RandomState(1)
    for t in range(1, 5):
        with torch.no_grad():
            for p in net.parameters():
                p.add_(torch.from_numpy(rng.randn(*p.shape).astype(
                    np.float32)))
        ema_update_(ema, net, t, 0.9)
        d = min(0.9, (1.0 + t) / (10.0 + t))
        for n, p in net.named_parameters():
            expect[n] = expect[n] * d + p.detach().numpy() * (1.0 - d)
            np.testing.assert_allclose(ema[n].numpy(), expect[n], rtol=1e-6,
                                       atol=1e-7)


# -- the full step against make_train_step ----------------------------------

def _batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 320, 320, 3).astype(np.float32)
    boxes = np.zeros((2, 8, 4), np.float32)
    labels = np.zeros((2, 8), np.int32)
    valid = np.zeros((2, 8), bool)
    for i in range(2):
        n = rng.randint(1, 5)
        xy = rng.uniform(0.05, 0.5, (n, 2))
        wh = rng.uniform(0.15, 0.45, (n, 2))
        boxes[i, :n] = np.hstack([xy, np.minimum(xy + wh, 1.0)])
        labels[i, :n] = rng.randint(1, NUM_CLASSES, n)
        valid[i, :n] = True
    return images, boxes, labels, valid


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step of ``STEP_CFG`` (compiled once for the module) and a
    function giving a fresh JAX state and a port model, both at the JAX
    init of PRNGKey(0), carried across by state_dict_from_flax."""
    jmodel = jbuild("train", 320, NUM_CLASSES)
    params0 = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(0))
                           ["params"])
    tx = joptimizer(lambda t: LR, grad_clip_norm=STEP_CFG["grad_clip_norm"])
    jstep = jmake_step(jmodel, tx, JTrainConfig(**STEP_CFG))

    def fresh():
        jstate = JState(step=jnp.zeros((), jnp.int32), params=params0,
                        opt_state=tx.init(params0), batch_stats=None,
                        ema_params=jax.tree.map(np.copy, params0))
        model = build_refinedet("train", 320, NUM_CLASSES, device="cpu")
        model.net.load_state_dict(state_dict_from_flax(params0),
                                  strict=True)
        return jstate, model

    return jstep, fresh


def _port_step(model, **cfg):
    opt = make_optimizer(model.net.parameters(), lambda t: LR,
                         grad_clip_norm=STEP_CFG["grad_clip_norm"])
    state = create_train_state(model, opt, ema=True)
    return state, make_train_step(model, opt,
                                  TrainConfig(**{**STEP_CFG, **cfg}))


@pytest.fixture(scope="module")
def two_steps(jax_step):
    """Two steps of each package from the same weights on the same two
    batches. Returns the initial state_dict and, per step, (JAX metrics,
    JAX params and EMA as state_dicts, port metrics, port params and EMA),
    plus the port's model and state after two steps."""
    jstep, fresh = jax_step
    jstate, model = fresh()
    sd0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    state, step = _port_step(model)

    steps = []
    for seed in (0, 1):
        batch = _batch(seed)
        jstate, jmetrics = jstep(jstate, *(jnp.asarray(x) for x in batch))
        state, metrics = step(state, *(torch.from_numpy(x) for x in batch))
        steps.append({
            "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
            "jax_params": state_dict_from_flax(jax.tree.map(
                np.asarray, jstate.params)),
            "jax_ema": state_dict_from_flax(jax.tree.map(
                np.asarray, jstate.ema_params)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.clone() for k, v in
                       model.net.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.items()},
        })
    return sd0, steps, model, state


@pytest.mark.parametrize("n", [1, 2])
def test_full_steps_match_make_train_step(two_steps, n):
    sd0, steps, _, _ = two_steps
    got = steps[n - 1]
    assert set(got["metrics"]) == set(got["jax_metrics"])
    for k, want in got["jax_metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=2e-4,
                                   err_msg=k)
    assert got["metrics"]["num_pos_odm"] > 0
    checked = 0
    for name, w0 in sd0.items():
        d_ref = got["jax_params"][name] - w0
        d_our = got["params"][name] - w0
        rel = float((d_our - d_ref).norm() / (d_ref.norm() + 1e-12))
        assert rel < 2e-2, (name, rel, float(d_ref.norm()))
        np.testing.assert_allclose(got["ema"][name].numpy(),
                                   got["jax_ema"][name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        checked += 1
    assert checked > 50  # every conv weight and bias + the L2Norm scales


def test_augmented_step_matches_jax(jax_step):
    """JAX's augment_batch(fold_in(PRNGKey(seed), 0)) into the JAX step,
    and the port's augment_batch on the replayed draws into the port's
    step, from the same weights: the same losses. The JAX step is the
    module's (``STEP_CFG``: clip 1.0), reused rather than compiled anew;
    a step's losses do not depend on its clip. Then the port's step
    with ``on_device_augment`` at step t is augment_batch on
    ``sample_draws(step_generator(seed, t))`` followed by the plain step,
    bit for bit."""
    jstep, fresh = jax_step
    seed, mean = 3, MEANS
    images, boxes, labels, valid = staged_batch(0, NUM_CLASSES)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    jimg, jboxes, jvalid = augment_jax.augment_batch(
        jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid), key,
        out_size=320, mean=mean)
    jstate, model = fresh()
    _, jmetrics = jstep(jstate, jimg, jboxes, jnp.asarray(labels), jvalid)

    t = [torch.from_numpy(a) for a in (images, boxes, labels, valid)]
    img, nb, nv = augment_batch(t[0], t[1], t[3],
                                replay(jax.random.split(key, 2)), 320, mean)
    # JAX's fused program is itself ~1.4e-2 from a float64 evaluation of
    # the chain on this batch, the port's ~1.4e-4
    # (test_torch_port_augment.test_augment_batch_float32_accuracy).
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                               atol=2e-2)
    np.testing.assert_allclose(nb.numpy(), np.asarray(jboxes), rtol=0,
                               atol=1e-6)
    assert torch.equal(nv, torch.from_numpy(np.array(jvalid)))
    state, step = _port_step(model)
    _, metrics = step(state, img, nb, t[2], nv)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want),
                                   rtol=2e-4, err_msg=k)
    assert float(metrics["num_pos_odm"]) > 0

    # the augmenting step at step 5 against augment-then-step
    at = 5
    _, model_a = fresh()
    state_a, step_a = _port_step(model_a, on_device_augment=True,
                                 seed=seed, mean=mean)
    state_a.step = at
    state_a, metrics_a = step_a(state_a, *t)
    _, model_b = fresh()
    state_b, step_b = _port_step(model_b)
    state_b.step = at
    img, nb, nv = augment_batch(
        t[0], t[1], t[3], sample_draws(step_generator(seed, at, "cpu"), 2),
        320, mean)
    state_b, metrics_b = step_b(state_b, img, nb, t[2], nv)
    assert state_a.step == state_b.step == at + 1
    for k, v in metrics_b.items():
        assert torch.equal(metrics_a[k], v), k
    for (k, a), b in zip(model_a.net.state_dict().items(),
                         model_b.net.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_round_trip(two_steps, tmp_path):
    _, _, model, state = two_steps
    ckpt = CheckpointManager(str(tmp_path), "RefineDet320_TEST")
    path = ckpt.save(state, 7)
    assert os.path.basename(path) == "RefineDet320_TEST_epoches_7.pth"
    ckpt.save(state, "final")
    ckpt.save(state, "preempt_e3")
    assert ckpt.latest_epoch() == 7
    saved = ckpt.restore(7)
    assert saved["step"] == 2
    # the weights strict-load into a fresh network (reference key names)
    fresh = RefineDet(NUM_CLASSES)
    fresh.load_state_dict(saved["model"], strict=True)
    for k, v in model.net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    for k, v in state.ema.items():
        assert torch.equal(saved["ema"][k], v), k
    bufs = saved["optimizer"]["state"]
    live = state.optimizer.state_dict()["state"]
    assert len(bufs) == len(live) == len(list(model.net.parameters()))
    for i, s in live.items():
        assert torch.equal(bufs[i]["momentum_buffer"], s["momentum_buffer"])


class _Toy:
    """Map-style dataset of n items with i+1 boxes each."""

    def __init__(self, n, bad=False):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((8, 8, 3), float(i), np.float32)
        boxes = np.tile([[0.1, 0.1, 0.5, 1.5 if self.bad else 0.5]],
                        (i + 1, 1)).astype(np.float32)
        return img, boxes, np.full(i + 1, 1, np.int32)


# -- the host data pipeline ---------------------------------------------------

def test_loader_tail_padding_and_epochs_match_jax():
    for n, bs in ((5, 2), (7, 3), (4, 2)):
        ours = DataLoader(_Toy(n), bs, max_boxes=4, num_workers=2,
                          drop_last=False, seed=3)
        theirs = JDataLoader(_Toy(n), bs, max_boxes=4, num_workers=2,
                             drop_last=False, seed=3)
        assert len(ours) == len(theirs) == -(-n // bs)
        for _ in range(2):  # two epochs: the shuffle moves on
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            tail = got[-1]
            real = n - (len(got) - 1) * bs
            assert tail.images.shape[0] == bs
            assert not tail.valid[real:].any() and tail.valid[:real].any()
        assert ours.epoch == theirs.epoch == 2


@pytest.mark.parametrize("seed", range(6))
def test_ssd_augmentation_bit_equal_to_jax(seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)
    boxes = np.array([[10, 12, 60, 70], [40, 30, 110, 85]], np.float32)
    labels = np.array([1, 2], np.int32)
    if seed == 5:  # no GT
        boxes, labels = boxes[:0], labels[:0]
    out = SSDAugmentation(320, (104, 117, 123))(
        img, boxes, labels, np.random.default_rng(seed))
    want = jaug.SSDAugmentation(320, (104, 117, 123))(
        img, boxes, labels, np.random.default_rng(seed))
    for a, b in zip(out, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(BaseTransform(320)(img),
                                  jaug.BaseTransform(320)(img))
