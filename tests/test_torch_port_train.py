"""Port parity: the training slice of ``refinedet_tpu_torch`` (schedule,
optimizer, EMA, the full train step, checkpoints, the Trainer, the host
data pipeline and the train CLI) against the JAX package's, on the CPU.

Tolerances: the lr schedule rtol 1e-6; two optimizer steps rtol 1e-6;
full steps (320, 3 classes, batch 2, ``max_boxes`` 8, f32, constant lr
0.01, global-norm clip 1.0, EMA 0.9): losses rtol 2e-4 and each
parameter's update a relative L2 norm of 2e-2 (the reference-parity
tolerance; oneDNN and XLA sum the convolutions in different orders); a
resumed optimizer step with new hyperparameters, each update a relative
L2 norm of 1e-4 and the momentum buffers rtol 1e-5; the host data
pipeline bit for bit. The augmented step (on-device augmentation from
staging 640, then the same step) against JAX's on JAX's augmented batch:
the augmented images 2e-2 absolute (JAX's own float32 error there), boxes
1e-6, losses rtol 2e-4; the port's augmenting step against
augment-then-step: bitwise.
"""

import importlib.util
import os
import re
import subprocess
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
from refinedet_tpu.models.torch_import import (  # noqa: E402
    load_weights, torch_state_dict_to_flax, torch_state_dict_to_flax_bn)
from refinedet_tpu.train import make_lr_schedule as jschedule  # noqa: E402
from refinedet_tpu.train import make_optimizer as joptimizer  # noqa: E402
from refinedet_tpu.train import make_train_step as jmake_step  # noqa: E402
from refinedet_tpu.train.train_step import TrainState as JState  # noqa: E402
from refinedet_tpu.utils.plot import _LOG_RE  # noqa: E402

from refinedet_tpu_torch.config import MEANS, TrainConfig  # noqa: E402
from refinedet_tpu_torch.data import (BaseTransform,  # noqa: E402
                                      COCODetection, DataLoader,
                                      SSDAugmentation)
from refinedet_tpu_torch.data.augment import (StagingTransform,  # noqa: E402
                                              augment_batch, sample_draws,
                                              step_generator)
from refinedet_tpu_torch.models import (RefineDet,  # noqa: E402
                                        build_refinedet,
                                        state_dict_from_flax)
from refinedet_tpu_torch.train import (CheckpointManager,  # noqa: E402
                                       Trainer, create_train_state,
                                       make_lr_schedule, make_optimizer,
                                       make_train_step)
from refinedet_tpu_torch.train import __main__ as cli  # noqa: E402
from refinedet_tpu_torch.train.train_step import ema_update_  # noqa: E402
from refinedet_tpu_torch.utils.plot import LivePlotter  # noqa: E402

from data_fixtures import make_coco_dataset  # noqa: E402
from test_torch_port_augment import replay, staged_batch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
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


# -- the Trainer, on the tiny COCO set ---------------------------------------

@pytest.fixture(scope="module")
def tiny_coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    make_coco_dataset(root, num_images=4, img_size=96)
    return root


def _trainer(tiny_coco, save, lines, **cfg):
    dataset = COCODetection(tiny_coco, [("sarship", "train")],
                            SSDAugmentation(320, (104, 117, 123)))
    cfg = TrainConfig(**{**dict(batch_size=2, max_boxes=8, lr=1e-4,
                                max_epoch=10, num_workers=0), **cfg})
    model = build_refinedet("train", 320, 2, device="cpu")
    return Trainer(model, dataset, cfg, save_folder=save,
                   log_fn=lines.append)


def test_trainer_logs_checkpoints_and_resumes(tiny_coco, tmp_path):
    """Two steps in the reference's log format; a numbered checkpoint
    that a fresh Trainer resumes with the same step and momentum; and one
    more epoch from the resumed state equal to the live state's."""
    save = str(tmp_path / "w")
    lines = []
    live = _trainer(tiny_coco, save, lines)
    assert live.epoch_size == 2
    state = live.train(max_epochs=1)
    assert state.step == 2 and len(lines) == 2
    iters = []
    for line in lines:
        m = _LOG_RE.search(line)
        assert m and line.startswith("Epoch:1/10 || Epochiter: "), line
        assert re.search(r"Batchtime: [\d.]+ s \|\| ETA: \d+:\d\d:\d\d$",
                         line), line
        iters.append(int(m.group(1)))
        assert np.isfinite(float(m.group(6)))
    assert iters == [1, 2]
    assert os.path.exists(live.ckpt.path("final"))
    live.ckpt.save(state, 1)

    resumed_lines = []
    fresh = _trainer(tiny_coco, save, resumed_lines)
    rstate = fresh.resume(1)
    assert rstate.step == 2
    for (_, a), (_, b) in zip(live.optimizer.state_dict()["state"].items(),
                              fresh.optimizer.state_dict()["state"].items()):
        assert torch.equal(a["momentum_buffer"], b["momentum_buffer"])

    state = live.train(state, start_epoch=1, max_epochs=1)
    rstate = fresh.train(rstate, start_epoch=1, max_epochs=1)
    assert state.step == rstate.step == 4
    assert live.loader.epoch == fresh.loader.epoch == 2
    def upto_time(ls):
        return [line[:line.index("Batchtime")] for line in ls]

    assert upto_time(lines[2:]) == upto_time(resumed_lines)
    assert resumed_lines[0].startswith("Epoch:2/10 || Epochiter: 1/2 || "
                                       "Iter: 3/20 ||")
    for (k, a), b in zip(live.model.net.state_dict().items(),
                         fresh.model.net.state_dict().values()):
        assert torch.equal(a, b), k


def test_trainer_resume_ema_on_off(tiny_coco, tmp_path):
    save = str(tmp_path / "w")
    plain = _trainer(tiny_coco, save, [])
    plain.ckpt.save(plain.init_state(), 10)
    lines = []
    with_ema = _trainer(tiny_coco, save, lines, ema_decay=0.99)
    state = with_ema.resume(10)
    assert "initializing EMA" in lines[-1]
    for n, p in state.net.named_parameters():
        assert torch.equal(state.ema[n], p.detach())
    with_ema.ckpt.save(state, 20)
    lines = []
    state = _trainer(tiny_coco, save, lines).resume(20)
    assert state.ema is None and "dropping it" in lines[-1]


def test_trainer_resume_takes_hyperparameters_from_the_config(tiny_coco,
                                                              tmp_path):
    """A run resumed with another momentum and weight decay steps with the
    new values and the saved momentum buffers, as the JAX Trainer does (its
    optax chain is built from the config; the checkpoint gives the trace).
    Gradients are seeded, so only the optimizer is compared."""
    import optax
    save = str(tmp_path / "w")
    hyper = dict(lr=0.1, warmup_epochs=0)
    old = _trainer(tiny_coco, save, [], **hyper)
    new = _trainer(tiny_coco, save, [], momentum=0.5, weight_decay=1e-2,
                   **hyper)
    params = [p.detach().numpy().copy() for p in old.model.net.parameters()]
    rng = np.random.RandomState(0)
    grads = [[(rng.randn(*p.shape) * 1e-2).astype(np.float32)
              for p in params] for _ in range(2)]

    state = old.init_state()
    for p, g in zip(old.model.net.parameters(), grads[0]):
        p.grad = torch.from_numpy(g.copy())
    old.optimizer.apply_gradients(0)
    state.step = 1
    old.ckpt.save(state, 10)
    assert new.resume(10).step == 1
    for p, g in zip(new.model.net.parameters(), grads[1]):
        p.grad = torch.from_numpy(g.copy())
    new.optimizer.apply_gradients(1)

    jparams = [jnp.asarray(p) for p in params]
    tx_old = joptimizer(lambda t: 0.1)
    up, s_old = tx_old.update([jnp.asarray(g) for g in grads[0]],
                              tx_old.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, up)
    tx_new = joptimizer(lambda t: 0.1, momentum=0.5, weight_decay=1e-2)
    trace = next(s for s in s_old if isinstance(s, optax.TraceState))
    s_new = tuple(trace if isinstance(s, optax.TraceState) else s
                  for s in tx_new.init(jparams))
    up, s_new = tx_new.update([jnp.asarray(g) for g in grads[1]], s_new,
                              jparams)
    jparams = optax.apply_updates(jparams, up)
    jtrace = next(s for s in s_new if isinstance(s, optax.TraceState)).trace

    for group in new.optimizer.param_groups:
        assert group["momentum"] == 0.5 and group["weight_decay"] == 1e-2
    bufs = new.optimizer.state_dict()["state"]
    for i, (p, p0, jp) in enumerate(zip(new.model.net.parameters(), params,
                                        jparams)):
        d_our = p.detach().numpy() - p0
        d_ref = np.asarray(jp) - p0
        rel = np.linalg.norm(d_our - d_ref) / np.linalg.norm(d_ref)
        assert rel < 1e-4, (i, rel)
        np.testing.assert_allclose(bufs[i]["momentum_buffer"].numpy(),
                                   np.asarray(jtrace[i]), rtol=1e-5,
                                   atol=1e-8, err_msg=str(i))


def test_trainer_preemption_checkpoints_and_returns(tiny_coco, tmp_path):
    save = str(tmp_path / "w")
    trainer = _trainer(tiny_coco, save, [])
    real_step = trainer.train_step

    def step_then_preempt(*a):
        out = real_step(*a)
        os.kill(os.getpid(), __import__("signal").SIGTERM)  # in-process
        return out

    trainer.train_step = step_then_preempt
    state = trainer.train()
    assert state.step == 1
    assert os.path.exists(trainer.ckpt.path("preempt_e1"))
    assert not os.path.exists(trainer.ckpt.path("final"))
    assert trainer.ckpt.restore("preempt_e1")["step"] == 1


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


def test_trainer_target_guard(tmp_path):
    model = build_refinedet("train", 320, 2, device="cpu")
    trainer = Trainer(model, _Toy(4, bad=True),
                      TrainConfig(batch_size=2, num_workers=0, max_epoch=1))
    with pytest.raises(ValueError, match=r"outside \[0, 1\]"):
        trainer.train()


class _Staged(_Toy):
    """_Toy's boxes in pixels of a uint8 8x8 canvas, as StagingTransform
    stages them."""

    def __getitem__(self, i):
        img, boxes, labels = super().__getitem__(i)
        return img.astype(np.uint8), boxes * 8.0, labels


def test_trainer_cadence_and_unported_options(tmp_path):
    model = build_refinedet("train", 320, 2, device="cpu")
    trainer = Trainer(model, _Toy(4), TrainConfig(batch_size=2, num_workers=0),
                      save_folder=str(tmp_path))
    saved = []
    trainer.ckpt.save = lambda state, tag: saved.append(tag)
    for epoch in range(0, 221):
        trainer._maybe_checkpoint(None, epoch)
    assert saved == [10 * k for k in range(1, 21)] + [205, 210, 215, 220]
    # Spatial sharding needs a grid of ranks: one process is refused with
    # the JAX Trainer's error.
    with pytest.raises(ValueError, match=r"^1 devices not divisible by "
                       r"spatial_shards=2$"):
        Trainer(model, _Toy(4), TrainConfig(spatial_shards=2))
    # On-device augmentation is taken: the target guard is skipped
    # (staging pixels are not in [0, 1]) and uint8 stays uint8.
    staged = Trainer(model, _Staged(4), TrainConfig(
        batch_size=2, num_workers=0, on_device_augment=True))
    batches = [sb.wait() for sb in staged.loader]
    assert len(batches) == 2
    assert all(b.images.dtype == torch.uint8 for b in batches)
    assert float(batches[0].boxes.max()) > 1
    with pytest.raises(ValueError, match=r"outside \[0, 1\]"):
        next(iter(Trainer(model, _Staged(4), TrainConfig(
            batch_size=2, num_workers=0)).loader))


def test_trainer_feeds_the_live_plotter(tmp_path):
    """Two epochs of three steps, the step replaced (nothing trains): the
    plotter gets every step's losses and each epoch's end, and renders
    live_loss.png."""
    import dataclasses
    plotter = LivePlotter(str(tmp_path), render_every=4)
    trainer = Trainer(build_refinedet("train", 320, 2, device="cpu"),
                      _Toy(6), TrainConfig(batch_size=2, num_workers=0,
                                           max_epoch=2),
                      log_fn=lambda line: None, live_plotter=plotter)
    keys = ("loss", "arm_loss_l", "arm_loss_c", "odm_loss_l", "odm_loss_c")

    def fake_step(state, *batch):
        value = torch.tensor(1.0 / (state.step + 1))
        return (dataclasses.replace(state, step=state.step + 1),
                {k: value for k in keys})

    trainer.train_step = fake_step
    trainer.train()
    assert plotter.iters == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose(plotter.series["loss"],
                               [1 / (i + 1) for i in range(6)], rtol=1e-6)
    assert plotter.epochs == [1, 2]
    np.testing.assert_allclose(plotter.epoch_series["loss"],
                               [(1 + 1 / 2 + 1 / 3) / 3,
                                (1 / 4 + 1 / 5 + 1 / 6) / 3], rtol=1e-6)
    if importlib.util.find_spec("matplotlib") is not None:
        assert (tmp_path / "live_loss.png").stat().st_size > 0


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


# -- the CLI ------------------------------------------------------------------

def test_cli_trains_and_resumes_on_cpu(tiny_coco, tmp_path):
    """One step, then one more epoch resumed from the final checkpoint."""
    save = tmp_path / "w"
    cmd = [sys.executable, "-m", "refinedet_tpu_torch.train", "--device",
           "cpu", "--dataset", "COCO", "--dataset_root", tiny_coco,
           "--input_size", "320", "--batch_size", "4", "--num_workers", "0",
           "--lr", "1e-5", "--dtype", "float32", "--save_folder", str(save)]
    env = dict(os.environ, PYTHONPATH=str(REPO))

    def run(*extra):
        done = subprocess.run(cmd + list(extra), cwd=str(REPO), env=env,
                              capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-3000:]
        log = (save / "log.txt").read_text()
        return log, [m for m in map(_LOG_RE.search, log.splitlines()) if m]

    log, hits = run("--max_epoch", "1")
    assert [int(m.group(1)) for m in hits] == [1]
    assert "Epoch:1/1 || Epochiter: 1/1 || Iter: 1/1 ||" in log
    final = save / "RefineDet320_COCO_epoches_final.pth"
    assert final.exists()
    if importlib.util.find_spec("matplotlib") is not None:
        assert (save / "loss_curve.png").stat().st_size > 0
    log, hits = run("--max_epoch", "2", "--resume", str(final))
    assert "resumed from" in log and "(epoch 1)" in log
    assert [int(m.group(1)) for m in hits] == [2]
    assert "Epoch:2/2 || Epochiter: 1/1 || Iter: 2/2 ||" in log
    assert torch.load(str(final), weights_only=True)["step"] == 2


@pytest.mark.parametrize("flags", [["--spatial_shards", "2", "--ngpu", "1"],
                                   ["--spatial_shards", "3", "--ngpu", "2"]])
def test_cli_refuses_unported_flags(flags, tmp_path):
    """``--spatial_shards`` is ported; a grid the ranks do not fill is
    refused with the JAX Trainer's error, before anything is written or
    spawned."""
    shards, devices = flags[1], flags[3]
    with pytest.raises(ValueError, match=rf"^{devices} devices not "
                       rf"divisible by spatial_shards={shards}$"):
        cli.main(flags + ["--device", "cpu", "--save_folder",
                          str(tmp_path)])
    assert not os.listdir(tmp_path)  # refused before anything was written


@pytest.mark.parametrize("flags,staging,live", [
    (["--on_device_augment"], 1024, False),
    (["--staging_size", "640"], 640, False),
    (["--visdom"], None, True)],
    ids=["on_device_augment", "staging_size", "visdom"])
def test_cli_takes_up_augment_and_plot_flags(flags, staging, live, tiny_coco,
                                             tmp_path, monkeypatch):
    """``--on_device_augment`` stages at twice the input size (512 by
    default), ``--staging_size`` at its own and turns the on-device
    augmentation on; either sets ``TrainConfig.on_device_augment`` and the
    dataset's mean. ``--visdom`` hands a LivePlotter to the Trainer
    (whose ``train`` is replaced: nothing trains)."""
    handed = []
    monkeypatch.setattr(Trainer, "train",
                        lambda self, state, start_epoch: handed.append(self))
    cli.main(flags + ["--device", "cpu", "--dataset_root", tiny_coco,
                      "--num_workers", "0", "--save_folder", str(tmp_path)])
    (trainer,) = handed
    transform = trainer.dataset.transform
    if staging is None:
        assert isinstance(transform, SSDAugmentation)
    else:
        assert isinstance(transform, StagingTransform)
        assert transform.size == staging
    assert trainer.cfg.on_device_augment == (staging is not None)
    assert trainer.cfg.mean == tuple(MEANS)
    assert isinstance(trainer.live_plotter, LivePlotter) == live
    if live:
        assert trainer.live_plotter.out_dir == str(tmp_path)


@pytest.mark.parametrize("flags,size,use_bn", [
    (["--bn"], 512, True), (["--input_size", "896"], 896, False)],
    ids=["bn", "896"])
def test_cli_builds_bn_and_896(flags, size, use_bn, tiny_coco, tmp_path,
                               monkeypatch):
    """``--bn`` and ``--input_size 896`` build that model and hand it to
    the Trainer (whose ``train`` is replaced: nothing trains)."""
    handed = []
    monkeypatch.setattr(Trainer, "train",
                        lambda self, state, start_epoch: handed.append(
                            (self.model, state, start_epoch)))
    cli.main(flags + ["--device", "cpu", "--dataset_root", tiny_coco,
                      "--num_workers", "0", "--save_folder", str(tmp_path)])
    (model, state, start), = handed
    assert (model.size, model.use_bn, model.net.use_bn) == (size, use_bn,
                                                           use_bn)
    assert model.phase == "train" and state is None and start == 0
    assert len(model.priors) == {512: 16320, 896: 200508}[size]
    bns = [m for m in model.net.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == (17 if use_bn else 0)


def test_cli_needs_card_unless_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--save_folder", str(tmp_path)])


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
def test_basenet_loads_into_vgg_strictly(use_bn, tmp_path):
    """``--basenet`` loads as the JAX package's ``load_weights`` does, into
    either variant: a ``vgg16_reducedfc`` file (``module.`` keys) gives
    the trunk, a full plain RefineDet ``.pth`` every layer the JAX
    importer reads; a file JAX cannot load raises."""
    src = RefineDet(2)
    src.reset_parameters(torch.Generator().manual_seed(5))
    files = {"vgg": {"module." + k: v
                     for k, v in src.vgg.state_dict().items()},
             "full": {"state_dict": src.state_dict()}}
    for name, obj in files.items():
        net = RefineDet(2, use_bn=use_bn)
        net.reset_parameters(torch.Generator().manual_seed(6))
        sd0 = {k: v.clone() for k, v in net.state_dict().items()}
        if use_bn:
            variables = torch_state_dict_to_flax_bn(sd0)
        else:
            variables = {"params": torch_state_dict_to_flax(sd0)}
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        cli.load_basenet(net, path)
        want = state_dict_from_flax({
            **variables, "params": load_weights(variables["params"], path)})
        got = net.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)
        assert torch.equal(got["vgg.0.weight"], src.vgg[0].weight)
        # (biases start at 0 and the L2Norm scales at 10/8 in both nets)
        changed = [k for k in got if not torch.equal(got[k], sd0[k])]
        assert len(changed) == {"vgg": 15, "full": 48}[name]
    path = str(tmp_path / "broken.pth")
    torch.save({"0.weight": src.vgg[0].weight}, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        cli.load_basenet(net, path)
    with pytest.raises(KeyError):
        load_weights(variables["params"], path)
