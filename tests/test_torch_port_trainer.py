"""Port parity: the Trainer, the train CLI and ``--basenet`` of
``refinedet_tpu_torch`` against the JAX package's, on the CPU.

The Trainer runs on a tiny COCO set (4 images of 96 px, RefineDet320, 2
classes, batch 2): the reference's log lines, checkpoints, resume (the
same step, momentum buffers and next epoch, bitwise), the EMA switched on
and off across a resume, preemption, the checkpoint cadence and the live
plotter. A resume with new momentum and weight decay steps as JAX's optax
chain does: each update a relative L2 norm of 1e-4, the momentum buffers
rtol 1e-5. The CLI trains one step and resumes in a subprocess, and takes
up its flags; ``--basenet`` loads as JAX's ``load_weights`` does, bitwise.
The train step itself is held against JAX's in
``tests/test_torch_port_train.py``.
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

import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.models.torch_import import (  # noqa: E402
    load_weights, torch_state_dict_to_flax, torch_state_dict_to_flax_bn)
from refinedet_tpu.train import make_optimizer as joptimizer  # noqa: E402
from refinedet_tpu.utils.plot import _LOG_RE  # noqa: E402

from refinedet_tpu_torch.config import MEANS, TrainConfig  # noqa: E402
from refinedet_tpu_torch.data import (COCODetection,  # noqa: E402
                                      SSDAugmentation)
from refinedet_tpu_torch.data.augment import StagingTransform  # noqa: E402
from refinedet_tpu_torch.models import (RefineDet,  # noqa: E402
                                        build_refinedet,
                                        state_dict_from_flax)
from refinedet_tpu_torch.train import Trainer  # noqa: E402
from refinedet_tpu_torch.train import __main__ as cli  # noqa: E402
from refinedet_tpu_torch.utils.plot import LivePlotter  # noqa: E402

from data_fixtures import make_coco_dataset  # noqa: E402
from test_torch_port_train import _Toy  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


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
