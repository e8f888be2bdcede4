"""Port parity: data parallelism (``refinedet_tpu_torch/parallel``, the
data-parallel train step, the Trainer's resume, the loader's shards, the
multi-rank Evaluator and the train CLI's ``--ngpu``) and spatial sharding
(``--spatial_shards``: the rank grid, the plan, the halo exchanges and
the S = 2 step) on the CPU.

Two checks of two gloo ranks and their reference processes (no process
group, each global batch whole) are spawned once for the module by
``refinedet_tpu_torch/tools/ddp_check.py``, at one torch thread each,
beside the train CLI's ``--ngpu 2`` run, while JAX jit-inits and
compiles its 2-device mesh step in this process. Tolerances:

  * plain RefineDet320 (21 classes), global batch 4 = 2 ranks x 2 rows,
    lr 1e-5, global-norm clip 5, 3 steps: the ranks' states bitwise
    equal; losses rtol 1e-5 of one process on the whole batch; the
    parameters within the limits of
    ``tests/test_distributed_multiprocess.py`` (each tensor's sum within
    1e-6 of its absolute sum floored at 1, its first 8 elements 1e-5);
    each update a relative L2 norm of 2e-2, read from the momentum
    buffer (the update over -lr, in full precision: an update 1e-7 the
    size of its weight is not, once added to it);
  * the first step against JAX's ``make_train_step(..., mesh=
    make_mesh(2))`` from JAX's init: ``test_torch_port_train.py``'s
    single-device parity, losses rtol 2e-4, each update (against JAX's
    momentum trace) 2e-2;
  * RefineDet320-BN in float64, one row a rank, rank 1's without a GT box
    (its N is 0), no clip, one step: the ranks bitwise equal; running
    statistics and updates 1e-9 relative of one process's (the conv
    biases that feed a BN left out: their gradient is zero; the two
    L2Norm scales, which compute in float32, 1e-6); losses (float32
    heads) rtol 1e-5;
  * the 2-rank Evaluator at 2 images a rank against one process at batch
    2: ``all_boxes`` exactly equal;
  * after ``Trainer.load_state`` of a checkpoint, rank 1's copy stale,
    both ranks hold rank 0's state bitwise;
  * spatial sharding, the same two ranks as one data group of S = 2 space
    ranks, each holding a band of 160 rows: the plain steps
    (``plain_spatial``) and the BN float64 step (``bn_spatial``) held to
    the limits above against the same reference processes, and the first
    plain step against JAX's mesh step (JAX's own
    ``tests/test_sharding.py`` holds its data x space step equal to that
    step); the collectives and their gradients against the unsharded ops
    in float64 to 1e-12 (the halo convolution under bf16 autocast to
    2e-2); the Trainer at S = 2 trains two steps and its
    ``final`` checkpoint resumes alike on both ranks.
"""

import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from refinedet_tpu.data.loader import DataLoader as JDataLoader  # noqa: E402
from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.parallel import make_mesh  # noqa: E402
from refinedet_tpu.train import make_optimizer as joptimizer  # noqa: E402
from refinedet_tpu.train import make_train_step as jmake_step  # noqa: E402
from refinedet_tpu.train.train_step import TrainState as JState  # noqa: E402
from refinedet_tpu.utils.plot import _LOG_RE  # noqa: E402

from refinedet_tpu_torch.data import DataLoader  # noqa: E402
from refinedet_tpu_torch.models import (RefineDet,  # noqa: E402
                                        state_dict_from_flax)
from refinedet_tpu_torch.parallel import (distributed,  # noqa: E402
                                          shard_batch)
from refinedet_tpu_torch.parallel.mesh import (  # noqa: E402
    check_grid, grid_position, image_band)
from refinedet_tpu_torch.parallel.spatial import spatial_plan  # noqa: E402
from refinedet_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from refinedet_tpu_torch.tools import ddp_check  # noqa: E402
from refinedet_tpu_torch.tools.train_check import (  # noqa: E402
    biases_before_bn, update_rel_errors)

from data_fixtures import make_coco_dataset  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SIZE, CLASSES, BATCH, LR, CLIP = 320, 21, 4, 1e-5, 5.0
LOSS_KEYS = ("loss", "arm_loss_l", "arm_loss_c", "odm_loss_l",
             "odm_loss_c")


def _jobs(init: str, ckpt: str):
    """Two checks, each (the ranks' jobs, the reference processes' jobs):
    the plain steps from JAX's init and the resume need JAX first; the
    rest can start at once."""
    plain = dict(kind="steps", name="plain", size=SIZE, classes=CLASSES,
                 batch=BATCH, steps=3, lr=LR, clip=CLIP, init=init,
                 save=(1, 3))
    resume = dict(kind="resume", name="resume", size=SIZE, classes=CLASSES,
                  checkpoint=ckpt)
    # one row a rank, rank 1's without a GT box, no clip
    bn = dict(kind="steps", name="bn", size=SIZE, classes=CLASSES, bn=True,
              dtype="float64", batch=2, steps=1, lr=LR, data_seed=11,
              empty_rows=(1,), save=(1,))
    evals = dict(kind="eval", name="eval", size=SIZE, images=8,
                 rank_batch=2, nms_top_k=50, data_seed=3)
    # the same global batches, one data group of two space ranks
    plain_spatial = {**plain, "name": "plain_spatial", "spatial_shards": 2}
    bn_spatial = {**bn, "name": "bn_spatial", "spatial_shards": 2}
    ops = dict(kind="spatial_ops", name="spatial_ops")
    trainer = dict(kind="trainer", name="trainer", size=SIZE, classes=2,
                   batch=2, steps=2, lr=LR, clip=CLIP, spatial_shards=2,
                   checkpoint=ckpt + "_trainer")
    return (([{**plain, "checkpoint": ckpt}, resume, plain_spatial],
             [[plain]]),
            ([bn, evals, ops, bn_spatial, trainer], [[evals], [bn]]))


def _cli(save: Path, root: str):
    cmd = [sys.executable, "-m", "refinedet_tpu_torch.train", "--device",
           "cpu", "--ngpu", "2", "--dataset", "COCO", "--dataset_root", root,
           "--input_size", "320", "--batch_size", "2", "--num_workers", "0",
           "--lr", "1e-5", "--dtype", "float32", "--max_epoch", "1",
           "--save_folder", str(save)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=600)


# -- fixtures: the spawned ranks with JAX's init, JAX's mesh step -------------

class Spawned:
    """The checks' processes and the CLI's run, started; JAX's
    RefineDet320, its PRNGKey(0) params and the same weights as a port
    state_dict file (through ``state_dict_from_flax``)."""

    def __init__(self, checks, thread, save, runs, jax_init):
        self.checks, self.thread, self.save, self.runs = \
            checks, thread, save, runs
        self.jmodel, self.params0, self.init = jax_init
        self._results = None

    def results(self):
        """Every process's results, job name -> result, merged by process
        name (rank0, rank1, reference0, ...)."""
        if self._results is None:
            merged = {}
            for check in self.checks:
                for name, jobs in check.results().items():
                    merged.setdefault(name, {}).update(jobs)
            self._results = merged
        return self._results

    def reference(self, job):
        return next(r[job] for name, r in self.results().items()
                    if name.startswith("reference") and job in r)

    def cli(self):
        self.thread.join(timeout=1200)
        assert not self.thread.is_alive(), "the CLI runs did not end"
        return self.save, self.runs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    (a_ranks, a_refs), (b_ranks, b_refs) = _jobs(
        str(out / "jax_init.pth"), str(out / "ckpt"))
    (out / "b").mkdir()
    checks = [ddp_check.start(2, b_ranks, b_refs, str(out / "b"))]

    root = str(tmp_path_factory.mktemp("coco"))
    make_coco_dataset(root, num_images=4, img_size=96)
    save, runs = out / "cli", []
    thread = threading.Thread(target=lambda: runs.append(_cli(save, root)))
    thread.start()

    jmodel = jbuild("train", SIZE, CLASSES)
    params0 = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0))["params"])
    torch.save(state_dict_from_flax(params0), str(out / "jax_init.pth"))
    (out / "a").mkdir()
    checks.append(ddp_check.start(2, a_ranks, a_refs, str(out / "a")))
    handles = Spawned(checks, thread, save, runs,
                      (jmodel, params0, str(out / "jax_init.pth")))
    yield handles
    thread.join(timeout=1200)
    handles.results()  # every process ends before its files go
    shutil.rmtree(out)  # ~2 GB of checkpoints, weights and results


@pytest.fixture(scope="module")
def jax_mesh_step(spawned):
    """JAX's first step on a 2-device ``data`` mesh: its metrics, and its
    momentum trace (the update over -lr) as a port state_dict."""
    import optax
    params0 = spawned.params0
    tx = joptimizer(lambda t: LR, grad_clip_norm=CLIP)
    step = jmake_step(spawned.jmodel, tx, JTrainConfig(
        batch_size=BATCH, max_boxes=8), make_mesh(2))
    state = JState(step=jnp.zeros((), jnp.int32), params=params0,
                   opt_state=tx.init(params0), batch_stats=None,
                   ema_params=None)
    batch = ddp_check.global_batch(0, BATCH, SIZE, CLASSES)
    state, metrics = step(state, *(jnp.asarray(a) for a in batch))
    trace, = [s.trace for s in state.opt_state
              if isinstance(s, optax.TraceState)]
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_flax(jax.tree.map(np.asarray, trace)))


def _losses_close(got, want, rtol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def _params_close(got, want):
    """JAX's multi-process limits (``tests/test_distributed_multiprocess.py``)
    on each parameter's summaries: its sum within 1e-6 of its absolute
    sum floored at 1, its first 8 elements within 1e-5."""
    sums, heads = ddp_check.summary_errors(got, want)
    assert sums <= 1e-6 and heads <= 1e-5, (sums, heads)


def _updates_close(got, want, rtol, skip=()):
    """Each update (the momentum buffer after the step) within ``rtol``
    relative L2."""
    rel = update_rel_errors(got, {k: v for k, v in want.items()
                                  if k not in skip})
    worst = max(rel, key=rel.get)
    assert len(rel) > 50 and rel[worst] <= rtol, (worst, rel[worst])


# -- 1. the loader's shards ---------------------------------------------------

@pytest.mark.parametrize("num_shards", [2, 3])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_shards_match_jax(num_shards, seed, epoch, drop_last):
    """Every shard's indices and length equal the JAX loader's: one
    shuffle of (seed, epoch), contiguous slices of len // num_shards."""
    data = list(range(23))
    seen = []
    for shard in range(num_shards):
        kw = dict(batch_size=3, num_workers=1, seed=seed, shard_id=shard,
                  num_shards=num_shards, drop_last=drop_last)
        mine, theirs = DataLoader(data, **kw), JDataLoader(data, **kw)
        mine.epoch = theirs.epoch = epoch
        idx = mine._epoch_indices()
        np.testing.assert_array_equal(idx, theirs._epoch_indices())
        assert len(mine) == len(theirs)
        seen += idx.tolist()
    assert len(seen) == len(set(seen)) == 23 // num_shards * num_shards


def test_shard_batch_takes_contiguous_rows():
    batch = ddp_check.global_batch(0, 6, 32, 3)
    for rank in range(3):
        part = shard_batch(batch, rank, 3)
        assert type(part) is type(batch)
        for a, b in zip(part, batch):
            np.testing.assert_array_equal(a, b[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError, match="divide"):
        shard_batch(batch, 0, 4)


def test_single_process_runtime(monkeypatch):
    """No launcher, no arguments: no process group, rank 0 of 1; the CPU
    only when asked for, and no card invented."""
    for k in distributed.RENDEZVOUS_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not distributed.maybe_initialize()
    assert (distributed.process_index(), distributed.process_count()) == \
        (0, 1)
    assert distributed.default_group() is None
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        distributed.local_device("cuda")


# -- 2-5. the train step ------------------------------------------------------

def test_first_step_matches_jax_mesh(spawned, jax_mesh_step, job="plain"):
    """The ranks' first step against JAX's on a 2-device mesh, from JAX's
    init (the fixture starts the ranks before JAX compiles)."""
    want, want_update = jax_mesh_step
    got = spawned.results()["rank0"][job]
    _losses_close(got["metrics"][0], {k: want[k] for k in LOSS_KEYS}, 2e-4)
    for k in ("num_pos_arm", "num_pos_odm"):
        assert got["metrics"][0][k] == want[k]
    _updates_close(got["saved"][1]["momentum"], want_update, 2e-2)


@pytest.mark.parametrize("job", ["plain", "bn", "plain_spatial",
                                 "bn_spatial"])
def test_ranks_stay_bitwise_equal(spawned, job):
    """The all-reduced gradients, the clip, SGD and the synced BN give
    every rank the same weights, momentum and running statistics, and
    the same (global) metrics."""
    results = spawned.results()
    assert results["rank0"][job]["digest"] == results["rank1"][job]["digest"]
    assert results["rank0"][job]["metrics"] == \
        results["rank1"][job]["metrics"]


def test_plain_steps_match_one_process(spawned, job="plain"):
    got, want = spawned.results()["rank0"][job], \
        spawned.reference("plain")
    assert len(got["metrics"]) == 3
    for g, w in zip(got["metrics"], want["metrics"]):
        _losses_close(g, w, 1e-5)
        assert g["num_pos_odm"] == w["num_pos_odm"] > 0
    _params_close(got["saved"][3]["params"], want["saved"][3]["params"])
    _updates_close(got["saved"][3]["momentum"], want["saved"][3]["momentum"],
                   2e-2)


def _bn_updates(spawned, job="bn"):
    """The float64 BN step's updates, rank 0's and one process's, and the
    names held to 1e-9: all but the conv biases that feed a BN (zero
    gradient) and the L2Norm scales (computed in float32, as JAX's)."""
    got, want = spawned.results()["rank0"][job], spawned.reference("bn")
    g, w = got["saved"][1]["momentum"], want["saved"][1]["momentum"]
    with torch.device("meta"):  # the layout, no weights
        skip = biases_before_bn(RefineDet(CLASSES, SIZE, use_bn=True))
    l2 = {k for k in w if "L2Norm" in k}
    assert skip and len(l2) == 2
    return g, w, set(w) - skip - l2, l2


def test_unequal_positives_use_the_global_n(spawned):
    """One row a rank (RefineDet320-BN, float64, no clip), rank 1's
    without a GT box: its N is 0. The global N keeps the losses and the
    update equal to one process's, where a per-rank N under DDP's mean
    halves the update (no clip here to hide it)."""
    got, want = spawned.results()["rank0"]["bn"], spawned.reference("bn")
    assert 0 < want["metrics"][0]["num_pos_odm"] == \
        got["metrics"][0]["num_pos_odm"]
    _losses_close(got["metrics"][0], want["metrics"][0], 1e-5)
    g, w, exact, _ = _bn_updates(spawned)
    _updates_close(g, {k: w[k] for k in exact}, 1e-9)


def test_bn_float64_step_matches_one_process(spawned, job="bn"):
    """Synced batch statistics: the running mean and variance of
    RefineDet320-BN equal one process's in float64 to 1e-9, and the
    float32 L2Norm scales' updates to 1e-6."""
    got, want = spawned.results()["rank0"][job], spawned.reference("bn")
    g, w = got["saved"][1]["buffers"], want["saved"][1]["buffers"]
    stats = [k for k in w if ".running_" in k]
    assert len(stats) == 2 * 17
    for k in stats:
        assert float((g[k] - w[k]).abs().max()) <= \
            1e-9 * float(w[k].abs().max()), k
    g, w, exact, l2 = _bn_updates(spawned, job)
    rel = update_rel_errors(g, {k: w[k] for k in l2})
    assert max(rel.values()) <= 1e-6, rel
    if job == "bn_spatial":  # the unequal-positives test covers "bn"'s
        _losses_close(got["metrics"][0], want["metrics"][0], 1e-5)
        _updates_close(g, {k: w[k] for k in exact}, 1e-9)


# -- 6. eval, resume, the CLI ------------------------------------------------

def test_evaluator_two_ranks_equal_one(spawned):
    results = spawned.results()
    got = results["rank0"]["eval"]["all_boxes"]
    want = spawned.reference("eval")["all_boxes"]
    assert results["rank1"]["eval"]["all_boxes"] is None
    assert len(got) == len(want) == CLASSES
    assert sum(len(r) for cls in want[1:] for r in cls) > 0
    for cls_got, cls_want in zip(got, want):
        assert len(cls_got) == len(cls_want) == 8
        for a, b in zip(cls_got, cls_want):
            np.testing.assert_array_equal(a, b)


def test_resume_takes_rank0s_state(spawned):
    """Each rank loads the checkpoint, rank 1 a stale copy: after
    ``Trainer.load_state`` both hold rank 0's weights and momentum."""
    results = spawned.results()
    r0, r1 = results["rank0"]["resume"], results["rank1"]["resume"]
    assert r0 == r1 and r0["step"] == 3
    assert r0["digest"] == results["rank0"]["plain"]["digest"]


def test_cli_ngpu2_trains(spawned):
    """``--device cpu --ngpu 2``: two gloo ranks, 4 images at global
    batch 2, so two steps of one row a rank; rank 0 alone logs and
    writes the checkpoint."""
    save, (run,) = spawned.cli()
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("Training RefineDet320") == 1
    assert "cpu, 2 rank(s))" in run.stdout
    assert run.stdout.count("Iter: ") == 2
    log = (save / "log.txt").read_text()
    assert "Epoch:1/1 || Epochiter: 2/2 || Iter: 2/2 ||" in log
    assert [int(m.group(1)) for m in map(_LOG_RE.search, log.splitlines())
            if m] == [1, 2]
    assert set(os.listdir(save)) - {"loss_curve.png"} == {
        "RefineDet320_COCO_epoches_final.pth", "log.txt"}
    assert torch.load(str(save / "RefineDet320_COCO_epoches_final.pth"),
                      weights_only=True)["step"] == 2


# -- 7. spatial sharding -----------------------------------------------------

@pytest.mark.parametrize("size,shards,levels,gather_at", [
    (320, 2, (True, True, True, False), "extras.1"),   # 5-row extra level
    (320, 4, (True, True, False, False), "vgg.30"),    # pool5, 5-row bands
    (512, 2, (True,) * 4, None),
    (512, 4, (True,) * 4, None),
    (896, 2, (True,) * 5, None),
    (896, 4, (True,) * 4 + (False,), "extras.1")])     # 7-row bands
def test_spatial_plan(size, shards, levels, gather_at):
    """Where each net gathers: a stride-2 layer whose band starts on an
    odd row (or a band thinner than its halo) runs replicated with all of
    the trunk after it; the heads and TCB of the levels it feeds with it,
    and the deconv that climbs from a replicated level into a sharded one
    takes its band."""
    plan = spatial_plan(size, shards)
    heights = {320: (40, 20, 10, 5), 512: (64, 32, 16, 8),
               896: (224, 112, 56, 28, 14)}[size]
    assert (plan.levels, plan.heights, plan.gather_at) == \
        (levels, heights, gather_at)
    layers = plan.layers
    assert [n for n, lay in layers.items() if lay.gather] == \
        ([gather_at] if gather_at else [])
    sharded = [i for i, on in enumerate(levels) if on]
    assert [n for n, lay in layers.items() if lay.take] == [
        f"tcb1.{i}" for i in sharded if i + 1 < len(levels)
        and not levels[i + 1]]
    # halos: 1 row for 3x3 convs, 3 for conv6 (dilation 3), one row above
    # for the stride-2 extra; none for pools, 1x1 convs and the deconvs
    assert layers["vgg.0"] == (True, (1, 1), False, False)
    assert layers["vgg.4"] == (True, (0, 0), False, False)   # pool1
    conv6, conv7 = layers["vgg.31"], layers["vgg.33"]
    assert conv6.halo == ((3, 3) if conv6.sharded else (0, 0))
    assert conv7.halo == (0, 0)
    if gather_at is None:
        assert layers["extras.1"].halo == (1, 0)
    for i, on in enumerate(levels):
        assert layers[f"odm_conf.{i}"].sharded == layers[f"tcb0.{3 * i}"] \
            .sharded == on
    # the BN variant: the same places under its own indices
    bn = spatial_plan(size, shards, use_bn=True)
    assert (bn.levels, bn.heights) == (levels, heights)
    assert bn.gather_at == {None: None, "extras.1": "extras.3",
                            "vgg.30": "vgg.43"}[gather_at]


def test_spatial_first_step_matches_jax_mesh(spawned, jax_mesh_step):
    """S = 2 (each rank a band of 160 rows) against JAX's data-mesh step,
    which JAX's ``tests/test_sharding.py`` holds equal to its
    data x space step."""
    test_first_step_matches_jax_mesh(spawned, jax_mesh_step,
                                     "plain_spatial")


def test_spatial_plain_steps_match_one_process(spawned):
    """Three S = 2 steps against one process on the whole batch; at 320
    the extra level (5 rows) runs replicated on both ranks."""
    test_plain_steps_match_one_process(spawned, "plain_spatial")


def test_spatial_bn_float64_step_matches_one_process(spawned):
    """The BN step at S = 2: the statistics count each row once, over
    both ranks' bands at a sharded level and over the data group alone at
    the replicated one (``extras.4``); losses and updates as ``bn``'s."""
    test_bn_float64_step_matches_one_process(spawned, "bn_spatial")


def test_spatial_plan_refuses_uneven_images():
    with pytest.raises(ValueError, match="320 does not split into 3 bands"):
        spatial_plan(320, 3)


def test_rank_grid_matches_jax_mesh():
    """Rank r at (r // S, r % S): JAX's ``devices.reshape(W // S, S)``;
    JAX's errors for a grid the ranks do not fill."""
    grid = np.arange(8).reshape(4, 2)
    for r in range(8):
        d, k = grid_position(r, 2)
        assert grid[d, k] == r
    images = np.arange(2 * 8 * 3 * 1).reshape(2, 8, 3, 1)
    np.testing.assert_array_equal(image_band(images, 1, 2), images[:, 4:])
    check_grid(8, 2, 4)
    with pytest.raises(ValueError, match=r"^6 devices not divisible by "
                       r"spatial_shards=4$"):
        check_grid(6, 4)
    with pytest.raises(ValueError, match=r"^batch_size 6 not divisible by "
                       r"4 data-parallel devices$"):
        check_grid(8, 2, 6)


def test_trainer_shards_the_data_by_data_index(monkeypatch):
    """Under S = 2 the Trainer's loader shards by data index: the two
    space ranks of a data group load the same rows, the data groups the
    JAX loader's shards, ``batch_size // (W // S)`` rows a step."""
    from refinedet_tpu_torch.config import TrainConfig
    from refinedet_tpu_torch.models import build_refinedet
    model = build_refinedet("train", SIZE, 2, device="cpu")
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(trainer_mod, "make_train_step", lambda *a: None)
    data = list(range(23))
    seen = {}
    for rank in range(4):
        monkeypatch.setattr(distributed, "process_index", lambda: rank)
        trainer = trainer_mod.Trainer(
            model, data, TrainConfig(batch_size=6, num_workers=0,
                                     spatial_shards=2))
        loader = trainer.loader
        assert (loader.batch_size, loader.shard_id, loader.num_shards) == \
            (3, rank // 2, 2)
        seen[rank] = loader._epoch_indices().tolist()
        want = JDataLoader(data, batch_size=3, num_workers=1, seed=0,
                           shard_id=rank // 2, num_shards=2,
                           drop_last=False)._epoch_indices()
        assert seen[rank] == want.tolist()
    assert seen[0] == seen[1] != seen[2] == seen[3]


@pytest.mark.parametrize("op,tol", [
    ("conv3x3", 1e-12), ("dilated3", 1e-12), ("stride2", 1e-12),
    ("conv3x3_bf16", 2e-2), ("maxpool_inf", 1e-12), ("gather_rows", 1e-12),
    ("take_rows", 1e-12)])
def test_spatial_collectives_match_unsharded_ops(spawned, op, tol):
    """Each collective and its gradients on both ranks against the op on
    the whole tensor, relative to the largest magnitude: ``halo_conv2d``
    in float64 (a stride-2 conv with a halo above only; the weight and
    bias gradients summed over the ranks) and under bf16 autocast (bf16
    sums in two orders: 2e-2), a max pool over a -inf ``halo_exchange``,
    ``gather_rows`` (its backward sums the ranks' gradients) and
    ``take_rows``."""
    for rank in ("rank0", "rank1"):
        fwd, grad = spawned.results()[rank]["spatial_ops"][op]
        assert fwd <= tol and grad <= tol, (rank, fwd, grad)


def test_spatial_trainer_trains_and_resumes(spawned):
    """``Trainer`` at S = 2 over the two ranks: two logged steps with
    finite losses, rank 0's ``final`` checkpoint, and a fresh Trainer on
    each rank (weights of another seed) resumes rank 0's state."""
    r0, r1 = (spawned.results()[r]["trainer"] for r in ("rank0", "rank1"))
    assert len(r0["losses"]) == 2 and np.isfinite(r0["losses"]).all()
    assert r1["losses"] == []  # rank 0 alone logs
    assert r0["checkpoint"] and r0["digest"] == r1["digest"]
    assert r0["resumed"] == r1["resumed"] == r0["digest"]
    assert r0["step"] == r1["step"] == 2
