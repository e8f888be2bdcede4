"""Port parity: the BN variant and the five-source RefineDet896 of
``refinedet_tpu_torch`` against the JAX package's, on the CPU.

Weights go from the port's seeded init to JAX through the JAX package's
own importer (``torch_state_dict_to_flax_bn``), so no Flax ``init`` runs
at full size; full-size shapes come from ``jax.eval_shape``. JAX forwards
are jitted: one compile is ~5x faster on the CPU than eager dispatch.

Tolerances: heads rtol 1e-4 with an absolute floor of 1e-4 of the head's
largest magnitude in f32 (XLA and oneDNN sum the convolutions in
different orders), 5% of the largest magnitude in bf16; running
statistics after a train-mode forward rtol 1e-5, after a train step rtol
1e-4, each with the same kind of floor (a running mean near 0 has no
relative precision). torch's stock BatchNorm folds the unbiased batch
variance into the running one, n/(n-1) above flax's biased one: at
RefineDet320's extras (n = 25 at batch 1, 50 at batch 2) that is 2-4%,
far outside both tolerances. Two train steps: losses rtol 2e-4, the
running statistics rtol 1e-4, and each parameter's update (and its EMA's
move) a relative L2 norm of 5e-2 (``UPDATE_RTOL``). The plain net's 2e-2
is too tight for a random-init BN net in float32: JAX and the port differ
by 1.3-1.9% after one step and 2.5-3.1% after two, with the CPU thread
count, and the port's own float32 step is as far from its float64 step
(``tests/bn_conditioning.py`` measures both). XLA's float64 convolutions
are too slow on the CPU to compare the two packages in float64 here.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.boxes.priors import generate_priors as jpriors  # noqa: E402
from refinedet_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from refinedet_tpu.config import coco_refinedet  # noqa: E402
from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.models.refinedet import RefineDet as JRefineDet  # noqa: E402
from refinedet_tpu.models.torch_export import (  # noqa: E402
    flax_to_torch_state_dict, flax_to_torch_state_dict_bn)
from refinedet_tpu.models.torch_import import (  # noqa: E402
    torch_state_dict_to_flax, torch_state_dict_to_flax_bn)
from refinedet_tpu.train import make_optimizer as joptimizer  # noqa: E402
from refinedet_tpu.train import make_train_step as jmake_step  # noqa: E402
from refinedet_tpu.train.train_step import TrainState as JState  # noqa: E402

from refinedet_tpu_torch.config import TrainConfig  # noqa: E402
from refinedet_tpu_torch.eval.cli_coco import make_loader  # noqa: E402
from refinedet_tpu_torch.models import (RefineDet,  # noqa: E402
                                        build_refinedet,
                                        build_refinedet_bn,
                                        state_dict_from_flax)
from refinedet_tpu_torch.tools.train_check import \
    biases_before_bn  # noqa: E402
from refinedet_tpu_torch.train import (CheckpointManager,  # noqa: E402
                                       create_train_state, make_optimizer,
                                       make_train_step)

from test_torch_port_train import LR, STEP_CFG, _batch  # noqa: E402

NUM_CLASSES = 3
RTOL = 1e-4
UPDATE_RTOL = 5e-2


def _assert_close(got, want, rtol, err_msg=""):
    """rtol, with an absolute floor of rtol times the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


def _move_bn(net, seed):
    """BN scale, bias and running statistics off their 1/0/0/1 init, from
    a numpy seed."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0, 0.1, c)),
                             (m.running_mean, rng.normal(0, 0.2, c)),
                             (m.running_var, rng.uniform(0.5, 2.0, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))


def _stats(state):
    return {k: v for k, v in state.items() if ".running_" in k}


# -- state_dicts --------------------------------------------------------------

@pytest.mark.parametrize("size,use_bn", [(512, True), (896, True),
                                         (896, False)],
                         ids=["bn512", "bn896", "plain896"])
def test_state_dict_matches_jax_export(size, use_bn):
    """The port's converter against the JAX exporter on the same variables
    (bit for bit), the variables' tree against the JAX module's, and the
    key set against the port's net, so reference names strict-load."""
    net = RefineDet(2, size, use_bn)
    net.reset_parameters(torch.Generator().manual_seed(size))
    if use_bn:
        _move_bn(net, 0)
    sources = 5 if size == 896 else 4
    sd = net.state_dict()
    if use_bn:
        variables = torch_state_dict_to_flax_bn(sd, sources)
        theirs = flax_to_torch_state_dict_bn(variables)
    else:
        params = torch_state_dict_to_flax(sd, sources)
        # the JAX plain importer and exporter skip the conv3_3 tap
        params["conv3_3_L2Norm"] = {
            "weight": sd["conv3_3_L2Norm.weight"].numpy()}
        variables = {"params": params}
        theirs = flax_to_torch_state_dict(params)
        theirs["conv3_3_L2Norm.weight"] = params["conv3_3_L2Norm"]["weight"]
    module = JRefineDet(size=size, num_classes=2, use_bn=use_bn)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want_tree = {k: jax.tree.map(lambda s: s.shape, shapes[k])
                 for k in ("params", "batch_stats") if k in shapes}
    assert jax.tree.map(np.shape, variables) == want_tree

    ours = state_dict_from_flax(variables)
    assert set(ours) == set(theirs) == set(sd)
    for k, v in ours.items():
        assert v.dtype == sd[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs[k]),
                                      err_msg=k)
        assert torch.equal(v, sd[k]) or "num_batches" in k, k
    net.load_state_dict(ours, strict=True)


# -- the BN forward, RefineDet320-BN ----------------------------------------

@pytest.fixture(scope="module")
def bn320():
    """(port test-phase model, its state, JAX model, variables, image):
    RefineDet320-BN, 3 classes, BN moved off its init."""
    model = build_refinedet_bn("test", 320, NUM_CLASSES, device="cpu",
                               seed=3)
    _move_bn(model.net, 1)
    state = {k: v.clone() for k, v in model.net.state_dict().items()}
    variables = torch_state_dict_to_flax_bn(state)
    jmodel = jbuild("test", 320, NUM_CLASSES, use_bn=True)
    img = np.random.RandomState(4).randn(1, 320, 320, 3).astype(np.float32)
    return model, state, jmodel, variables, img


def test_bn_heads_eval_mode(bn320):
    model, _, jmodel, variables, img = bn320
    want = jax.jit(jmodel.raw_forward)(variables, jnp.asarray(img))
    with torch.inference_mode():
        got = model.raw_forward(torch.from_numpy(img))
    assert not model.net.training
    for g, w, p in zip(got, want, (4, 2, 4, NUM_CLASSES)):
        assert g.shape == (1, 6375, p) and g.dtype == torch.float32
        _assert_close(g.numpy(), w, RTOL)


def test_bn_heads_and_running_stats_train_mode(bn320):
    model, state, jmodel, variables, img = bn320
    want, mutated = jax.jit(lambda v, x: jmodel.raw_forward(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(img))
    try:
        with torch.no_grad():
            got = model.raw_forward(torch.from_numpy(img), train=True)
        assert model.net.training
        moved = {k: v.clone() for k, v in model.net.state_dict().items()}
    finally:
        model.net.load_state_dict(state)
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w, RTOL)
    want_stats = _stats(state_dict_from_flax(
        {"params": variables["params"],
         "batch_stats": mutated["batch_stats"]}))
    assert len(want_stats) == 2 * 17  # 15 trunk convs and 2 extras
    for k, w in want_stats.items():
        assert not torch.equal(moved[k], state[k]), k
        _assert_close(moved[k].numpy(), w.numpy(), 1e-5, err_msg=k)


def test_bn_heads_bf16(bn320):
    _, state, _, variables, img = bn320
    model = build_refinedet("test", 320, NUM_CLASSES, use_bn=True,
                            device="cpu", dtype=torch.bfloat16)
    model.net.load_state_dict(state, strict=True)
    jmodel = jbuild("test", 320, NUM_CLASSES, use_bn=True,
                    dtype=jnp.bfloat16)
    want = jax.jit(jmodel.raw_forward)(variables, jnp.asarray(img))
    with torch.inference_mode():
        got = model.raw_forward(torch.from_numpy(img))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=0.05 * np.abs(w).max())


# -- five sources -------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_five_sources_small_input(train):
    """RefineDet896-BN's network on a 128x128 input: levels 32/16/8/4/2,
    so the four deconvs line up as at 896."""
    net = RefineDet(2, 896, use_bn=True)
    net.reset_parameters(torch.Generator().manual_seed(7))
    _move_bn(net, 2)
    state = net.state_dict()
    variables = torch_state_dict_to_flax_bn(state, num_sources=5)
    module = JRefineDet(size=896, num_classes=2, use_bn=True)
    img = np.random.RandomState(5).randn(1, 128, 128, 3).astype(np.float32)
    out = jax.jit(lambda v, x: module.apply(
        v, x, train=train, mutable=["batch_stats"] if train else False))(
        variables, jnp.asarray(img))
    want = out[0] if train else out
    with torch.no_grad():
        got = net.train(train)(torch.from_numpy(img))
    levels = (32, 16, 8, 4, 2)
    assert got[0].shape == (1, 3 * sum(f * f for f in levels), 4)
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w, RTOL)
    if train:
        want_stats = _stats(state_dict_from_flax(
            {"params": variables["params"],
             "batch_stats": out[1]["batch_stats"]}))
        for k, w in want_stats.items():
            _assert_close(net.state_dict()[k].numpy(), w.numpy(), 1e-5,
                          err_msg=k)


def test_full_896_shapes_and_priors():
    """Full-size RefineDet896-BN shapes without the FLOPs: the port's
    forward on the meta device against ``jax.eval_shape``; the priors."""
    model = build_refinedet_bn("test", 896, 2, device="meta")
    x = torch.empty(2, 896, 896, 3, device="meta")
    got = model.net(x)
    module = JRefineDet(size=896, num_classes=2, use_bn=True)
    spec = jax.ShapeDtypeStruct((2, 896, 896, 3), jnp.float32)
    variables = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    want = jax.eval_shape(lambda v, i: module.apply(v, i), variables, spec)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 200508, 4), (2, 200508, 2), (2, 200508, 4), (2, 200508, 2)]
    priors = build_refinedet("train", 896, 2, device="cpu").priors
    np.testing.assert_array_equal(priors.numpy(),
                                  np.asarray(jpriors(coco_refinedet["896"])))
    with pytest.raises(ValueError, match="supported sizes"):
        build_refinedet("test", 640, 2, device="cpu")


# -- two BN train steps -------------------------------------------------------

@pytest.fixture(scope="module")
def bn_steps():
    """Two steps of each package on RefineDet320-BN from the port's seeded
    weights, on ``test_torch_port_train``'s two batches. Returns the
    initial state_dict, per step (JAX metrics, JAX params+stats and EMA
    as state_dicts, port metrics, state_dict and EMA), the port's model
    and state after two steps."""
    model = build_refinedet_bn("train", 320, NUM_CLASSES, device="cpu",
                               seed=0)
    sd0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    variables = torch_state_dict_to_flax_bn(sd0)
    params0 = variables["params"]
    jmodel = jbuild("train", 320, NUM_CLASSES, use_bn=True)
    tx = joptimizer(lambda t: LR, grad_clip_norm=STEP_CFG["grad_clip_norm"])
    jstate = JState(step=jnp.zeros((), jnp.int32), params=params0,
                    opt_state=tx.init(params0),
                    batch_stats=variables["batch_stats"],
                    ema_params=jax.tree.map(np.copy, params0))
    jstep = jmake_step(jmodel, tx, JTrainConfig(**STEP_CFG))

    opt = make_optimizer(model.net.parameters(), lambda t: LR,
                         grad_clip_norm=STEP_CFG["grad_clip_norm"])
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, opt, TrainConfig(**STEP_CFG))
    steps = []
    for seed in (0, 1):
        batch = _batch(seed)
        jstate, jmetrics = jstep(jstate, *(jnp.asarray(x) for x in batch))
        state, metrics = step(state, *(torch.from_numpy(x) for x in batch))
        stats = jax.tree.map(np.asarray, jstate.batch_stats)
        steps.append({
            "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
            "jax_state": state_dict_from_flax({"params": jax.tree.map(
                np.asarray, jstate.params), "batch_stats": stats}),
            "jax_ema": state_dict_from_flax({"params": jax.tree.map(
                np.asarray, jstate.ema_params), "batch_stats": stats}),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in
                      model.net.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.items()},
        })
    return sd0, steps, model, state


@pytest.mark.parametrize("n", [1, 2])
def test_bn_steps_match_make_train_step(bn_steps, n):
    start, steps, model, _ = bn_steps
    got = steps[n - 1]
    for k, want in got["jax_metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], want, rtol=2e-4,
                                   err_msg=k)
    assert got["metrics"]["num_pos_odm"] > 0
    params = dict(model.net.named_parameters())
    assert set(got["ema"]) == set(params)  # the EMA has no running stats
    # A conv bias right before a BN has a zero gradient: BN removes it.
    # Its update is rounding noise in both packages.
    before_bn = biases_before_bn(model.net)
    assert len(before_bn) == 17
    checked = 0
    for name in params:
        # the weights' and the EMA's moves since the start
        for ours, ref in (("state", "jax_state"), ("ema", "jax_ema")):
            d_ref = got[ref][name] - start[name]
            d_our = got[ours][name] - start[name]
            if name in before_bn:
                assert float(d_our.abs().max()) < 1e-8, name
                assert float(d_ref.abs().max()) < 1e-8, name
                continue
            rel = float((d_our - d_ref).norm() / (d_ref.norm() + 1e-12))
            assert rel < UPDATE_RTOL, (ours, name, rel, float(d_ref.norm()))
        checked += 1
    assert checked > 80  # every conv, BN scale and bias, the L2Norms
    for name, want in _stats(got["jax_state"]).items():
        assert not torch.equal(got["state"][name], start[name]), name
        _assert_close(got["state"][name].numpy(), want.numpy(), 1e-4,
                      err_msg=name)
        tracked = name.rsplit(".", 1)[0] + ".num_batches_tracked"
        assert int(got["state"][tracked]) == n


def test_bn_checkpoint_round_trip_and_ema_loader(bn_steps, tmp_path):
    """The checkpoint restores the running statistics exactly, and the
    eval loader's ``use_ema`` takes the EMA parameters with the
    checkpoint's running statistics, as the JAX CLI does."""
    _, _, model, state = bn_steps
    path = CheckpointManager(str(tmp_path), "RefineDet320_TEST").save(state,
                                                                      2)
    saved = CheckpointManager.restore_path(path)
    fresh = RefineDet(NUM_CLASSES, 320, use_bn=True)
    fresh.load_state_dict(saved["model"], strict=True)
    live = model.net.state_dict()
    assert _stats(live)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, live[k]), k
    ema = make_loader(use_ema=True)(path)
    fresh.load_state_dict(ema, strict=True)
    for k, v in fresh.state_dict().items():
        want = state.ema[k] if k in state.ema else live[k]
        assert torch.equal(v, want), k


def test_apply_never_moves_running_stats(bn_steps):
    """Both phases' ``apply`` run the net in eval mode, as JAX's does,
    before and after a train step (which leaves the net in train mode)."""
    sd0, _, model, _ = bn_steps
    img = torch.from_numpy(_batch(2)[0][:1])
    fresh = build_refinedet_bn("test", 320, NUM_CLASSES, device="cpu")
    fresh.net.load_state_dict(sd0, strict=True)
    for m in (fresh, model):  # before and after the steps
        before = {k: b.clone() for k, b in m.net.named_buffers()}
        m.net.train()
        with torch.no_grad():
            m(img)
        assert not m.net.training
        for k, b in m.net.named_buffers():
            assert torch.equal(b, before[k]), k
