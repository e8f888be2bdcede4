"""Port parity: the RefineDet network, the weight converter, the
initializers and the post-processors of ``refinedet_tpu_torch`` against
the JAX package's, on the CPU at 320 with 3 classes and batch 1."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.config import DetectConfig as JDetectConfig  # noqa: E402
from refinedet_tpu.models import initializers as jinit  # noqa: E402
from refinedet_tpu.detect import detection as jdet  # noqa: E402
from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.models import build_refinedet_bn as jbuild_bn  # noqa: E402
from refinedet_tpu.models.torch_export import \
    flax_to_torch_state_dict  # noqa: E402
from refinedet_tpu.models.torch_import import (  # noqa: E402
    torch_state_dict_to_flax, torch_state_dict_to_flax_bn)
from refinedet_tpu.ops.dispatch import \
    class_parallel_nms as jclass_parallel_nms  # noqa: E402

from refinedet_tpu_torch.config import DetectConfig  # noqa: E402
from refinedet_tpu_torch.detect import detection as det  # noqa: E402
from refinedet_tpu_torch.models import (build_refinedet,  # noqa: E402
                                        state_dict_from_flax)
from refinedet_tpu_torch.models import initializers  # noqa: E402
from refinedet_tpu_torch.serve.export import (fused_nms_settings,  # noqa: E402
                                              fused_postprocess)

NUM_CLASSES = 3
# XLA and oneDNN sum the convolutions in different orders: relative 1e-4,
# and an absolute floor of 1e-4 of the head's largest magnitude.
RTOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port's CPU model on the same
    weights, one numpy-seeded image)."""
    jmodel = jbuild("test", 320, NUM_CLASSES)
    variables = jmodel.init(jax.random.PRNGKey(0))
    model = build_refinedet("test", 320, NUM_CLASSES, device="cpu")
    model.net.load_state_dict(state_dict_from_flax(variables["params"]),
                              strict=True)
    # Seed 4 keeps the top-200 scores of each class at least 1e-6 apart
    # (checked in test_postprocess_on_identical_heads), so last-ulp
    # differences between the two softmaxes cannot reorder candidates.
    img = np.random.RandomState(4).randn(1, 320, 320, 3).astype(np.float32)
    return jmodel, variables, model, img


@pytest.fixture(scope="module")
def heads(pair):
    """The JAX heads and the port's heads on the same weights and image."""
    jmodel, variables, model, img = pair
    jheads = [np.asarray(h) for h in jmodel.raw_forward(variables,
                                                        jnp.asarray(img))]
    with torch.inference_mode():
        theads = [h.numpy() for h in model.raw_forward(torch.from_numpy(img))]
    return jheads, theads


def test_state_dict_matches_torch_export(pair):
    _, variables, model, _ = pair
    ours = state_dict_from_flax(variables["params"])
    theirs = flax_to_torch_state_dict(variables["params"])
    assert set(ours) == set(theirs) == set(model.net.state_dict())
    for k, v in ours.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)


def test_heads_match_flax(heads):
    jheads, theads = heads
    shapes = [(1, 6375, 4), (1, 6375, 2), (1, 6375, 4),
              (1, 6375, NUM_CLASSES)]
    for want, got, shape in zip(jheads, theads, shapes):
        assert got.shape == want.shape == shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_train_phase_and_bf16(pair):
    _, variables, _, img = pair
    model = build_refinedet("train", 320, NUM_CLASSES, device="cpu",
                            dtype=torch.bfloat16)
    model.net.load_state_dict(state_dict_from_flax(variables), strict=True)
    jmodel = jbuild("train", 320, NUM_CLASSES, dtype=jnp.bfloat16)
    with torch.inference_mode():
        out = model(torch.from_numpy(img))
    jout = jmodel.apply(variables, jnp.asarray(img))
    assert len(out) == 5
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(jout[4]))
    for got, want in zip(out[:4], jout[:4]):
        want = np.asarray(want)
        assert got.dtype == torch.float32
        # bf16 keeps 8 bits of mantissa and the two frameworks round at
        # different places: hold the heads to 5% of the largest magnitude.
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=0.05 * np.abs(want).max())


def test_build_validation(monkeypatch):
    with pytest.raises(ValueError, match="phase"):
        build_refinedet("eval", 320, 3, device="cpu")
    with pytest.raises(ValueError, match="supported sizes"):
        build_refinedet("test", 300, 3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_refinedet("test", 320, 3)  # the card is the default


def _t(a):
    return torch.from_numpy(np.array(a))


def _softmaxed(jheads):
    """Post-softmax heads, computed once in JAX and fed to both packages."""
    al, ac, ol, oc = jheads
    ac = np.asarray(jax.nn.softmax(jnp.asarray(ac), axis=-1))
    oc = np.asarray(jax.nn.softmax(jnp.asarray(oc), axis=-1))
    return al, ac, ol, oc


def min_score_gap(scores, top_k, conf_thresh):
    """Smallest gap between consecutive valid scores among each image's and
    class's best ``top_k + 1`` (scores ``[B, P, C]``, background at 0)."""
    gaps = []
    for per_image in scores:
        for cls in per_image[:, 1:].T:
            best = np.sort(cls)[::-1][:top_k + 1]
            best = best[best > conf_thresh]
            if len(best) > 1:
                gaps.append(float(np.min(best[:-1] - best[1:])))
    return min(gaps)


def _assert_rows_equal(got, want, score_col):
    """Same kept rows in the same order; boxes to 1e-5."""
    np.testing.assert_array_equal(got[..., score_col] > 0,
                                  want[..., score_col] > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_postprocess_on_identical_heads(pair, heads):
    jmodel, _, model, _ = pair
    jheads, _ = heads
    al, ac, ol, oc = _softmaxed(jheads)
    priors = np.asarray(jmodel.priors)
    np.testing.assert_array_equal(model.priors.numpy(), priors)

    boxes, scores = det.detect_refinedet(_t(al), _t(ac), _t(ol), _t(oc),
                                         _t(priors))
    jboxes, jscores = jdet.detect_refinedet(al, ac, ol, oc, priors)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), atol=1e-5)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))

    cfg = DetectConfig(num_classes=NUM_CLASSES, top_k=300)
    jcfg = JDetectConfig(num_classes=NUM_CLASSES, top_k=300)
    for keep_cap in (False, True):
        got = det.detect_refinedet_nms(_t(al), _t(ac), _t(ol), _t(oc),
                                       _t(priors), cfg,
                                       apply_keep_top_k=keep_cap).numpy()
        want = np.asarray(jdet.detect_refinedet_nms(
            al, ac, ol, oc, priors, jcfg, apply_keep_top_k=keep_cap))
        assert got.shape == (1, NUM_CLASSES, 300, 5)
        assert (got[..., 0] > 0).sum() > 0
        _assert_rows_equal(got, want, score_col=0)

    # The fused serving post-process (softmax inside, x1..y2 then score),
    # against the body of refinedet_tpu/serve/export.py's fused function.
    opts = fused_nms_settings(NUM_CLASSES, {})
    assert min_score_gap(np.asarray(jscores), opts.nms_top_k,
                         opts.conf_thresh) > 1e-6
    got = fused_postprocess([_t(h) for h in jheads], _t(priors),
                            opts).numpy()
    jb, js = jdet.detect_refinedet(al, ac, ol, oc, priors,
                                   variances=opts.variance,
                                   objectness_thresh=opts.objectness_thresh)
    bx, sc = jclass_parallel_nms(
        jb[:, None], jnp.moveaxis(js[..., 1:], -1, 1), opts.nms_thresh,
        top_k=opts.nms_top_k, score_thresh=opts.conf_thresh, plus_one=False,
        backend="cpu")
    want = np.asarray(jnp.concatenate([bx, sc[..., None]], axis=-1))
    assert got.shape == (1, NUM_CLASSES - 1, 200, 5)
    _assert_rows_equal(got, want, score_col=4)


@pytest.mark.parametrize("call", [
    ("constant_init", ((3, 3, 4, 8), 0.5, 0.1)),
    ("xavier_init", ((3, 3, 4, 8),), {"gain": 2.0}),
    ("xavier_init", ((2, 2, 6, 6),), {"distribution": "uniform"}),
    ("normal_init", ((5, 7),), {"mean": 1.0, "std": 0.01}),
    ("uniform_init", ((3, 3, 2, 4),), {"a": -1.0, "b": 2.0}),
    ("kaiming_init", ((3, 3, 4, 8),), {}),
    ("kaiming_init", ((1, 1, 16, 4),), {"mode": "fan_in", "a": 0.1,
                                        "nonlinearity": "leaky_relu",
                                        "distribution": "uniform"}),
    ("_fans", ((7,),)), ("_fans", ((3, 5),)), ("_fans", ((3, 3, 4, 8),))],
    ids=lambda c: c[0])
def test_initializers_draw_as_jax(call):
    """Each helper bitwise equal to JAX's from the same RandomState."""
    name, args, kwargs = (*call, {})[:3]
    rng_args = () if name in ("constant_init", "_fans") else None
    out = []
    for mod in (initializers, jinit):
        fn = getattr(mod, name)
        extra = rng_args if rng_args is not None else \
            (np.random.RandomState(7),)
        out.append(fn(*extra, *args, **kwargs))
    got, want = out
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)


def test_torch_layout_matches_the_converter():
    k = np.random.RandomState(0).randn(2, 2, 3, 5).astype(np.float32)
    conv = initializers.torch_layout(k)
    assert conv.shape == (5, 3, 2, 2)
    np.testing.assert_array_equal(conv.numpy()[4, 2, 1, 0], k[1, 0, 2, 4])
    deconv = initializers.torch_layout(k, transposed=True)
    assert deconv.shape == (3, 5, 2, 2)  # mirrored: [in, out, kh, kw]
    np.testing.assert_array_equal(deconv.numpy()[2, 4, 1, 0], k[0, 1, 2, 4])


def _flax_init_order(jmodel):
    """The names of JAX's params dict in its init's own order, read while
    ``jax.eval_shape`` traces the init (no FLOPs)."""
    order = []

    def init(rng, x):
        variables = jmodel.module.init(rng, x, train=False)
        order.extend(variables["params"].keys())
        return variables

    jax.eval_shape(init, jax.random.PRNGKey(0),
                   jnp.zeros((1, 128, 128, 3), jnp.float32))
    return order


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
def test_reinit_heads_xavier_matches_jax(use_bn):
    """``reinit_heads_xavier`` on the port's net equals JAX's on a params
    dict of the same weights in its init's order, after
    ``state_dict_from_flax``, bitwise; the trunk and L2Norms untouched.
    The order the port draws in is the order JAX's init creates the
    layers."""
    model = build_refinedet("train", 320, NUM_CLASSES, use_bn=use_bn,
                            device="cpu", seed=5)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    jmodel = (jbuild_bn if use_bn else jbuild)("train", 320, NUM_CLASSES)
    order = _flax_init_order(jmodel)
    skip = ("vgg_", "L2Norm")
    assert [n for n in order if not n.startswith(skip)
            and n in initializers.head_init_order(use_bn)] == \
        initializers.head_init_order(use_bn)
    if use_bn:
        variables = torch_state_dict_to_flax_bn(before)
    else:
        variables = {"params": torch_state_dict_to_flax(before)}
    params = {n: variables["params"][n] for n in order}
    jparams = jinit.reinit_heads_xavier(params, seed=11)
    want = state_dict_from_flax(dict(variables, params=jparams))
    initializers.reinit_heads_xavier(model.net, seed=11)
    got = model.net.state_dict()
    assert set(got) == set(want)
    moved = 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        moved += not torch.equal(v, before[k])
        if k.startswith(("vgg.", "L2Norm")):
            assert torch.equal(got[k], before[k]), k
    # One weight per conv moves; the biases were zero already.
    assert moved == len(initializers.head_init_order(use_bn))
