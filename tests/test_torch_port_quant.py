"""Port parity: int8 PTQ of ``refinedet_tpu_torch`` (``ops/int8_conv.py``,
``models/layers.py:QuantConv2d``, ``quant/ptq.py``, ``quant/gptq.py``)
against the JAX package's ``refinedet_tpu.quant`` and ``QuantConv``, on
the CPU.

Both packages get the port's seeded RefineDet320 weights (21 classes)
through the JAX package's importer, so no Flax ``init`` runs. The network
is fully convolutional: calibration, Hessians and heads run at 128x128
(``IMG``), two calibration batches of one image each. Each JAX pass is
jitted once for the module (``calibrate_amax`` and ``accumulate_hessians``
each compile one forward; the int8 and f32 heads one each).

Tolerances, each beside what it measured:
  * one quantized conv, float32 in: the int8 input, the int32
    accumulators and the output bitwise, in float32 and in bfloat16 (XLA
    fuses the epilogue's multiply-add into one FMA; the port's plain
    version computes that FMA exactly, ``ops/int8_conv.py:fma_f32``, and
    its kernel runs ``__fmaf_rn``). The epilogue alone bitwise against the
    jitted JAX expression on 1e5 random entries and on constructed
    halfway cases, where rounding twice and a bare float64 sum both
    miss.
  * calibration statistics and means rtol 1e-5, with an absolute floor
    of 1e-5 of the conv's largest statistic (oneDNN and XLA compute the
    float32 activations in different orders; the worst entry measured
    used 0.19 of that tolerance, means 6.5e-7 of the largest amax).
  * ``quantize_variables`` from the same float32 weights and statistics:
    every leaf bitwise equal (the same numpy code), with and without bias
    correction, plain and BN variant.
  * Hessians rtol 1e-5 of the largest entry (float32 sums in two orders;
    measured 8.3e-7).
  * GPTQ from the same Hessian: ≥ 99.9% of ``kernel_q`` equal and every
    entry within ±1 (the port's solve emulates XLA's FMAs through float64;
    measured 100% equal on the three convs below, 99.90% with one
    entry 2 steps apart without the emulation).
  * int8 heads at 128 px in float32: 1e-3 of each head's largest
    magnitude (measured ≤ 3.4e-7; an activation on a .5 boundary would
    round differently once the float layers upstream drift, which this
    seed does not hit), and the port's int8-versus-f32 gap (mean absolute
    difference) within 10% of JAX's (measured within 3.3e-6 of it).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.models.layers import QuantConv as JQuantConv  # noqa: E402
from refinedet_tpu.models.torch_import import (  # noqa: E402
    torch_state_dict_to_flax, torch_state_dict_to_flax_bn)
from refinedet_tpu.quant import gptq as jgptq  # noqa: E402
from refinedet_tpu.quant import ptq as jptq  # noqa: E402

from refinedet_tpu_torch.models import (build_refinedet,  # noqa: E402
                                        build_refinedet_bn,
                                        state_dict_from_flax)
from refinedet_tpu_torch.models.layers import QuantConv2d  # noqa: E402
from refinedet_tpu_torch.ops import int8_conv as port_int8  # noqa: E402
from refinedet_tpu_torch.quant import gptq, ptq  # noqa: E402
from refinedet_tpu_torch.tools.int8_bench import made_up_stats  # noqa: E402

NUM_CLASSES = 21
IMG = 128
# (kernel, stride, padding, dilation): every geometry of the quantized set
GEOMETRIES = [(3, 1, 1, 1), (3, 1, 3, 3), (1, 1, 0, 1), (3, 2, 1, 1)]
GPTQ_NAMES = ("vgg_conv2_1", "extra_conv1", "tcb2_0_conv")

pytestmark = pytest.mark.filterwarnings(
    "ignore:PTQ.*calibration-dead:UserWarning")  # random weights at 128 px


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The GPTQ solve is thousands of small ops in a row: with the tests'
    parallel workers sharing the cores, one intra-op thread a worker runs
    it several times faster than a pool of them contending."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, n=1):
    return (np.random.RandomState(seed).randn(n, IMG, IMG, 3) * 60.0).astype(
        np.float32)


@pytest.fixture(scope="module")
def pair():
    """The port's f32 model and state, JAX's model and variables (the same
    weights), the calibration batches, and JAX's calibration of them."""
    model = build_refinedet("test", 320, NUM_CLASSES, device="cpu", seed=0)
    state = model.net.state_dict()
    variables = {"params": torch_state_dict_to_flax(state)}
    jmodel = jbuild("test", 320, NUM_CLASSES)
    batches = [_images(1), _images(2)]
    stats, means = jptq.calibrate_amax(jmodel, variables, batches,
                                       return_means=True)
    return {"model": model, "state": state, "variables": variables,
            "jmodel": jmodel, "batches": batches, "stats": stats,
            "means": means}


# -- the int8 convolution ------------------------------------------------------

@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "k{}s{}p{}d{}"
                         .format(*g))
def test_reference_exact_against_int64_im2col(geom):
    k, s, p, d = geom
    rng = np.random.RandomState(sum(geom))
    xq = rng.randint(-127, 128, (2, 11, 9, 64)).astype(np.int8)
    xq[0, 0, 0] = 127  # extremes
    w = rng.randint(-127, 128, (128, k, k, 64)).astype(np.int8)
    w[0] = -127
    got = port_int8.int8_conv_accumulate(torch.from_numpy(xq),
                                         torch.from_numpy(w), s, p, d)
    xp = np.pad(xq.astype(np.int64), ((0, 0), (p, p), (p, p), (0, 0)))
    ho = (11 + 2 * p - d * (k - 1) - 1) // s + 1
    wo = (9 + 2 * p - d * (k - 1) - 1) // s + 1
    cols = np.stack([xp[:, r * d:r * d + s * (ho - 1) + 1:s,
                        c * d:c * d + s * (wo - 1) + 1:s]
                     for r in range(k) for c in range(k)], axis=3)
    want = cols.reshape(2, ho, wo, -1) @ \
        w.astype(np.int64).reshape(128, -1).T
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "k{}s{}p{}d{}"
                         .format(*g))
def test_quantconv_matches_jax(geom):
    """Same int8 parameters: the int8 input, the int32 sums and the output
    bitwise, in float32 and in bfloat16."""
    k, s, p, d = geom
    rng = np.random.RandomState(10 + sum(geom))
    cin, cout = 64, 128
    x = (rng.randn(2, 13, 12, cin) * 3.0).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 200.0]  # ties and a clamp
    params = {"kernel_q": rng.randint(-127, 128, (k, k, cin, cout))
              .astype(np.int8),
              "w_scale": rng.uniform(1e-4, 1e-2, cout).astype(np.float32),
              "in_scale": rng.uniform(0.01, 0.05, cin).astype(np.float32),
              "bias": rng.randn(cout).astype(np.float32)}
    params["in_scale"][:2] = 1.0
    jconv = JQuantConv(features=cout, kernel=k, strides=s, padding=p,
                       dilation=d, dtype=jnp.float32)
    want = np.asarray(jax.jit(jconv.apply)({"params": params}, x))
    inv = 1.0 / jnp.asarray(params["in_scale"])
    jxq = jnp.clip(jnp.round(jnp.asarray(x) * inv), -127, 127).astype(
        jnp.int8)
    jacc = lax.conv_general_dilated(
        jxq, jnp.asarray(params["kernel_q"]), (s, s), [(p, p)] * 2,
        rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)

    conv = QuantConv2d(cin, cout, k, s, p, d)
    with torch.no_grad():
        conv.kernel_q.copy_(torch.from_numpy(
            params["kernel_q"].transpose(3, 0, 1, 2).copy()))
        for name in ("w_scale", "in_scale", "bias"):
            getattr(conv, name).copy_(torch.from_numpy(params[name]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    xq = conv.quantize_input(xt).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    acc = port_int8.int8_conv(xq, conv.kernel_q, conv.w_scale, conv.bias,
                              s, p, d, torch.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = conv(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # rounding the product, then the sum, would miss JAX's FMA
    twice = acc.numpy().astype(np.float32) * params["w_scale"] \
        + params["bias"]
    assert (twice != want).any()

    jconv16 = JQuantConv(features=cout, kernel=k, strides=s, padding=p,
                         dilation=d, dtype=jnp.bfloat16)
    want16 = jax.jit(jconv16.apply)({"params": params}, x)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got16 = conv(xt).permute(0, 2, 3, 1)
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  np.asarray(want16, np.float32))


def _halfway_cases():
    """(acc, w_scale, bias) whose exact ``acc * w_scale`` lies halfway
    between two float32 values and whose bias, a tiny nudge, decides the
    side: 4097 * 4097 * 2^-24 = 1 + 2^-11 + 2^-24 (the lower neighbour's
    last bit even) nudged up, 4097 * 4099 * 2^-24 = 1 + 8193 * 2^-23 +
    2^-24 (odd) nudged down, each mirrored and at several exponents.
    Rounded twice, the product goes to the even neighbour and the nudge
    is lost; a bare float64 sum lands on the halfway point itself."""
    rows = []
    for b, nudge in ((4097, 2.0 ** -60), (4099, -(2.0 ** -60))):
        for e in (-30, 0, 7):
            for sign in (1, -1):
                rows.append((sign * 4097, b * 2.0 ** (e - 24),
                             sign * nudge * 2.0 ** e))
    acc, w_scale, bias = zip(*rows)
    return (np.array(acc, np.int32), np.array(w_scale, np.float32),
            np.array(bias, np.float32))


def test_fma_epilogue_matches_jax():
    """``int8_conv_reference``'s epilogue (``fma_f32``) against JAX's
    jitted ``y.astype(f32) * w_scale + bias``, bitwise: on 1e5 random
    int32 sums, scales and biases, and on the constructed halfway cases,
    where the two-rounding form and a bare float64 sum both differ from
    JAX."""
    jepilogue = jax.jit(lambda y, s, b: y.astype(jnp.float32) * s + b)
    rng = np.random.RandomState(0)
    n = 100_000
    acc = rng.randint(-2 ** 24, 2 ** 24, n).astype(np.int32)
    acc[::3] = rng.randint(-127 * 127 * 9, 127 * 127 * 9, acc[::3].size)
    w_scale = rng.uniform(1e-5, 1e-1, n).astype(np.float32)
    bias = (rng.randn(n) * rng.choice([1e-3, 1.0, 1e2], n)).astype(
        np.float32)
    for a, s, b, halfway in ((acc, w_scale, bias, False),
                             (*_halfway_cases(), True)):
        want = np.asarray(jepilogue(a, s, b))
        got = port_int8.fma_f32(torch.from_numpy(a).float(),
                                torch.from_numpy(s), torch.from_numpy(b))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        twice = a.astype(np.float32) * s + b
        bare = (a.astype(np.float64) * s + b).astype(np.float32)
        if halfway:
            assert np.all(twice != want) and np.all(bare != want)
        else:  # about a fifth of these tell one rounding from two
            assert (twice != want).mean() > 0.1
    # the whole plain version on two such entries: a 1x1 conv of one
    # pixel whose sums are 32 * 127 + 33 = 4097
    xq = torch.tensor([127] * 32 + [33], dtype=torch.int8).view(1, 1, 1, 33)
    a, s, b = (v[[0, 6]] for v in _halfway_cases())
    got = port_int8.int8_conv_reference(
        xq, torch.ones(2, 1, 1, 33, dtype=torch.int8), torch.from_numpy(s),
        torch.from_numpy(b), 1, 0, 1, torch.float32)
    assert a.tolist() == [4097, 4097]
    np.testing.assert_array_equal(got.view(2).numpy(),
                                  np.asarray(jepilogue(a, s, b)))


def test_int8_conv_refusals():
    xq = torch.zeros(1, 4, 4, 64, dtype=torch.int8)
    w = torch.zeros(128, 3, 3, 64, dtype=torch.int8)
    ones, zeros = torch.ones(128), torch.zeros(128)
    with pytest.raises(ValueError, match="int8 xq and w"):
        port_int8.int8_conv(xq.float(), w, ones, zeros)
    with pytest.raises(ValueError, match="does not fit"):
        port_int8.int8_conv(xq[..., :32], w, ones, zeros)
    with pytest.raises(ValueError, match="out_dtype"):
        port_int8.int8_conv(xq, w, ones, zeros, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 w_scale"):
        port_int8.int8_conv(xq, w, ones[:64], zeros)


# -- calibration and quantization ---------------------------------------------

def test_calibrate_amax_matches_jax(pair):
    stats, means = ptq.calibrate_amax(pair["model"], pair["batches"],
                                      return_means=True)
    assert set(stats) == set(pair["stats"]) == set(means) == \
        set(pair["means"])
    assert len(stats) == 28
    for name, want in pair["stats"].items():
        assert stats[name].shape == want.shape == (4, want.shape[1])
        np.testing.assert_allclose(stats[name], want, rtol=1e-5,
                                   atol=1e-5 * want.max(), err_msg=name)
        np.testing.assert_allclose(means[name], pair["means"][name],
                                   rtol=1e-5, atol=1e-5 * want[0].max(),
                                   err_msg=name)


def test_calibration_hooks_exist_only_while_calibrating(pair):
    net = pair["model"].net
    convs = ptq.quant_modules(net).values()
    assert all(not m._forward_pre_hooks for m in convs)
    ptq.calibrate_amax(pair["model"], pair["batches"][:1])
    assert all(not m._forward_pre_hooks for m in convs)


@pytest.mark.parametrize("bias_correct", [False, True])
@pytest.mark.parametrize("act_stat", ["p9999", "amax"])
def test_quantize_variables_bitwise(pair, bias_correct, act_stat):
    means = pair["means"] if bias_correct else None
    jmodel_q = jbuild("test", 320, NUM_CLASSES, quant=True,
                      quant_skip=jptq.DEFAULT_QUANT_SKIP)
    want = jptq.quantize_variables(jmodel_q, pair["variables"],
                                   pair["stats"], act_stat=act_stat,
                                   means=means)
    model_q = build_refinedet("test", 320, NUM_CLASSES, device="cpu",
                              quant=True, quant_skip=ptq.DEFAULT_QUANT_SKIP)
    got = ptq.quantize_variables(model_q, pair["state"], pair["stats"],
                                 act_stat=act_stat, means=means)
    model_q.net.load_state_dict(got, strict=True)
    want_state = state_dict_from_flax(want)
    assert set(got) == set(want_state)
    n_q = 0
    for k, v in want_state.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        n_q += k.endswith(".kernel_q")
    assert n_q == 26


def test_quantize_variables_bn_variant_bitwise():
    """The BN variant: same flow, BN leaves untouched after each
    QuantConv2d, from stats made up per channel (no forward needed)."""
    model = build_refinedet_bn("test", 320, 2, device="cpu", seed=1)
    state = model.net.state_dict()
    variables = torch_state_dict_to_flax_bn(state)
    stats = made_up_stats(model.net, 3)
    jmodel_q = jbuild("test", 320, 2, use_bn=True, quant=True)
    want = state_dict_from_flax(jptq.quantize_variables(
        jmodel_q, variables, stats))
    model_q = build_refinedet_bn("test", 320, 2, device="cpu", quant=True)
    got = ptq.quantize_variables(model_q, state, stats)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    model_q.net.load_state_dict(got, strict=True)
    assert isinstance(model_q.net.vgg[0], torch.nn.Conv2d)  # conv1_1
    assert isinstance(model_q.net.vgg[3], QuantConv2d)      # conv1_2
    assert isinstance(model_q.net.vgg[4], torch.nn.BatchNorm2d)
    with torch.inference_mode():
        heads = model_q.raw_forward(torch.from_numpy(_images(5)))
    assert all(bool(torch.isfinite(h).all()) for h in heads)


def test_quant_refused_in_train_phase():
    with pytest.raises(ValueError, match="inference-only"):
        build_refinedet("train", 320, NUM_CLASSES, device="cpu", quant=True)


def test_quant_twin_layout():
    """28 quantizable convs, 26 quantized at the default skip; heads,
    conv1_1 and the deconvs stay float."""
    for skip, n in (((), 28), (ptq.DEFAULT_QUANT_SKIP, 26)):
        net = build_refinedet("test", 320, NUM_CLASSES, device="cpu",
                              quant=True, quant_skip=skip).net
        q = [m for m in net.modules() if isinstance(m, QuantConv2d)]
        assert len(q) == n == len(ptq.quant_modules(net))
        assert all(m.kernel_q.is_contiguous() for m in q)
    assert isinstance(net.vgg[0], torch.nn.Conv2d)
    assert all(isinstance(m, torch.nn.Conv2d) for m in net.odm_conf)


# -- GPTQ ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hessians(pair):
    want = jgptq.accumulate_hessians(pair["jmodel"], pair["variables"],
                                     pair["batches"], names=GPTQ_NAMES)
    got = gptq.accumulate_hessians(pair["model"], pair["batches"],
                                   names=GPTQ_NAMES)
    return got, want


def test_patch_order_matches_lax():
    x = np.random.RandomState(0).randn(2, 7, 6, 5).astype(np.float32)
    for k, s, p, d in GEOMETRIES:
        want = lax.conv_general_dilated_patches(
            jnp.asarray(x), (k, k), (s, s), ((p, p), (p, p)),
            rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"))
        want = np.asarray(want).reshape(-1, 5 * k * k)
        p_t = torch.nn.functional.unfold(
            torch.from_numpy(x).permute(0, 3, 1, 2), (k, k), dilation=d,
            padding=p, stride=s)
        got = p_t.transpose(1, 2).reshape(-1, 5 * k * k).numpy()
        np.testing.assert_array_equal(got, want)


def test_hessians_match_jax(hessians):
    got, want = hessians
    assert set(got) == set(want) == set(GPTQ_NAMES)
    for name in GPTQ_NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[name]).max(),
                                   err_msg=name)


def test_gptq_round_matches_jax(pair, hessians):
    """From JAX's Hessians and the same scales: kernel_q ≥ 99.9% equal,
    all within ±1."""
    _, hs = hessians
    params = pair["variables"]["params"]
    for name in GPTQ_NAMES:
        w = np.asarray(params[name]["kernel"], np.float32)
        stat = pair["stats"][name]
        in_scale = np.maximum(np.maximum(stat[1], 1e-3 * stat[0]) / 127.0,
                              1e-12).astype(np.float32)
        w_scale = np.maximum(np.abs(w * in_scale[None, None, :, None])
                             .max(axis=(0, 1, 2)) / 127.0,
                             1e-12).astype(np.float32)
        want = jgptq.gptq_round(w, in_scale, w_scale, hs[name])
        got = gptq.gptq_round(w, in_scale, w_scale, hs[name])
        rtn = np.clip(np.round(w * in_scale[None, None, :, None] / w_scale),
                      -127, 127)
        assert got.dtype == np.int8 and got.shape == w.shape
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, name
        assert (diff == 0).mean() >= 0.999, (name, (diff == 0).mean())
        assert (got != rtn).any(), name  # GPTQ moved some weights


def test_gptq_geometry_mismatch_raises(pair, monkeypatch):
    monkeypatch.setattr(gptq, "conv_geometry",
                        lambda name, shape: (3, 3, 1, 2, 1))
    with pytest.raises(ValueError, match="disagrees with quant.gptq"):
        gptq.accumulate_hessians(pair["model"], pair["batches"][:1],
                                 names=("vgg_conv2_1",))


def test_gptq_cache_keys_on_the_hessian(pair, hessians, monkeypatch):
    """Same weights and scales, another Hessian: the cache recomputes; the
    same Hessian again: it reuses."""
    got_h, _ = hessians
    name = "vgg_conv2_1"
    calls = []
    real = gptq.gptq_round
    monkeypatch.setattr(gptq, "gptq_round",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model_q = build_refinedet("test", 320, NUM_CLASSES, device="cpu",
                              quant=True)
    cache = {}
    other = {name: got_h[name] + np.eye(len(got_h[name]),
                                        dtype=np.float32)}
    first = ptq.quantize_variables(model_q, pair["state"], pair["stats"],
                                   hessians={name: got_h[name]},
                                   gptq_cache=cache)
    again = ptq.quantize_variables(model_q, pair["state"], pair["stats"],
                                   hessians={name: got_h[name]},
                                   gptq_cache=cache)
    moved = ptq.quantize_variables(model_q, pair["state"], pair["stats"],
                                   hessians=other, gptq_cache=cache)
    key = "vgg.5.kernel_q"
    assert len(calls) == 2
    assert torch.equal(first[key], again[key])
    assert not torch.equal(first[key], moved[key])
    assert np.array_equal(cache[name][3], other[name])
    assert torch.equal(moved[key], torch.from_numpy(np.ascontiguousarray(
        cache[name][4].transpose(3, 0, 1, 2))))


def test_quantize_model_gptq_on_named_convs(pair):
    model_q, state_q = ptq.quantize_model(
        pair["model"], pair["batches"], dtype=torch.float32,
        bias_correct=True, weight_opt="gptq",
        weight_opt_names=("extra_conv1",))
    assert model_q.quant and model_q.device.type == "cpu"
    assert sum(k.endswith(".kernel_q") for k in state_q) == 26
    with pytest.raises(ValueError, match="weight_opt"):
        ptq.quantize_model(pair["model"], pair["batches"], weight_opt="x")


# -- the whole network ---------------------------------------------------------

def test_int8_heads_match_jax(pair):
    """The int8 twins of both packages on JAX's quantized variables, f32,
    128 px: heads close, and the int8-versus-f32 gap the same."""
    jmodel_q = jbuild("test", 320, NUM_CLASSES, quant=True)
    qvars = jptq.quantize_variables(jmodel_q, pair["variables"],
                                    pair["stats"])
    img = _images(7)
    j_q = jax.jit(jmodel_q.raw_forward)(qvars, jnp.asarray(img))
    j_f = jax.jit(pair["jmodel"].raw_forward)(pair["variables"],
                                              jnp.asarray(img))
    model_q = build_refinedet("test", 320, NUM_CLASSES, device="cpu",
                              quant=True)
    model_q.net.load_state_dict(state_dict_from_flax(qvars), strict=True)
    with torch.inference_mode():
        p_q = model_q.raw_forward(torch.from_numpy(img))
        p_f = pair["model"].raw_forward(torch.from_numpy(img))
    for jq, jf, pq, pf in zip(j_q, j_f, p_q, p_f):
        jq, jf = np.asarray(jq), np.asarray(jf)
        pq, pf = pq.numpy(), pf.numpy()
        scale = np.abs(jq).max()
        assert np.abs(pq - jq).max() <= 1e-3 * scale
        gap_j = np.abs(jq - jf).mean()
        gap_p = np.abs(pq - pf).mean()
        assert gap_j > 0
        assert abs(gap_p - gap_j) <= 0.1 * gap_j, (gap_p, gap_j)
