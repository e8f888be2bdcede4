"""Port parity: the space-to-depth stem twin (``models/stem_s2d.py``,
``RefineDet(stem_s2d=True)``), the slice max-pool backward
(``models/layers.py:POOL_BACKWARD``), their two bench tools and the two
demos, against the JAX package on the CPU.

* the port's fold of its own state_dict equals the JAX fold converted
  (``state_dict_from_flax(fold_stem_variables(v))``) bit for bit, with
  the JAX tests' nonzero accounting;
* the twin's raw heads at 320, batch 1, against JAX's ``stem_s2d`` model
  on the same weights (JAX gets the port's seed weights through
  ``torch_state_dict_to_flax``; one jitted forward, a module fixture),
  within JAX's own ``2e-3 * max(1, max |head|)``; the twin against the
  port's standard net alike at 64 px (RefineDet320's nets and the
  five-source 896's), and the detect path with the
  loc heads damped as JAX's test damps them: boxes JAX's ``atol 1e-3,
  rtol 1e-4``; scores ``atol 5e-4`` (JAX's 1e-4 was set on flax's
  PRNGKey(0) weights; the port's seed-0 ODM logits reach ~500 on these
  pixel-scale images, where the f32 re-association of the folded convs
  moves them ~1e-3 and the scores by 1.4e-4, measured);
* JAX's guards and their messages;
* the slice backward's gradients against JAX's ``max_pool_2x2`` VJP under
  ``POOL_BACKWARD = "slice"`` and against ATen's, bitwise, in
  ``tests/test_model.py``'s cases (ties, ceil mode), with the module's
  switch restored;
* the demos' core against the port's plain detect path, ``demo.main``
  on ``data/example.jpg`` and ``live.main`` without a camera, in
  process; the bench tools' command lines against the JAX tools', and
  their refusal of the CPU.
"""

import argparse
import copy
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import refinedet_tpu.models.layers as jlayers  # noqa: E402
from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.models import fold_stem_variables  # noqa: E402
from refinedet_tpu.models.torch_import import (  # noqa: E402
    torch_state_dict_to_flax)

from refinedet_tpu_torch.detect.detection import (  # noqa: E402
    detect_refinedet)
from refinedet_tpu_torch.models import (RefineDet,  # noqa: E402
                                        build_refinedet,
                                        fold_stem_state_dict, layers,
                                        state_dict_from_flax)
from refinedet_tpu_torch.models.convert import module_names  # noqa: E402
from refinedet_tpu_torch.ops.nms import nms  # noqa: E402
from refinedet_tpu_torch.tools import (bench_pool_backward,  # noqa: E402
                                       bench_stem_s2d, demo, live)
from refinedet_tpu_torch.utils.trace_summary import categorize  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NUM_CLASSES = 21
HEADS_ATOL = 2e-3      # JAX's, of max(1, max |head|)
SCORES_ATOL = 5e-4     # see the module docstring


def _images(seed, size=320, n=1):
    return np.random.RandomState(seed).uniform(
        -120, 130, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The Tier-1 run's parallel workers share the cores: one intra-op
    thread a worker keeps this file's forwards from contending."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port(one_torch_thread):
    """The port's standard RefineDet320 of seed 0 and its stem twin with
    the same weights folded, on the CPU in f32. (``build_refinedet``'s
    own seed-0 twin, which draws the standard net again, is held against
    the standard one on the card: chip_smoke 16a.)"""
    model = build_refinedet("test", 320, NUM_CLASSES, device="cpu", seed=0)
    twin = copy.copy(model)
    twin.stem_s2d = True
    twin.net = RefineDet(NUM_CLASSES, 320, stem_s2d=True)
    twin.net.load_state_dict(fold_stem_state_dict(model.net.state_dict()))
    twin.net = twin.net.to(memory_format=torch.channels_last).eval()
    return {"model": model, "twin": twin, "state": model.net.state_dict()}


@pytest.fixture(scope="module")
def jax_twin(port):
    """JAX's ``stem_s2d`` model on the port's weights, folded by JAX, and
    its raw heads on one image (jitted once)."""
    variables = {"params": torch_state_dict_to_flax(port["state"])}
    folded = fold_stem_variables(variables)
    jmodel = jbuild("test", 320, NUM_CLASSES, stem_s2d=True)
    image = _images(1)
    heads = jax.jit(lambda v, x: jmodel.raw_forward(v, x))(
        folded, jnp.asarray(image))
    return {"folded": folded, "image": image,
            "heads": [np.asarray(h) for h in heads]}


def _assert_heads_close(got, want, atol=HEADS_ATOL):
    for a, b in zip(want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=atol * max(1.0, np.abs(a).max()))


# -- the fold --------------------------------------------------------------------

def test_fold_equals_jax_fold_bitwise(port, jax_twin):
    want = state_dict_from_flax(jax_twin["folded"])
    got = fold_stem_state_dict(port["state"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].view(torch.int32), v.view(torch.int32)), k
    assert set(port["twin"].net.state_dict()) == set(got)


def test_fold_carries_the_stem_exactly(port):
    """JAX's accounting: the 4x4 kernel holds the 3x3x3x64 weights four
    times, each phase conv the 3x3x64x64 ones once (9/16 of its taps),
    and conv1_1 / conv1_2 are gone."""
    state = port["state"]
    folded = fold_stem_state_dict(state)
    w1, w2 = state["vgg.0.weight"], state["vgg.2.weight"]
    k1 = folded["stem_conv1.weight"]
    assert k1.shape == (256, 3, 4, 4)
    assert int(k1.count_nonzero()) == 4 * int(w1.count_nonzero())
    for phase in ("00", "01", "10", "11"):
        k = folded[f"stem_conv2_{phase}.weight"]
        assert k.shape == (64, 256, 2, 2)
        assert int(k.count_nonzero()) == int(w2.count_nonzero())
        assert torch.equal(folded[f"stem_conv2_{phase}.bias"],
                           state["vgg.2.bias"])
    assert not {"vgg.0.weight", "vgg.0.bias", "vgg.2.weight",
                "vgg.2.bias"} & set(folded)
    stem = {"stem_conv1", "stem_conv2_00", "stem_conv2_01",
            "stem_conv2_10", "stem_conv2_11"}
    assert set(module_names(stem_s2d=True)) == (set(module_names()) - {
        "vgg_conv1_1", "vgg_conv1_2"}) | stem


# -- the twin's forward ------------------------------------------------------------

def test_twin_heads_match_jax(port, jax_twin):
    with torch.inference_mode():
        heads = port["twin"].raw_forward(torch.from_numpy(
            jax_twin["image"]))
    _assert_heads_close(heads, jax_twin["heads"])


@pytest.mark.parametrize("size", [320, 896])
def test_twin_matches_standard(port, size):
    """The twin against the port's standard net of the same weights, on a
    64-px image (fully convolutional; the 320 check against JAX is
    above): RefineDet320's nets (512's are the same), and the
    five-source 896 pair, whose conv3_3 tap sits behind the stem, at
    torch's default init folded (the card runs 512 at full size)."""
    if size == 320:
        model, twin = port["model"].net, port["twin"].net
    else:
        torch.manual_seed(0)
        model = RefineDet(NUM_CLASSES, size).eval()
        twin = RefineDet(NUM_CLASSES, size, stem_s2d=True).eval()
        twin.load_state_dict(fold_stem_state_dict(model.state_dict()))
    x = torch.from_numpy(_images(1, 64))
    with torch.inference_mode():
        heads = twin(x)
        _assert_heads_close(heads, model(x))
    assert len(twin.arm_loc) == (5 if size == 896 else 4)


def test_detect_path_with_damped_loc_heads(port):
    """The decode and softmax on the twin's heads, the loc heads scaled
    by 1e-3 (JAX's test: random ones overflow the exp-decode), in place
    in both nets and restored after."""
    model, twin = port["model"], port["twin"]
    loc = [p for net in (model.net, twin.net)
           for name, p in net.named_parameters()
           if name.startswith(("arm_loc.", "odm_loc."))]
    saved = [p.detach().clone() for p in loc]
    x = torch.from_numpy(_images(2))
    try:
        with torch.inference_mode():
            for p in loc:
                p.mul_(1e-3)
            b0, s0 = model.apply(x)
            b1, s1 = twin.apply(x)
    finally:
        with torch.no_grad():
            for p, v in zip(loc, saved):
                p.copy_(v)
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=SCORES_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", ["train phase", "bn", "quant"])
def test_guards(kind):
    if kind == "train phase":
        with pytest.raises(ValueError, match="inference-only"):
            build_refinedet("train", 320, NUM_CLASSES, device="cpu",
                            stem_s2d=True)
    else:
        with pytest.raises(ValueError, match="plain-model"):
            RefineDet(NUM_CLASSES, 320, use_bn=kind == "bn",
                      quant=kind == "quant", stem_s2d=True)


# -- the slice backward --------------------------------------------------------------

def _pool_cases():
    """``tests/test_model.py``'s cases (NHWC): tie-forcing quantized
    values, even and odd (ceil mode), with their cotangents."""
    rng = np.random.RandomState(0)
    x = np.round(rng.randn(2, 10, 12, 3).astype(np.float32) * 2) / 2
    return [(False, x, rng.randn(2, 5, 6, 3).astype(np.float32)),
            (True, x[:, :9, :11], rng.randn(2, 5, 6, 3).astype(np.float32))]


def _port_grad(mode, ceil, x_nhwc, r_nhwc, dtype=torch.float32):
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(
        0, 3, 1, 2).to(dtype).requires_grad_()
    r = torch.from_numpy(r_nhwc).permute(0, 3, 1, 2).to(dtype)
    with layers.pool_backward(mode):
        y = layers.MaxPool2x2(ceil)(x)
    (y * r).sum().backward()
    return y.detach(), x.grad


@pytest.mark.parametrize("case", [0, 1], ids=["even", "ceil-odd"])
def test_slice_backward_equals_jax_and_aten(case):
    ceil, x, r = _pool_cases()[case]
    prev = jlayers.POOL_BACKWARD
    try:
        jlayers.POOL_BACKWARD = "slice"
        want = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(
            jlayers.max_pool_2x2(a, ceil_mode=ceil) * r)))(jnp.asarray(x)))
    finally:
        jlayers.POOL_BACKWARD = prev
    y_s, g_s = _port_grad("slice", ceil, x, r)
    y_a, g_a = _port_grad("select_scatter", ceil, x, r)
    assert layers.POOL_BACKWARD == "select_scatter"
    got = g_s.permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert torch.equal(y_s, y_a)
    assert torch.equal(g_s.view(torch.int32), g_a.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,ceil", [((2, 8, 10, 12), False),
                                        ((2, 8, 9, 11), True),
                                        ((2, 8, 9, 11), False)],
                         ids=["even", "ceil-odd", "floor-odd"])
def test_slice_backward_channels_last_equals_aten(shape, ceil, dtype):
    """Channels-last in and out, ties forced; floor mode drops the odd
    row and column as ATen does."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = (torch.round(torch.randn(shape, generator=gen) * 2) / 2).to(
        dtype).contiguous(memory_format=torch.channels_last)
    out = {}
    for mode in layers.POOL_BACKWARDS:
        xx = x.clone().requires_grad_()
        with layers.pool_backward(mode):
            y = layers.MaxPool2x2(ceil)(xx)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)
                        ).to(dtype)
        y.backward(g)
        out[mode] = (y.detach(), xx.grad)
    (y_a, g_a), (y_s, g_s) = out["select_scatter"], out["slice"]
    view = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y_s.view(view), y_a.view(view))
    assert torch.equal(g_s.view(view), g_a.view(view))
    assert g_s.is_contiguous(memory_format=torch.channels_last)


def test_pool_backward_switch():
    with pytest.raises(ValueError, match="POOL_BACKWARD"):
        with layers.pool_backward("select_and_scatter"):
            pass
    with pytest.raises(RuntimeError):
        with layers.pool_backward("slice"):
            assert layers.POOL_BACKWARD == "slice"
            raise RuntimeError
    assert layers.POOL_BACKWARD == "select_scatter"
    # the trace summary files the slice backward's kernels under the
    # pool's backward
    assert categorize(["autograd::engine::evaluate_function: "
                       "MaxPool2dSliceBackward", "aten::eq"]) == \
        "max_pool2d backward"


# -- the demos -----------------------------------------------------------------------

def test_detect_image_matches_plain_detect_path(port):
    """``demo.detect_image`` on a 320x320 BGR image against the plain
    path on the heads of its own forward (the input checked against the
    eval preprocessing, mean-sub and BGR->RGB): ``RefineDetModel.apply``'s
    softmax, objectness filter and cascade decode, then greedy NMS per
    class (``ops/nms.py:nms``: top 200 above 0.01, IoU 0.45) and the JAX
    demo's drawing loop."""
    model = copy.copy(port["model"])
    seen = []

    def raw_forward(images):
        seen.append((images, port["model"].raw_forward(images)))
        return seen[-1][1]

    model.raw_forward = raw_forward
    img = np.random.RandomState(3).randint(0, 256, (320, 320, 3)).astype(
        np.uint8)
    rows = demo.detect_image(model, img, 0.6)
    (x, (arm_loc, arm_conf, odm_loc, odm_conf)), = seen
    rgb = (img.astype(np.float32) - np.float32([104, 117, 123]))[..., ::-1]
    assert torch.equal(x, torch.from_numpy(np.ascontiguousarray(rgb)[None]))
    with torch.inference_mode():
        boxes, scores = detect_refinedet(
            arm_loc, torch.softmax(arm_conf, -1), odm_loc,
            torch.softmax(odm_conf, -1), model.priors)
    want = []
    for cl in range(1, NUM_CLASSES):
        res = nms(boxes[0], scores[0, :, cl], 0.45, top_k=200,
                  score_thresh=0.01)
        for i, s in zip(res.indices[res.keep], res.scores[res.keep]):
            if float(s) < 0.6:
                break
            px = np.clip(boxes[0, i].numpy() * [320, 320, 320, 320],
                         -10_000, 10_000)
            want.append((cl, float(s), tuple(int(v) for v in px)))
    assert len(rows) > 0
    assert rows == want


def test_demo_main_writes_the_drawing(port, tmp_path, capsys, monkeypatch):
    """``main`` with random weights (seed 0: the fixture's model, which
    the build would draw again)."""
    built = []

    def build_model(size, num_classes, trained_model, device):
        built.append((size, num_classes, trained_model, device))
        return port["model"]

    monkeypatch.setattr(demo, "build_model", build_model)
    out = tmp_path / "demo.png"
    rows = demo.main(["--device", "cpu", "--out", str(out)])
    assert built == [(320, NUM_CLASSES, None, "cpu")]
    assert out.stat().st_size > 0
    text = capsys.readouterr().out
    assert f"{len(rows)} detections >= 0.6 drawn -> {out}" in text
    cv2 = demo.cv2
    assert cv2.imread(str(out)).shape == cv2.imread(
        str(REPO / "data" / "example.jpg")).shape


def test_demos_need_cv2(monkeypatch):
    monkeypatch.setattr(demo, "cv2", None)
    for tool in (demo, live):
        with pytest.raises(RuntimeError, match="cv2"):
            tool.main(["--device", "cpu"])


def test_live_without_a_camera(capsys):
    live.main(["--device", "cpu", "--camera", "97"])
    assert "no camera at index 97; exiting" in capsys.readouterr().out


# -- the bench tools -------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _jax_tool(name, argv, monkeypatch):
    """``tools/<name>.py`` imported by path with ``sys.argv`` set (its
    sys.path edit undone afterwards)."""
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["64"], ["64", "3"]],
                         ids=["defaults", "batch", "batch iters"])
def test_bench_pool_backward_command_line(argv, monkeypatch):
    jt = _jax_tool("bench_pool_backward", argv, monkeypatch)
    args = bench_pool_backward.parse_args(argv)
    assert (args.batch, args.iters, args.device) == (jt.BATCH, jt.ITERS,
                                                     "cuda")


@pytest.mark.parametrize("argv", [[], ["--batch", "8", "--iters", "3",
                                       "--size", "512"]],
                         ids=["defaults", "flags"])
def test_bench_stem_s2d_command_line(argv, monkeypatch):
    """The JAX tool parses inside ``main``: its namespace is caught
    there, before it builds anything."""
    jt = _jax_tool("bench_stem_s2d", argv, monkeypatch)
    parse = argparse.ArgumentParser.parse_args
    caught = {}

    def catch(self, args=None, namespace=None):
        caught["ns"] = parse(self, args, namespace)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        jt.main()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    args = bench_stem_s2d.parse_args(argv)
    assert vars(args) == {**vars(caught["ns"]), "device": "cuda"}


@pytest.mark.parametrize("tool", [bench_stem_s2d, bench_pool_backward],
                         ids=["stem", "pool"])
def test_benches_refuse_the_cpu(tool, monkeypatch):
    with pytest.raises(SystemExit, match="times the card"):
        tool.main(["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
