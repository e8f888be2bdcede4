"""Port parity: the serving function, the batching engine and the HTTP
front end of ``refinedet_tpu_torch.serve``, on the CPU; and the port's
import boundary (torch, numpy and the standard library only)."""

import ast
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

from refinedet_tpu.detect.detection import \
    detect_refinedet as jdetect  # noqa: E402
from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402
from refinedet_tpu.boxes.geometry import iou_pairwise as jiou  # noqa: E402
from refinedet_tpu.serve.export import export_inference  # noqa: E402

from refinedet_tpu_torch.detect.detection import \
    detect_refinedet  # noqa: E402
from refinedet_tpu_torch.models import (build_refinedet,  # noqa: E402
                                        state_dict_from_flax)
from refinedet_tpu_torch.serve import (BatchingEngine, Server,  # noqa: E402
                                       client_detect, make_serving_fn)
from refinedet_tpu_torch.serve import server as port_server  # noqa: E402

from test_torch_port_model import min_score_gap  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NUM_CLASSES = 3
NMS_THRESH = 0.49  # DetectConfig's default, which fused_nms={} takes
TOP_K = 200


@pytest.fixture(scope="module")
def pair():
    jmodel = jbuild("test", 320, NUM_CLASSES)
    variables = jmodel.init(jax.random.PRNGKey(0))
    model = build_refinedet("test", 320, NUM_CLASSES, device="cpu")
    fn = make_serving_fn(model, state_dict_from_flax(variables),
                         fused_nms={})
    return jmodel, variables, model, fn


def _image(seed, batch=1):
    return np.random.RandomState(seed).randn(batch, 320, 320, 3).astype(
        np.float32)


def test_serving_matches_export_inference(pair):
    jmodel, variables, model, fn = pair
    img = _image(4)
    got = fn(img)
    want = np.asarray(export_inference(
        jmodel, variables, fused_nms={}, platforms=("cpu",)).call(img))
    assert got.shape == want.shape == (1, NUM_CLASSES - 1, TOP_K, 5)

    # Preconditions, so that a failure below is a real difference: the
    # two forwards' scores differ by less than half of any gap between
    # the candidates' scores (no reordering), and no candidate pair's IoU
    # lies within 1e-3 of the NMS threshold (no flipped suppression).
    jheads = [np.asarray(h) for h in jmodel.raw_forward(variables,
                                                        jnp.asarray(img))]
    soft = lambda h: jax.nn.softmax(jnp.asarray(h), axis=-1)  # noqa: E731
    jboxes, jscores = jdetect(jheads[0], soft(jheads[1]), jheads[2],
                              soft(jheads[3]), jmodel.priors)
    jboxes, jscores = np.asarray(jboxes), np.asarray(jscores)
    with torch.inference_mode():
        h = model.raw_forward(torch.from_numpy(img))
        _, scores = detect_refinedet(h[0], h[1].softmax(-1), h[2],
                                     h[3].softmax(-1), model.priors)
    drift = float(np.abs(scores.numpy() - jscores).max())
    assert min_score_gap(jscores, TOP_K, 0.01) > 2 * drift
    for c in range(1, NUM_CLASSES):
        order = np.argsort(-jscores[0, :, c], kind="stable")[:TOP_K]
        cand = order[jscores[0, order, c] > 0.01]
        iou = np.array(jiou(jboxes[0, cand], jboxes[0, cand]))
        np.fill_diagonal(iou, 0.0)
        assert np.abs(iou - NMS_THRESH).min() > 1e-3

    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    assert (got[..., 4] > 0).sum() > 10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_uint8_wire_exact_vs_f32(pair):
    _, _, model, fn = pair
    raw = np.random.RandomState(7).randint(0, 256, (1, 320, 320, 3)).astype(
        np.uint8)
    fn_u8 = make_serving_fn(model, None, fused_nms={}, uint8_input=True)
    pre = raw.astype(np.float32) - np.asarray((123.0, 117.0, 104.0),
                                              np.float32)
    np.testing.assert_array_equal(fn_u8(raw), fn(pre))


def test_serving_fn_validation(pair):
    _, _, model, fn = pair
    with pytest.raises(ValueError, match="plus_one.*pixel-space"):
        make_serving_fn(model, None, fused_nms={"plus_one": True})
    with pytest.raises(ValueError, match="unknown keys.*top_k_typo"):
        make_serving_fn(model, None, fused_nms={"top_k_typo": 3})
    with pytest.raises(ValueError, match="images"):
        fn(np.zeros((1, 300, 300, 3), np.float32))
    train = build_refinedet("train", 320, NUM_CLASSES, device="cpu")
    with pytest.raises(ValueError, match="test"):
        make_serving_fn(train, None)
    # Without fused_nms the function returns the model's (boxes, scores).
    boxes, scores = make_serving_fn(model, None)(_image(1))
    assert boxes.shape == (1, 6375, 4)
    assert scores.shape == (1, 6375, NUM_CLASSES)


def test_batching_engine_and_http(pair):
    """Concurrent single-image requests through the engine and over HTTP,
    answered by the port's CPU serving function."""
    _, _, _, fn = pair
    engine = BatchingEngine(fn, (320, 320, 3), max_batch=4,
                            max_delay_ms=50.0)
    results, errors = {}, []

    def client(tid):
        try:
            futs = [engine.submit(_image(10 * tid + i)[0]) for i in range(2)]
            results[tid] = [f.result(timeout=120) for f in futs]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    with Server(engine, {"input_size": 320}) as srv:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        http = [client_detect("127.0.0.1", srv.port, _image(99)[0],
                              timeout=120)]
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
        stats = engine.stats()
    assert not errors
    assert stats["errors"] == 0 and stats["requests"] == 7
    outs = [o for r in results.values() for o in r] + http
    assert len(outs) == 7
    for (dets,) in outs:
        assert dets.shape == (NUM_CLASSES - 1, TOP_K, 5)
        assert np.isfinite(dets).all()


def test_main_needs_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_server.main(["--seed", "0"])


def test_main_loads_training_checkpoints(tmp_path):
    """``--checkpoint`` reads a port training checkpoint (its ``model``)
    and a ``module.``-prefixed reference ``.pth``, as the eval CLIs do."""
    src = build_refinedet("test", 320, NUM_CLASSES, device="cpu", seed=5)
    weights = src.net.state_dict()
    files = {"ckpt.pth": {"step": 3, "model": weights, "optimizer": {},
                          "ema": None},
             "module.pth": {"module." + k: v for k, v in weights.items()}}
    for name, obj in files.items():
        torch.save(obj, tmp_path / name)
        args = port_server.parse_args([
            "--checkpoint", str(tmp_path / name), "--device", "cpu",
            "--num_classes", str(NUM_CLASSES)])
        model = port_server.load_model(args)
        assert model.phase == "test"
        for k, v in model.net.state_dict().items():
            assert torch.equal(v, weights[k]), (name, k)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((REPO / "refinedet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    pkg = REPO / "refinedet_tpu_torch"
    assert {pkg / "quant" / "ptq.py", pkg / "quant" / "gptq.py",
            pkg / "quant" / "__init__.py", pkg / "ops" / "int8_conv.py",
            pkg / "ops" / "cuda_build.py", pkg / "utils" / "timer.py",
            pkg / "utils" / "trace_summary.py",
            pkg / "models" / "initializers.py",
            pkg / "models" / "stem_s2d.py"} | {
        pkg / "tools" / f"{t}.py" for t in (
            "trace_infer", "trace_train_step", "profile_train_step",
            "flops_train_step", "bench_stem_s2d", "bench_pool_backward",
            "ab_turns", "demo", "live")} <= set(files)
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                "refinedet_tpu", "tools", "tests",
                                "data_fixtures"), \
                f"{path} imports {name}"


def test_port_imports_without_cv2():
    """Every module of the port imports where cv2 is missing (the card
    machine has none): the data modules and the eval CLIs guard their cv2
    import. Without cv2 the in-memory eval sets still go through
    ``BaseTransform`` (their images are already at the model's size), and
    another size raises."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['cv2'] = None\n"
        "import refinedet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'refinedet_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert {'refinedet_tpu_torch.eval.cli_coco', "
        "'refinedet_tpu_torch.eval.cli_voc', "
        "'refinedet_tpu_torch.eval.evaluator', "
        "'refinedet_tpu_torch.ops.nms_native', "
        "'refinedet_tpu_torch.tools.eval_check', "
        "'refinedet_tpu_torch.tools.demo', "
        "'refinedet_tpu_torch.tools.live'} <= set(names)\n"
        "from refinedet_tpu_torch.tools import demo\n"
        "assert demo.cv2 is None\n"
        "from refinedet_tpu_torch.data import augmentations\n"
        "assert augmentations.cv2 is None\n"
        "from refinedet_tpu_torch.tools.eval_check import SyntheticVOC\n"
        "t = augmentations.BaseTransform(64)\n"
        "assert t(SyntheticVOC(1, 64).pull_image(0)).shape == (64, 64, 3)\n"
        "try:\n"
        "    t(SyntheticVOC(1, 32).pull_image(0))\n"
        "    raise SystemExit('resized without cv2')\n"
        "except RuntimeError as e:\n"
        "    assert 'needs cv2' in str(e)\n"
        "print(len(names))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert int(run.stdout.split()[-1]) > 37
