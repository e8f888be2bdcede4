"""Port parity: the trained-fixture tools (``refinedet_tpu_torch/tools``)
against the JAX repo's ``tools/*.py`` and test fixtures, on the CPU.

* the fixtures' 160² draws and COCO dicts equal, bitwise, what
  ``tests/data_fixtures.py:make_coco_dataset`` writes and the sequence of
  ``tools/smoke_multiclass.py:38-58``; the bilinear upsample is within
  one grey level of ``cv2.resize``; the training targets equal the JAX
  tools' (``COCODetection`` at 160², divided by 160) bitwise;
* the three lr schedules equal their optax counterparts to f32 rounding;
* the noise controls equal JAX's ``noise_params`` bitwise after
  conversion; the arm table and ``resolve_quant_skip`` equal
  ``tools/ablate_int8.py``'s; the flags and defaults are the JAX tools';
* the EMA shadow update equals JAX's ``ema_update`` to f32 rounding;
* ``drive``/``_leg_stats`` equal ``tools/bench_serve.py``'s on a fake
  ``submit_fn`` that fails some requests;
* the slice end to end, port only: ``ablate_int8.run_seed`` at 320 in f32
  (2 steps, 4 images, batch 2) and its resume from the weights cache and
  the results sidecar;
* the slice against JAX: ``fixture_train.ap_of`` and JAX's Evaluator with
  ``evaluate_detections`` on the same converted weights and fixture
  images (lossless PNGs for JAX): the same AP;
* the VOC smoke through the real CLIs (``smoke_voc_e2e``): its fixture
  writer's files byte for byte those of ``tests/data_fixtures.py:
  make_voc_dataset``, and the argv it hands each CLI JAX's tool's (both
  tools run with the CLIs and the writer stubbed: no training here).

Every test that quantizes runs with one torch thread (a module fixture).
"""

import ast
import importlib.util
import json
import os
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import data_fixtures  # noqa: E402
from refinedet_tpu.models.torch_import import \
    torch_state_dict_to_flax  # noqa: E402

from refinedet_tpu_torch.config import MEANS  # noqa: E402
from refinedet_tpu_torch.models import (build_refinedet,  # noqa: E402
                                        state_dict_from_flax)
from refinedet_tpu_torch.models.refinedet import \
    quantizable_names  # noqa: E402
from refinedet_tpu_torch.tools import (ablate_ema, ablate_int8,  # noqa: E402
                                       bench_serve, fixture_train,
                                       fixtures, smoke_voc_e2e)
from refinedet_tpu_torch.tools.fixtures import (coco_draws,  # noqa: E402
                                                coco_fixture,
                                                multiclass_draws)

TOOLS = ("smoke_e2e", "smoke_multiclass", "smoke_int8", "ablate_int8",
         "calib_study", "ablate_ema", "bench_serve", "bench_int8",
         "int8_witness", "trace_infer", "trace_train_step",
         "profile_train_step", "flops_train_step", "smoke_voc_e2e")


def _jax_tool(name):
    """``tools/<name>.py`` of the JAX repo, imported by path (only the
    modules whose top level defines functions)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the quantizing tests' CPU work contends with the
    other xdist workers' thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- fixtures -----------------------------------------------------------------

@pytest.mark.parametrize("n, seed", [(16, 3), (5, 0)])
def test_coco_draws_equal_make_coco_dataset(n, seed, tmp_path, monkeypatch):
    written = []
    fake_cv2 = types.SimpleNamespace(
        imwrite=lambda path, img: written.append(img.copy()) or True)
    monkeypatch.setattr(data_fixtures, "cv2", fake_cv2)
    want = data_fixtures.make_coco_dataset(str(tmp_path), num_images=n,
                                           img_size=160, seed=seed)
    images, got = coco_draws(n, seed)
    assert got == want
    assert len(images) == len(written) == n
    for a, b in zip(images, written):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_multiclass_draws_equal_smoke_multiclass():
    """``tools/smoke_multiclass.py:38-58`` restated (that tool runs at
    import), without its file writes."""
    rng = np.random.RandomState(0)
    COLORS = {1: (230, 60, 60), 2: (60, 230, 60), 3: (60, 60, 230)}
    images, annotations, infos = [], [], []
    ann_id = 1
    for i in range(16):
        img_id = i + 1
        img = rng.randint(0, 60, (160, 160, 3)).astype(np.uint8)
        for _ in range(rng.randint(1, 4)):
            w, h = rng.randint(20, 70, 2)
            x, y = rng.randint(0, 160 - w), rng.randint(0, 160 - h)
            cls = rng.randint(1, 4)
            img[y:y + h, x:x + w] = COLORS[cls]
            annotations.append({"id": ann_id, "image_id": img_id,
                                "category_id": cls,
                                "bbox": [float(x), float(y),
                                         float(w), float(h)],
                                "area": float(w * h), "iscrowd": 0})
            ann_id += 1
        images.append(img)
        infos.append({"id": img_id, "file_name": f"{img_id:06d}.jpg",
                      "width": 160, "height": 160})
    want = {"images": infos, "annotations": annotations,
            "categories": [{"id": c, "name": n, "supercategory": "x"}
                           for c, n in [(1, "red"), (2, "green"),
                                        (3, "blue")]]}
    got_images, got = multiclass_draws()
    assert got == want
    for a, b in zip(got_images, images):
        np.testing.assert_array_equal(a, b)
    ds = fixtures.multiclass_fixture(160, device="cpu")
    assert ds.num_classes == 4 and len(ds) == 16


@pytest.mark.parametrize("size", [320, 512])
def test_upsample_within_one_grey_level_of_cv2(size):
    """The fixtures' upsample against the ``cv2.resize`` inside JAX's
    ``BaseTransform`` (float32, INTER_LINEAR, not rounded): at most one
    grey level apart."""
    images, _ = coco_draws(3, 7)
    got = fixtures.upsample(images, size, "cpu")
    assert got.dtype == np.uint8 and got.shape == (3, size, size, 3)
    for img, g in zip(images, got):
        want = cv2.resize(img.astype(np.float32), (size, size),
                          interpolation=cv2.INTER_LINEAR)
        assert np.abs(g.astype(np.float32) - want).max() <= 1.0


@pytest.mark.parametrize("size", [320, 512])
def test_fixture_targets_equal_jax_tools(size, tmp_path):
    """Training targets: the JAX tools' ``boxes / [w, h, w, h]`` from
    ``COCODetection`` at 160² (bitwise); eval ground truth: the 160²
    bboxes in the held image's pixels."""
    from refinedet_tpu.data import COCODetection as JCOCODetection

    data_fixtures.make_coco_dataset(str(tmp_path), num_images=6,
                                    img_size=160, seed=3)
    jds = JCOCODetection(str(tmp_path), [("sarship", "train")], None)
    ds = coco_fixture(6, 3, size, "cpu")
    assert len(ds) == len(jds) == 6 and ds.num_classes == 2
    _, coco = coco_draws(6, 3)
    s = size / 160
    for i in range(6):
        img, boxes, labels = jds[i]
        h, w = img.shape[:2]
        sb = boxes / np.array([w, h, w, h], np.float32)
        assert ds.targets[i][0].dtype == sb.dtype == np.float32
        np.testing.assert_array_equal(ds.targets[i][0], sb)
        np.testing.assert_array_equal(ds.targets[i][1], labels)
        assert ds.images[i].shape == (size, size, 3)
    gt = ds._COCO.loadAnns(ds._COCO.getAnnIds())
    assert [a["bbox"] for a in gt] == [[v * s for v in a["bbox"]]
                                       for a in coco["annotations"]]


@pytest.mark.parametrize("patterns", [False, True],
                         ids=["rects", "silhouettes"])
def test_make_voc_dataset_writes_jax_files(patterns, tmp_path):
    """The port's VOC writer against ``tests/data_fixtures.py``'s: the same
    ids, and every file (JPEGs, XML annotations, the image-set list) byte
    for byte, at 64 px with every class drawn."""
    kw = dict(year="2012", image_set="trainval", num_images=6, img_size=64,
              seed=3, classes=smoke_voc_e2e.CLASSES,
              class_patterns=patterns)
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    want = data_fixtures.make_voc_dataset(str(jax_root), **kw)
    assert fixtures.make_voc_dataset(str(port_root), **kw) == want

    def files(root):
        return sorted(p.relative_to(root) for p in root.rglob("*")
                      if p.is_file())

    names = files(jax_root)
    assert files(port_root) == names and len(names) == 2 * 6 + 1
    for name in names:
        assert (port_root / name).read_bytes() == \
            (jax_root / name).read_bytes(), name
    xml = "".join(p.read_text() for p in
                  (port_root / "VOC2012" / "Annotations").iterdir())
    assert all(f"<name>{c}</name>" in xml for c in smoke_voc_e2e.CLASSES)


@pytest.mark.parametrize("ap0", [0.5, 0.1], ids=["passes", "misses"])
def test_smoke_voc_e2e_argv_matches_jax(ap0, tmp_path, monkeypatch,
                                        capsys):
    """Both tools on one work directory with ``--ema_decay 0.5``, the CLIs
    and the fixture writer stubbed: the same writer calls, and each CLI's
    argv, less ``--device cpu`` and the checkpoint's ``.pth``, JAX's. A
    run that clears the threshold makes all four passes; one that misses
    it stops after the first eval in both tools, the port's JSON line
    printed first with the check that failed."""
    jtool = _jax_tool("smoke_voc_e2e")
    root = str(tmp_path)
    aps = {c: ap0 + 0.1 * i for i, c in enumerate(smoke_voc_e2e.CLASSES)}
    miss = ap0 + 0.15 < 0.30
    calls = {"jax": [], "port": []}
    writes = {"jax": [], "port": []}

    def finish_training(argv, name):
        save = argv[argv.index("--save_folder") + 1]
        os.makedirs(save, exist_ok=True)
        open(os.path.join(save, name), "w").close()

    def jax_train():
        calls["jax"].append(sys.argv[1:])
        finish_training(sys.argv, "RefineDet320_VOC_epoches_final")

    def jax_eval():
        calls["jax"].append(sys.argv[1:])
        return dict(aps)

    def port_train(argv):
        calls["port"].append(argv)
        finish_training(argv, "RefineDet320_VOC_epoches_final.pth")

    def port_eval(argv):
        calls["port"].append(argv)
        return dict(aps)

    def writer(side):
        return lambda *a, **k: writes[side].append((a, k))

    monkeypatch.setitem(sys.modules, "train_refinedet",
                        types.SimpleNamespace(main=jax_train))
    monkeypatch.setitem(sys.modules, "eval_refinedet_voc",
                        types.SimpleNamespace(main=jax_eval))
    monkeypatch.setitem(sys.modules, "data_fixtures", types.SimpleNamespace(
        make_voc_dataset=writer("jax")))
    flags = ["--root", root, "--ema_decay", "0.5"]
    monkeypatch.setattr(sys, "argv", ["smoke_voc_e2e.py"] + flags)
    if miss:
        with pytest.raises(AssertionError, match="below 0.3"):
            jtool.main()
    else:
        jtool.main()

    monkeypatch.setattr(smoke_voc_e2e, "make_voc_dataset", writer("port"))
    monkeypatch.setattr(smoke_voc_e2e, "train_cli",
                        types.SimpleNamespace(main=port_train))
    monkeypatch.setattr(smoke_voc_e2e, "cli_voc",
                        types.SimpleNamespace(main=port_eval))
    capsys.readouterr()
    if miss:
        with pytest.raises(RuntimeError, match="below 0.3"):
            smoke_voc_e2e.main(flags + ["--device", "cpu"])
    else:
        smoke_voc_e2e.main(flags + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])

    assert writes["port"] == writes["jax"] and len(writes["jax"]) == 3
    assert len(calls["jax"]) == len(calls["port"]) == (2 if miss else 4)
    if not miss:
        assert calls["jax"][2].count("--use_ema") == 1
        assert calls["jax"][3][-3:] == ["--int8", "--calib_images", "16"]
    for want, got in zip(calls["jax"], calls["port"]):
        assert got[-2:] == ["--device", "cpu"]
        got = [a[:-len(".pth")] if a.endswith("_final.pth") else a
               for a in got[:-2]]
        assert got == want
    mean = sum(aps.values()) / 4
    assert out["mean_ap"] == pytest.approx(mean)
    if miss:
        assert out["failed"].startswith("mean AP") and out["int8"] is None
    else:
        assert out["failed"] is None
        assert out["ema"]["delta"] == out["int8"]["drop"] == 0.0


def test_smoke_voc_e2e_refuses_without_cv2(tmp_path, monkeypatch):
    """Without cv2 the tool stops before it writes anything, and the
    writer with an error that names it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="smoke_voc_e2e .*cv2"):
        smoke_voc_e2e.main(["--device", "cpu", "--root", str(tmp_path)])
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="make_voc_dataset .*cv2"):
        fixtures.make_voc_dataset(str(tmp_path))
    assert not os.listdir(tmp_path)


# -- schedules ----------------------------------------------------------------

ULP2 = 2 * float(np.spacing(np.float32(5e-4)))


def _optax_schedules(steps):
    lr = 5e-4
    ramp = optax.linear_schedule(1e-5, lr, 100)
    return {
        "warmup": (fixture_train.warmup_schedule(), ramp),
        "multiclass": (fixture_train.multiclass_schedule(),
                       optax.join_schedules(
                           [optax.linear_schedule(1e-5, lr, 100),
                            optax.constant_schedule(lr),
                            optax.constant_schedule(lr * 0.1)],
                           [100, 1200])),
        "decay": (fixture_train.decay_schedule(steps),
                  optax.join_schedules(
                      [optax.linear_schedule(1e-5, lr, 100),
                       optax.constant_schedule(lr * 0.1)],
                      [int(steps * 0.75)])),
    }


@pytest.mark.parametrize("name", ["warmup", "multiclass", "decay"])
def test_schedules_match_optax(name):
    """f32 rounding: optax computes in float32, ``(init - end) * frac +
    end``, so within rtol 1e-6 or two f32 ulps of the peak lr 5e-4."""
    steps = 2500
    b = int(0.75 * steps)
    ts = sorted({0, 1, 99, 100, 101, b - 1, b, b + 1, 1199, 1200,
                 steps - 1, 2, 50})
    port, want = _optax_schedules(steps)[name]
    for t in ts:
        np.testing.assert_allclose(port(t), float(want(t)), rtol=1e-6,
                                   atol=ULP2, err_msg=f"t={t}")
    # a short run's boundary falls inside the ramp: later pieces get
    # t - boundary
    port, want = _optax_schedules(40)["decay"]
    for t in range(40):
        np.testing.assert_allclose(port(t), float(want(t)), rtol=1e-6,
                                   atol=ULP2)


# -- noise controls and the arm table -----------------------------------------

@pytest.fixture(scope="module")
def trained_like():
    """Seed-5 RefineDet320 (2 classes) weights as the port's state_dict
    and as JAX's trained params tree (``jax.device_get`` of a pytree,
    keys sorted as the JAX tools see them)."""
    state = build_refinedet("test", 320, 2, device="cpu", seed=5) \
        .net.state_dict()
    params = jax.device_get(jax.tree.map(
        jnp.asarray, torch_state_dict_to_flax(state)))
    return state, params


def _jax_noise_params(params, seed, extra_skip):
    """``tools/ablate_int8.py:160-173`` restated (a closure there)."""
    rng = np.random.RandomState(seed)
    pn = dict(params)
    for name, leaves in params.items():
        if "kernel" not in leaves or name.startswith(("arm_", "odm_")) \
                or name == "vgg_conv1_1" or "deconv" in name \
                or name in extra_skip:
            continue
        w = np.asarray(leaves["kernel"], np.float32)
        s = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
        pn[name] = dict(leaves)
        pn[name]["kernel"] = jnp.asarray(
            w + rng.uniform(-0.5, 0.5, w.shape).astype(np.float32) * s)
    return {"params": pn}


@pytest.mark.parametrize("arm", ["noise-ctl-default", "noise-ctl-full"])
def test_noise_state_matches_jax_noise_params(trained_like, arm):
    from refinedet_tpu.quant import DEFAULT_QUANT_SKIP as JSKIP

    state, params = trained_like
    extra = {"noise-ctl-default": JSKIP, "noise-ctl-full": ()}[arm]
    assert tuple(extra) == tuple(ablate_int8.NOISE_SKIP[arm])
    want = state_dict_from_flax(jax.device_get(
        _jax_noise_params(params, 4, extra)))
    got = ablate_int8.noise_state(state, 4, ablate_int8.NOISE_SKIP[arm])
    moved = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        moved += not torch.equal(got[k], state[k])
    # the weight of every quantizable conv but the arm's skip set
    assert moved == len(quantizable_names()) - len(extra)


def test_arm_table_matches_jax():
    jtool = _jax_tool("ablate_int8")
    assert ablate_int8.INT8_CONFIGS == jtool.INT8_CONFIGS
    assert ablate_int8.ALL_CONFIGS == jtool.ALL_CONFIGS
    for skip in (None, (), ("vgg_conv2_2",)):
        assert tuple(ablate_int8.resolve_quant_skip(skip)) == \
            tuple(jtool.resolve_quant_skip(skip))


def _flags(path):
    """{flag: default} of every ``add_argument`` in a module's source
    (positional arguments included, by name)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            name = node.args[0].value
            default = next((k.value for k in node.keywords
                            if k.arg == "default"), None)
            try:
                out[name] = ast.literal_eval(default) if default else None
            except ValueError:  # a computed default
                out[name] = ast.unparse(default)
    return out


@pytest.mark.parametrize("tool", ["ablate_int8", "calib_study",
                                  "ablate_ema", "bench_serve",
                                  "smoke_voc_e2e"])
def test_tool_flags_match_jax(tool):
    """The JAX tool's flags with its defaults, plus ``--device``."""
    want = _flags(REPO / "tools" / f"{tool}.py")
    got = _flags(REPO / "refinedet_tpu_torch" / "tools" / f"{tool}.py")
    if tool == "ablate_ema":  # a computed default, the same DECAYS
        assert ablate_ema.DECAYS == _jax_tool_decays()
        want.pop("--decays"), got.pop("--decays")
    assert got.pop("--device") == "cuda"
    assert got == want


def _jax_tool_decays():
    tree = ast.parse((REPO / "tools" / "ablate_ema.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "DECAYS":
            return ast.literal_eval(node.value)


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_run_on_the_card_by_default(tool):
    """No card here: every tool refuses to start unless asked for the
    CPU."""
    mod = importlib.import_module(f"refinedet_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


# -- EMA ----------------------------------------------------------------------

@pytest.mark.parametrize("decay", ablate_ema.DECAYS)
def test_ema_shadow_matches_jax(decay):
    """``tools/ablate_ema.py:80-84`` (a closure there) restated; the decay
    ``d`` bitwise, the shadows to f32 rounding over t = 1..20 (rtol
    1e-6: one rounding a step)."""
    @jax.jit
    def ema_update(ema, params, t):
        d = jnp.minimum(jnp.float32(decay), (1.0 + t) / (10.0 + t))
        return jax.tree.map(
            lambda e, p: e * d + p.astype(e.dtype) * (1.0 - d), ema, params)

    rng = np.random.RandomState(0)
    e0 = rng.randn(2, 513).astype(np.float32)
    want = [jnp.asarray(e0[0]), jnp.asarray(e0[1])]
    got = [torch.from_numpy(e0[0].copy()), torch.from_numpy(e0[1].copy())]
    for t in range(1, 21):
        p = rng.randn(2, 513).astype(np.float32)
        d = jnp.minimum(jnp.float32(decay),
                        (1.0 + jnp.float32(t)) / (10.0 + jnp.float32(t)))
        assert ablate_ema.ema_decay(decay, t) == np.float32(d)
        want = ema_update(want, [jnp.asarray(p[0]), jnp.asarray(p[1])],
                          jnp.float32(t))
        ablate_ema.ema_update_(got, [torch.from_numpy(p[0]),
                                     torch.from_numpy(p[1])], decay, t)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


# -- load-test helpers --------------------------------------------------------

def test_drive_and_leg_stats_match_jax():
    """A fake ``submit_fn`` failing every request whose image is 3 or 5
    of the 8: the same errors, counts and statistics (on the same
    latencies) as ``tools/bench_serve.py``'s."""
    jtool = _jax_tool("bench_serve")
    images = [np.full((2, 2, 3), i, np.float32) for i in range(8)]

    def submit(img):
        if img[0, 0, 0] in (3, 5):
            raise ValueError(f"bad {int(img[0, 0, 0])}")
        return img

    runs = []
    for mod in (bench_serve, jtool):
        wall, lat, errors = mod.drive(submit, images, 4, 37)
        runs.append((wall, lat, sorted(errors, key=lambda e: int(
            e.split()[1].rstrip(":")))))
    (_, lat_p, err_p), (_, lat_j, err_j) = runs
    assert err_p == err_j and len(err_p) == 9
    assert lat_p.size == lat_j.size == 28
    for lat, wall, err in ((lat_j, 0.5, err_j),
                           (np.array([]), 0.5, err_j),
                           (lat_j, 0.25, [])):
        assert bench_serve._leg_stats(lat, wall, err) == \
            jtool._leg_stats(lat, wall, err)


# -- the slice end to end -----------------------------------------------------

def test_summarize_matches_numpy():
    rows = [{"bf16": {"ap": 0.5, "ap50": 0.9}, "x": {"ap": 0.4, "ap50": 0.8}},
            {"bf16": {"ap": 0.7, "ap50": 1.0}, "x": {"ap": 0.5, "ap50": 0.8}}]
    lines = []
    out = fixture_train.summarize(rows, "bf16", log=lines.append)
    assert out["x"]["ap"]["delta_mean"] == pytest.approx(-0.15)
    assert out["x"]["ap"]["std"] == pytest.approx(np.std([0.4, 0.5]))
    assert lines[1] == "            x:   AP 0.4500 +- 0.0500   delta vs " \
        "bf16 -0.1500 +- 0.0500"


def test_gptq_hessians_in_float64_under_autocast(monkeypatch):
    """GPTQ's Hessians of a bf16 model: its calibration hooks run inside
    the model's autocast, where ``hessian_of`` must not compute in bf16
    (it did, and failed to convert); it accumulates in float64, a few
    rows at a time, to the float64 Gram matrix of the patches (rtol
    1e-12: the chunks' sums in another order)."""
    from refinedet_tpu_torch.quant import gptq

    x = torch.randn(2, 8, 9, 9, generator=torch.Generator().manual_seed(0))
    p = torch.nn.functional.unfold(x.bfloat16().double(), 3, padding=1)
    pm = p.transpose(1, 2).reshape(-1, 72)
    monkeypatch.setattr(gptq, "HESSIAN_ROWS", 50)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got, n = gptq.hessian_of(x.bfloat16(), 3, 3, 1, 1, 1)
    assert got.dtype == torch.float64 and n == 162
    torch.testing.assert_close(got, pm.T @ pm, rtol=1e-12, atol=0)


def test_run_seed_end_to_end_and_resume(tmp_path, monkeypatch):
    """``run_seeds`` (``run_seed`` behind the sidecar) at 320 in f32 on
    the CPU: 2 steps on 2 images at batch 1, three arms. The steps run
    first, through the call ``run_seed`` makes (``trained_state``, which
    trains and caches them); ``run_seeds`` then restores the weights from
    the cache (no step) and scores the arms; a second run restores the
    sidecar's arms (no scoring)."""
    configs = {"bf16", "noise-ctl-default", "int8-default"}
    lines = []
    state = fixture_train.trained_state(
        1, 320, 2, 1, coco_fixture(2, 1, 320, "cpu"), "cpu", str(tmp_path),
        torch.float32, lines.append)
    assert "seed 1: 2 steps in" in lines[-1]
    cached = tmp_path / "refinedet320_s1_st2_b1.pt"
    want = torch.load(cached)
    assert state.keys() == want.keys() and all(
        torch.equal(state[k], want[k]) for k in want)

    def no_training(*a, **k):
        raise AssertionError("trained again")

    monkeypatch.setattr(fixture_train, "train_from_scratch", no_training)
    kw = dict(cache_dir=str(tmp_path), dtype=torch.float32, n_images=2,
              log=lines.append)
    lines.clear()
    rows = ablate_int8.run_seeds([1], 320, 2, 1, configs, "cpu", **kw)
    assert "cache is NOT code-versioned" in lines[0]
    assert lines[-1].startswith("seed 1: bf16=")
    assert list(rows[0]) == ["bf16", "noise-ctl-default", "int8-default"]
    for r in rows[0].values():
        assert set(r) == {"ap", "ap50"} and 0.0 <= r["ap"] <= 1.0
    sidecar = tmp_path / "results_320_st2_b1.json"
    assert json.loads(sidecar.read_text()) == {"1": rows[0]}

    monkeypatch.setattr(ablate_int8, "score_arms", no_training)
    lines.clear()
    assert ablate_int8.run_seeds([1], 320, 2, 1, configs, "cpu",
                                 **kw) == rows
    assert lines == [f"seed 1: restored results from {sidecar}"]


def test_ap_of_matches_jax_evaluator(tmp_path, monkeypatch):
    """The same converted weights and the same 4 fixture images at 320
    through the port's ``ap_of`` and JAX's Evaluator (batch 4,
    ``nms_top_k`` 128, +1 areas) with ``evaluate_detections``: equal AP.
    JAX reads the images from lossless PNGs, at 320 its resize is the
    identity. The loc heads are zeroed, so the boxes are the priors
    (sane boxes, some on the ground truth) and the AP is not 0; the run's
    precondition is the eval tests' (scores and IoUs separated beyond
    the two forwards' drift)."""
    from refinedet_tpu.config import DetectConfig as JDetectConfig
    from refinedet_tpu.data import BaseTransform as JBaseTransform
    from refinedet_tpu.data import COCODetection as JCOCODetection
    from refinedet_tpu.eval import Evaluator as JEvaluator
    from refinedet_tpu.models import build_refinedet as jbuild

    from refinedet_tpu.detect.detection import detect_refinedet as jdetect
    from test_torch_port_eval import _port_boxes_scores, assert_separated
    from refinedet_tpu_torch.config import DetectConfig
    from refinedet_tpu_torch.eval import evaluator as evaluator_module

    size, n = 320, 4
    ds = coco_fixture(n, 0, size, "cpu")
    model = build_refinedet("test", size, 2, device="cpu", seed=2)
    state = {k: torch.zeros_like(v) if k.startswith(("arm_loc.",
                                                       "odm_loc."))
             else v.clone() for k, v in model.net.state_dict().items()}
    theads = []

    def recording(heads, *args):  # the port's heads, from ap_of's run
        theads.append(heads)
        return post(heads, *args)

    post = evaluator_module.eval_postprocess
    monkeypatch.setattr(evaluator_module, "eval_postprocess", recording)
    got = fixture_train.ap_of(model, state, ds)

    root = tmp_path / "coco"
    (root / "sarship_train").mkdir(parents=True)
    (root / "annotations").mkdir()
    coco = json.loads(json.dumps(ds._COCO.dataset))
    for im, img in zip(coco["images"], ds.images):
        im["file_name"] = im["file_name"].replace(".jpg", ".png")
        cv2.imwrite(str(root / "sarship_train" / im["file_name"]), img)
    (root / "annotations" / "instances_sarship_train.json").write_text(
        json.dumps(coco))
    jds = JCOCODetection(str(root), [("sarship", "train")], None)
    jbt = JBaseTransform(size, MEANS)
    jmodel = jbuild("test", size, 2)
    variables = {"params": torch_state_dict_to_flax(state)}
    jev = JEvaluator(jmodel, jds, JDetectConfig(num_classes=2), jbt,
                     batch_size=n, nms_top_k=128, log=lambda s: None)
    heads = []
    fused = jax.jit(lambda v, x, s: (jev._forward_postprocess(v, x, s),
                                     jmodel.raw_forward(v, x)))
    jev._fn = lambda v, x, s: (lambda out: heads.append(out[1]) or out[0])(
        fused(v, x, s))
    stats = jds.evaluate_detections(jev.run(variables), None)

    imgs = np.stack([jbt(jds.pull_image(i)[0]) for i in range(n)])
    np.testing.assert_array_equal(imgs, fixture_train.eval_images(ds, n))
    scales = np.full((n, 4), size, np.float32)
    cfg = DetectConfig(num_classes=2)
    al, ac, ol, oc = heads[0]
    jboxes, jscores = (np.asarray(a) for a in jdetect(
        al, jax.nn.softmax(ac, axis=-1), ol, jax.nn.softmax(oc, axis=-1),
        jmodel.priors, variances=cfg.variance,
        objectness_thresh=cfg.objectness_thresh))
    jboxes = jboxes * scales[:, None]
    assert len(theads) == 1
    tboxes, tscores = _port_boxes_scores(theads[0], model.priors, cfg)
    assert_separated(jscores, tscores, jboxes, tboxes * scales[:, None],
                     128, cfg, True)
    assert got == {"ap": float(stats[0]), "ap50": float(stats[1])}
    assert got["ap50"] > 0
