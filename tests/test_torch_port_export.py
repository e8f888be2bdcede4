"""Port parity: the serving artifact of ``refinedet_tpu_torch.serve``
(``export_inference``, ``save_serving``, ``load_serving``), the export CLI
``refinedet_tpu_torch.tools.export_serving`` (``--int8`` included) and
the server's ``--artifact``, on the CPU, against the JAX package's
artifact and the port's live serving function.

One module fixture gives both packages the same RefineDet320 weights (2
classes), saves them once as a port ``.pth``, and exports each artifact
once: the fused-NMS artifact through the CLI, the rest through the
library. Random 2-class heads on noise images give scores packed around
0.5, closer to each other than the two forwards' drift, so the ODM
confidence head gets zero weights and seeded biases (as the VOC CLI
test's heads do): a score then depends on its prior's level and anchor
shape only, with exact ties (kept in index order by both packages) and
wide gaps, while the boxes and the ARM still run on the image.
"""

import copy
import json
import struct
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
from refinedet_tpu.models.torch_export import \
    save_torch_checkpoint  # noqa: E402
from refinedet_tpu.models.torch_import import \
    torch_state_dict_to_flax  # noqa: E402
from refinedet_tpu.serve import export as jexport  # noqa: E402

from refinedet_tpu_torch.config import DetectConfig  # noqa: E402
from refinedet_tpu_torch.detect.detection import \
    detect_refinedet  # noqa: E402
from refinedet_tpu_torch.models import (build_refinedet,  # noqa: E402
                                        state_dict_from_flax)
from refinedet_tpu_torch.serve import (BatchingEngine,  # noqa: E402
                                       client_detect, export_inference,
                                       load_serving, make_serving_fn,
                                       save_serving)
from refinedet_tpu_torch.serve import export as port_export  # noqa: E402
from refinedet_tpu_torch.serve import server as port_server  # noqa: E402
from refinedet_tpu_torch.quant import (DEFAULT_QUANT_SKIP,  # noqa: E402
                                       quantize_variables)
from refinedet_tpu_torch.tools import export_serving  # noqa: E402
from refinedet_tpu_torch.tools.int8_bench import made_up_stats  # noqa: E402

from test_torch_port_eval import assert_separated  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NUM_CLASSES = 2
SIZE = 320
PRIORS = 6375


def _images(seed, batch=1):
    return np.random.RandomState(seed).randn(batch, SIZE, SIZE, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Both packages' weights, the port ``.pth``, and every artifact."""
    d = tmp_path_factory.mktemp("artifacts")
    seeded = build_refinedet("test", SIZE, NUM_CLASSES, device="cpu",
                             seed=3).net.state_dict()
    rng = np.random.RandomState(3)
    for k, v in seeded.items():
        if k.startswith("odm_conf."):
            seeded[k] = torch.from_numpy(rng.uniform(-4, 4, v.shape).astype(
                np.float32)) if k.endswith("bias") else torch.zeros_like(v)
    variables = {"params": torch_state_dict_to_flax(seeded)}
    state = state_dict_from_flax(variables)
    pth = d / "weights.pth"
    torch.save(state, pth)

    fused = d / "fused.rdtpu"
    export_serving.main(["--checkpoint", str(pth), "--out", str(fused),
                         "--device", "cpu", "--dtype", "float32",
                         "--num_classes", str(NUM_CLASSES), "--fused_nms"])
    model = build_refinedet("test", SIZE, NUM_CLASSES, device="cpu")
    raw = d / "raw.rdtpu"
    save_serving(model, state, str(raw))
    u8 = d / "uint8.rdtpu"
    save_serving(model, None, str(u8), batch_size=2, fused_nms={},
                 uint8_input=True)

    jmodel = jbuild("test", SIZE, NUM_CLASSES)
    jfused = d / "jax.rdtpu"
    jmeta = jexport.save_serving(jmodel, variables, str(jfused),
                                 platforms=("cpu",), fused_nms={})
    return {"dir": d, "pth": pth, "state": state, "variables": variables,
            "model": model, "jmodel": jmodel, "jmeta": jmeta,
            "fused": fused, "raw": raw, "uint8": u8, "jax": jfused,
            "serving": load_serving(str(fused)),
            "live": make_serving_fn(model, None, fused_nms={})}


def test_fused_artifact_matches_jax_artifact(art):
    """The port's fused artifact and JAX's (``platforms=("cpu",)``) on
    the same image: the same kept rows, boxes and scores to 1e-5, under
    the precondition that the forwards' drift can neither reorder
    candidates nor flip a suppression."""
    img = _images(4)
    got = art["serving"](img)
    want = np.asarray(jexport.load_serving(str(art["jax"]))(img))
    assert got.shape == want.shape == (1, NUM_CLASSES - 1, 200, 5)

    jmodel, model = art["jmodel"], art["model"]
    jheads = jmodel.raw_forward(art["variables"], jnp.asarray(img))
    jboxes, jscores = jdetect(jheads[0], jax.nn.softmax(jheads[1], -1),
                              jheads[2], jax.nn.softmax(jheads[3], -1),
                              jmodel.priors)
    with torch.inference_mode():
        h = model.raw_forward(torch.from_numpy(img))
        tboxes, tscores = detect_refinedet(h[0], h[1].softmax(-1), h[2],
                                           h[3].softmax(-1), model.priors)
    assert_separated(np.asarray(jscores), tscores.numpy(),
                     np.asarray(jboxes), tboxes.numpy(), 200,
                     DetectConfig(num_classes=NUM_CLASSES), False)

    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    assert (got[..., 4] > 0).sum() > 10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 3])
def test_symbolic_batch_equals_live_function(art, batch):
    """One symbolic-batch file, bit for bit the live serving function."""
    serving = art["serving"]
    assert serving.meta["batch_size"] is None
    img = _images(10 + batch, batch)
    got = serving(img)
    assert got.shape == (batch, NUM_CLASSES - 1, 200, 5)
    assert (got[..., 4] > 0).sum() > 10 * batch
    np.testing.assert_array_equal(got, art["live"](img))


def test_raw_artifact_matches_apply(art):
    img = _images(5, 2)
    boxes, scores = load_serving(str(art["raw"]))(img)
    with torch.inference_mode():
        want_b, want_s = art["model"].apply(torch.from_numpy(img))
    assert boxes.shape == (2, PRIORS, 4)
    assert scores.shape == (2, PRIORS, NUM_CLASSES)
    np.testing.assert_array_equal(boxes, want_b.numpy())
    np.testing.assert_array_equal(scores, want_s.numpy())


def test_uint8_wire_exact_vs_f32(art):
    """Raw pixels, mean-subtracted inside the artifact by the reference
    means (BGR 104, 117, 123, reversed), equal the f32 path on the
    host-subtracted images."""
    serving = load_serving(str(art["uint8"]))
    assert serving.meta["input_dtype"] == "uint8"
    assert serving.meta["input_mean_bgr"] == [104.0, 117.0, 123.0]
    raw = np.random.RandomState(7).randint(0, 256, (2, SIZE, SIZE, 3)) \
        .astype(np.uint8)
    pre = raw.astype(np.float32) - np.asarray((123.0, 117.0, 104.0),
                                              np.float32)
    np.testing.assert_array_equal(serving(raw), art["live"](pre))


def test_fixed_batch_guard(art):
    serving = load_serving(str(art["uint8"]))
    assert serving.meta["batch_size"] == 2
    with pytest.raises(ValueError, match="exported for batch 2"):
        serving(np.zeros((1, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(ValueError, match="exported for batch 2"):
        serving.warm_up((1, 2))


@pytest.mark.parametrize("case", ["train_phase", "mean_without_uint8",
                                  "unknown_key", "plus_one"])
def test_export_refusals(art, case):
    model, kwargs = art["model"], {}
    if case == "train_phase":
        model = copy.copy(model)
        model.phase = "train"
        match = "'test'-phase"
    elif case == "mean_without_uint8":
        kwargs = {"input_mean": (98.0, 98.0, 98.0)}
        match = "input_mean only applies with uint8_input"
    elif case == "unknown_key":
        kwargs = {"fused_nms": {"top_k_typo": 3}}
        match = "unknown keys.*top_k_typo"
    else:
        kwargs = {"fused_nms": {"plus_one": True}}
        match = "plus_one.*pixel-space"
    with pytest.raises(ValueError, match=match):
        export_inference(model, **kwargs)


def test_each_loader_refuses_the_other_package(art, tmp_path):
    with pytest.raises(ValueError, match="artifact of the JAX package"):
        load_serving(str(art["jax"]))
    with pytest.raises(ValueError, match="not a refinedet-tpu serving"):
        jexport.load_serving(str(art["fused"]))
    junk = tmp_path / "junk.rdtpu"
    junk.write_bytes(b"NOTANARTIFACT" * 4)
    with pytest.raises(ValueError, match="not a refinedet-tpu-torch"):
        load_serving(str(junk))


def test_metadata_keys(art):
    meta = art["serving"].meta
    want = (set(art["jmeta"]) - {"platforms", "jax_version"}) | \
        {"device", "dtype", "torch_version", "quant_skip"}
    assert set(meta) == want and meta["quant_skip"] is None
    assert meta["format"] == "refinedet-tpu-torch-serving"
    assert (meta["input_size"], meta["num_classes"], meta["use_bn"],
            meta["int8"]) == (SIZE, NUM_CLASSES, False, False)
    assert (meta["device"], meta["dtype"], meta["fused_nms"],
            meta["input_dtype"], meta["input_mean_bgr"]) == \
        ("cpu", "float32", {}, "float32", None)
    assert meta["output"] == art["jmeta"]["output"]
    assert meta["torch_version"] == torch.__version__


def test_cuda_artifact_refused_without_card(art, tmp_path, monkeypatch):
    """The loader never moves an artifact: one exported on the card needs
    a card, and is refused before anything is deserialized."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = art["fused"].read_bytes()
    n = len(port_export.MAGIC)
    (hlen,) = struct.unpack("<I", blob[n:n + 4])
    meta = json.loads(blob[n + 4:n + 4 + hlen])
    meta["device"] = "cuda:0"
    header = json.dumps(meta).encode()
    path = tmp_path / "cuda.rdtpu"
    path.write_bytes(blob[:n] + struct.pack("<I", len(header)) + header
                     + blob[n + 4 + hlen:])
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        load_serving(str(path))


def test_load_serving_builds_no_model_class(art):
    code = (
        "import sys, numpy as np\n"
        "from refinedet_tpu_torch.serve.export import load_serving\n"
        f"s = load_serving({str(art['fused'])!r})\n"
        "out = s(np.zeros((1, 320, 320, 3), np.float32))\n"
        "assert out.shape == (1, 1, 200, 5), out.shape\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('refinedet_tpu_torch.models', 'refinedet_tpu.', 'jax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split()[-1] == "ok"


def test_server_serves_the_cli_artifact(art):
    """The CLI's artifact through the server's ``--artifact`` path: the
    engine from several threads and HTTP, the artifact's metadata as
    ``/meta``; model flags are refused beside ``--artifact``."""
    with pytest.raises(SystemExit):
        port_server.parse_args(["--artifact", str(art["fused"]),
                                "--size", "512"])
    args = port_server.parse_args(["--artifact", str(art["fused"]),
                                   "--port", "0", "--max_batch", "2",
                                   "--max_delay_ms", "50"])
    srv = port_server.make_server(args)
    assert isinstance(srv.engine, BatchingEngine)
    assert srv.engine.buckets == (1, 2)
    results, errors = [], []

    def client(tid):
        try:
            futs = [srv.engine.submit(_images(20 + 2 * tid + i)[0])
                    for i in range(2)]
            results.extend(f.result(timeout=120) for f in futs)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    with srv:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        results.append(client_detect("127.0.0.1", srv.port, _images(30)[0],
                                     timeout=120))
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
        stats = srv.engine.stats()
    assert not errors
    assert stats["errors"] == 0 and stats["requests"] == 5
    assert len(results) == 5
    for (dets,) in results:
        assert dets.shape == (NUM_CLASSES - 1, 200, 5)
        assert np.isfinite(dets).all() and (dets[..., 4] > 0).sum() > 10


@pytest.mark.parametrize("use_ema", [False, True])
def test_torch_format_matches_jax(art, tmp_path, use_ema):
    """``--format torch`` writes what JAX's ``save_torch_checkpoint``
    writes from the same weights, key for key (with ``--use_ema``, the
    EMA weights of a training checkpoint)."""
    state, variables = art["state"], art["variables"]
    src = art["pth"]
    if use_ema:
        ema = {k: v + 0.5 for k, v in state.items()}
        src = tmp_path / "ckpt.pth"
        torch.save({"step": 1, "model": state, "optimizer": {}, "ema": ema},
                   src)
        variables = {"params": torch_state_dict_to_flax(ema)}
    out = tmp_path / "port.pth"
    export_serving.main(["--format", "torch", "--checkpoint", str(src),
                         "--out", str(out), "--num_classes",
                         str(NUM_CLASSES)] + ["--use_ema"] * use_ema)
    want_path = tmp_path / "jax.pth"
    save_torch_checkpoint(variables, str(want_path))
    got = torch.load(out, weights_only=True)
    want = torch.load(want_path, weights_only=True)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# The convs above 20x20 stay float: on the CPU the int8 conv is its plain
# version, a float64 convolution, and at 320 the high-resolution ones
# would make each int8 forward seconds long.
HIRES_SKIP = DEFAULT_QUANT_SKIP + (
    "vgg_conv2_2", "vgg_conv3_1", "vgg_conv3_2", "vgg_conv3_3",
    "vgg_conv4_1", "vgg_conv4_2", "vgg_conv4_3", "tcb0_0_conv1",
    "tcb0_0_conv2", "tcb2_0_conv")


@pytest.fixture(scope="module")
def int8_pth(art):
    """The fixture's weights quantized (made-up per-channel statistics, no
    calibration forward) with ``HIRES_SKIP``, as ``cli_coco --int8
    --save_quantized`` writes them."""
    model_q = build_refinedet("test", SIZE, NUM_CLASSES, device="cpu",
                              quant=True, quant_skip=HIRES_SKIP)
    state_q = quantize_variables(model_q, art["state"],
                                 made_up_stats(model_q.net, 4))
    model_q.net.load_state_dict(state_q, strict=True)
    path = art["dir"] / "int8.pth"
    torch.save({"model": state_q, "quant_skip": list(HIRES_SKIP)}, path)
    return path, model_q


def test_int8_artifact_round_trip(art, int8_pth, tmp_path):
    """``--int8`` through the CLI: every quantized conv one
    ``refinedet_tpu_torch::int8_conv`` node, ``"int8": true`` with its
    skip in the metadata, the loaded artifact equal to the live int8
    function, and the server's ``--artifact`` answering with it."""
    path, model_q = int8_pth
    out = tmp_path / "int8.rdtpu"
    export_serving.main(["--int8", "--checkpoint", str(path), "--out",
                         str(out), "--device", "cpu", "--dtype", "float32",
                         "--num_classes", str(NUM_CLASSES), "--fused_nms",
                         "--quant_skip", ",".join(HIRES_SKIP)])
    serving = load_serving(str(out))
    assert serving.meta["int8"] is True
    assert serving.meta["quant_skip"] == list(HIRES_SKIP)
    nodes = sum("int8_conv" in str(node.target)
                for mod in serving.program.graph_module.modules()
                if isinstance(mod, torch.fx.GraphModule)
                for node in mod.graph.nodes)
    assert nodes == 28 - len(HIRES_SKIP) == 16
    imgs = _images(40)
    got = serving(imgs)
    want = make_serving_fn(model_q, None, fused_nms={})(imgs)
    assert got.shape == (1, NUM_CLASSES - 1, 200, 5)
    np.testing.assert_array_equal(got, want)
    srv = port_server.make_server(port_server.parse_args(
        ["--artifact", str(out), "--port", "0", "--max_batch", "1"]))
    with srv:
        (dets,) = srv.engine.submit(imgs[0]).result(timeout=120)
    np.testing.assert_array_equal(dets, got[0])


@pytest.mark.parametrize("case", ["unquantized", "quant_skip",
                                  "format_torch"])
def test_int8_refusals(art, int8_pth, tmp_path, case):
    """The JAX exporter's ``--int8`` refusals: a checkpoint with no
    quantized convs, a ``--quant_skip`` other than the checkpoint's, and
    ``--format torch``."""
    ckpt = art["pth"] if case == "unquantized" else int8_pth[0]
    argv = ["--int8", "--checkpoint", str(ckpt), "--out",
            str(tmp_path / "q.rdtpu"), "--device", "cpu"]
    if case == "quant_skip":  # the default skip against HIRES_SKIP
        with pytest.raises(ValueError, match="different --quant_skip"):
            export_serving.main(argv)
        return
    match = {"unquantized": "holds no quantized convs",
             "format_torch": "--format serving only"}[case]
    with pytest.raises(SystemExit, match=match):
        export_serving.main(argv + ["--format", "torch"] * (
            case == "format_torch"))
