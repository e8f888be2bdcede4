"""Port parity: the eval CLIs ``refinedet_tpu_torch.eval.cli_coco`` and
``cli_voc`` against the JAX package's ``eval_refinedet_coco.main`` and
``eval_refinedet_voc.main`` on the tiny fixtures of tests/data_fixtures.py,
from the same bare ``.pth``, on the CPU (``--device cpu --dtype float32``,
RefineDet320, batch 2, top_k 50): the printed AP values agree, and so do
the result files (rows in the same order; boxes to the end-to-end
tolerance of test_torch_port_eval.py, scores to 1e-5, or to the files'
printed precision). Also: the int8 flags (each reaches the quantizer; one
real ``--int8 --save_quantized`` run and its re-read), the card default
and the checkpoint formats the loader refuses.
"""

import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import eval_refinedet_coco  # noqa: E402
import eval_refinedet_voc  # noqa: E402
from refinedet_tpu.data import BaseTransform as JBaseTransform  # noqa: E402
from refinedet_tpu.data import VOCDetection as JVOCDetection  # noqa: E402
from refinedet_tpu.models import builder as jbuilder  # noqa: E402
from refinedet_tpu.models.torch_import import \
    torch_state_dict_to_flax  # noqa: E402

from refinedet_tpu_torch.data import VOC_CLASSES  # noqa: E402
from refinedet_tpu_torch.eval import cli_coco, cli_voc  # noqa: E402
from refinedet_tpu_torch.models import build_refinedet  # noqa: E402

from data_fixtures import make_coco_dataset, make_voc_dataset  # noqa: E402
from test_torch_port_eval import (_jax_postprocess,  # noqa: E402
                                  _port_boxes_scores,
                                  assert_forward_boxes_close,
                                  assert_separated)

COMMON = ["--input_size", "320", "--batch_size", "2", "--top_k", "50",
          "--dtype", "float32", "--save_folder"]


@pytest.fixture(autouse=True)
def fast_flax_init(monkeypatch):
    """The JAX CLIs' ``.pth`` loader initialises the Flax model only to
    replace every weight from the file; Flax's init takes ~45 s on the
    CPU, so it is replaced by zeros of the same tree."""
    def init(self, rng, batch_size=1):
        shapes = jax.eval_shape(lambda: real(self, rng, batch_size))
        return jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), shapes)
    real = jbuilder.RefineDetModel.init
    monkeypatch.setattr(jbuilder.RefineDetModel, "init", init)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    """Seed-0 weights as a bare reference-key state_dict, 2 and 21
    classes. With 2 classes the random weights saturate the softmax (ties
    exact in both packages). With 21 they do not: the forwards' drift
    would reorder near-equal scores, and two cascaded decodes of random
    loc heads magnify it to ~4e-3 of a box's extent. So there the heads
    get zero weights and seeded biases (confidences spread over [-4, 4],
    offsets over [-0.5, 0.5]): a detection depends on its prior, class
    and anchor shape only (exact score ties, wide gaps), while the trunk
    still runs on the image."""
    out = {}
    rng = np.random.RandomState(0)
    for classes in (2, 21):
        path = tmp_path_factory.mktemp("w") / f"seed0_{classes}.pth"
        state = build_refinedet("test", 320, classes, device="cpu",
                                seed=0).net.state_dict()
        if classes == 21:
            spread = {"odm_conf": 4.0, "arm_loc": 0.5, "odm_loc": 0.5,
                      "arm_conf": 0.0}
            for k, v in state.items():
                head = k.split(".")[0]
                if head in spread:
                    state[k] = (torch.from_numpy(rng.uniform(
                        -spread[head], spread[head], v.shape).astype(
                            np.float32)) if k.endswith("bias")
                        else torch.zeros_like(v))
        torch.save(state, path)
        out[classes] = str(path)
    return out


def _jax_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    capsys.readouterr()
    result = module.main()
    return result, capsys.readouterr().out


def _port_main(module, argv, capsys):
    capsys.readouterr()
    result = module.main([*argv, "--device", "cpu"])
    return result, capsys.readouterr().out


def _line(out, prefix):
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert len(lines) == 1, out[-2000:]
    return lines[0]


def test_coco_cli_matches_jax(pth, tmp_path, monkeypatch, capsys):
    """The inputs of test_torch_port_eval.py's Evaluator tests (the same
    images, weights and settings), whose separation precondition
    test_evaluator_separated_seed asserts."""
    root = str(tmp_path / "coco")
    make_coco_dataset(root, split="test", num_images=4, img_size=96, seed=0)
    argv = ["--dataset_root", root, "--trained_model", pth[2],
            "--keep_top_k", "50"] + COMMON
    _, jout = _jax_main(eval_refinedet_coco,
                        argv + [str(tmp_path / "j")], monkeypatch, capsys)
    stats, tout = _port_main(cli_coco, argv + [str(tmp_path / "t")], capsys)
    assert _line(tout, "AP stats:") == _line(jout, "AP stats:")
    assert "FPS:" in tout and "Finished loading model!" in tout
    assert stats.shape == (12,)
    name = "weights/detections_sarship_test_results.json"
    got = json.loads((tmp_path / "t" / name).read_text())
    want = json.loads((tmp_path / "j" / name).read_text())
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == \
            (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5)
        assert_forward_boxes_close(g["bbox"], w["bbox"])


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    make_voc_dataset(str(root), image_set="test", num_images=4, img_size=96,
                     seed=1, classes=VOC_CLASSES[:4], difficult_prob=0.2)
    return str(root)


def test_voc_seed_is_separated(pth, voc_root):
    """The VOC test's precondition: on these images and weights the two
    forwards cannot disagree on a candidate's order or suppression. The
    heads do not depend on the image (checked), and the images share one
    size, so one image's heads stand for all."""
    from refinedet_tpu.config import DetectConfig as JDetectConfig
    from refinedet_tpu_torch.config import DetectConfig
    jmodel = jbuilder.build_refinedet("test", 320, 21)
    model = build_refinedet("test", 320, 21, device="cpu")
    state = torch.load(pth[21], weights_only=True)
    model.net.load_state_dict(state, strict=True)
    ds = JVOCDetection(voc_root, [("2007", "test")], None)
    raws = [ds.pull_image(i) for i in range(len(ds))]
    assert {r.shape for r in raws} == {(96, 96, 3)}
    imgs = np.stack([JBaseTransform(320, (104, 117, 123))(r) for r in raws])
    scales = np.array([[96.0] * 4], np.float32)
    cfg = DetectConfig(num_classes=21, nms_thresh=0.45)
    with torch.inference_mode():
        theads = model.raw_forward(torch.from_numpy(imgs))
        for h in theads:
            assert torch.equal(h, h[:1].expand_as(h))
        tboxes, tscores = _port_boxes_scores([h[:1] for h in theads],
                                             model.priors, cfg)
    jheads = [np.asarray(h) for h in jmodel.raw_forward(
        {"params": torch_state_dict_to_flax(state)}, imgs[:1])]
    _, jboxes, jscores = _jax_postprocess(
        jheads, model.priors.numpy(), scales,
        JDetectConfig(num_classes=21, nms_thresh=0.45), 50, False)
    assert_separated(jscores, tscores, jboxes, tboxes * scales[:, None], 50,
                     cfg, False)


def _read_results(path):
    rows = [ln.split() for ln in Path(path).read_text().splitlines()]
    return [r[0] for r in rows], np.array([r[1:] for r in rows], float)


def test_voc_cli_matches_jax(pth, voc_root, tmp_path, monkeypatch, capsys):
    argv = ["--voc_root", voc_root, "--image_set", "test",
            "--trained_model", pth[21], "--nms_top_k", "50"] + COMMON
    want, jout = _jax_main(eval_refinedet_voc, argv + [str(tmp_path / "j")],
                           monkeypatch, capsys)
    got, tout = _port_main(cli_voc, argv + [str(tmp_path / "t")], capsys)
    assert got == want
    assert _line(tout, "mAP:") == _line(jout, "mAP:")
    assert "(det_shift=1.0)" in _line(tout, "mAP:")
    n = 0
    for cls in VOC_CLASSES:
        name = f"voc2007/comp4_det_test_{cls}.txt"
        gids, grows = _read_results(tmp_path / "t" / name)
        wids, wrows = _read_results(tmp_path / "j" / name)
        assert gids == wids
        n += len(gids)
        if len(gids):
            # printed as %.3f (score) and %.1f (coordinates)
            np.testing.assert_allclose(grows[:, 0], wrows[:, 0], atol=1e-3)
            assert_forward_boxes_close(grows[:, 1:], wrows[:, 1:],
                                       atol=0.1)
    assert n > 10


class Reached(Exception):
    """Raised by the stubs once the flags reached the quantizer."""


class _Net:
    def load_state_dict(self, state, strict=True):
        pass

    def state_dict(self):
        return {}


def _stub_quantizer(monkeypatch, cli):
    """Replace the CLI's models and quantizer by stubs that record what
    reaches them (no network is built, no calibration runs). COCO: the
    calibration stream, calibrate_amax, accumulate_hessians and
    quantize_variables, whose small state goes on to ``--save_quantized``,
    and the Evaluator, whose run stops there. VOC: the calibration stream
    and quantize_model."""
    seen = {}

    def build(phase, size, num_classes, dtype=None, device=None,
              quant=False, quant_skip=()):
        return types.SimpleNamespace(net=_Net(), quant=quant,
                                     quant_skip=tuple(quant_skip),
                                     dtype=dtype)

    monkeypatch.setattr(cli, "build_refinedet", build)

    def calib(dataset, transform, num_images, batch_size):
        seen["calib"] = (num_images, batch_size)
        return iter([np.zeros((1, 320, 320, 3), np.float32)])

    monkeypatch.setattr(cli, "calib_batches_from_dataset", calib)
    if cli is cli_voc:
        def quantize_model(model, batches, **kw):
            seen["quantize_model"] = kw
            raise Reached
        monkeypatch.setattr(cli, "quantize_model", quantize_model)
        return seen

    def calibrate_amax(model, batches, return_means=False):
        seen["return_means"] = return_means
        return ({}, {"m": 1}) if return_means else {}

    def accumulate_hessians(model, batches, names=None):
        seen["hessians"] = True
        return {"h": 1}

    def quantize_variables(model_q, state, amax, **kw):
        seen["model_q"] = model_q
        seen.update(kw)
        return {"vgg.2.kernel_q": torch.zeros(2, dtype=torch.int8)}

    class Evaluator:
        def __init__(self, model, *args, **kwargs):
            seen["evaluated"] = model

        def run(self, state):
            seen["run"] = state
            raise Reached

    monkeypatch.setattr(cli, "calibrate_amax", calibrate_amax)
    monkeypatch.setattr(cli, "accumulate_hessians", accumulate_hessians)
    monkeypatch.setattr(cli, "quantize_variables", quantize_variables)
    monkeypatch.setattr(cli, "Evaluator", Evaluator)
    return seen


@pytest.mark.parametrize("cli", [cli_coco, cli_voc], ids=["coco", "voc"])
@pytest.mark.parametrize("flag", [
    ["--int8"], ["--calib_images", "4"], ["--calib_act_stat", "amax"],
    ["--quant_skip", ""], ["--bias_correct"], ["--weight_opt", "gptq"],
    ["--save_quantized", "q"]])
def test_int8_flags_reach_the_quantizer(cli, flag, pth, voc_root,
                                        tmp_path, monkeypatch):
    """Each int8 flag of each CLI is taken up and reaches the quantizer
    with its value (the JAX CLIs' defaults otherwise); the VOC CLI has no
    ``--save_quantized``, as JAX's has none."""
    if cli is cli_voc and flag[0] == "--save_quantized":
        with pytest.raises(SystemExit):  # no such flag in the VOC CLI
            cli.parse_args(["--trained_model", pth[21], *flag])
        return
    if flag[0] == "--save_quantized":
        flag = [flag[0], str(tmp_path / flag[1])]
    seen = _stub_quantizer(monkeypatch, cli)
    if cli is cli_coco:
        root = str(tmp_path / "coco")
        make_coco_dataset(root, split="test", num_images=2, img_size=64)
        data = ["--dataset_root", root]
    else:
        data = ["--voc_root", voc_root]
    argv = ["--trained_model", pth[21 if cli is cli_voc else 2], "--device",
            "cpu", "--input_size", "320", "--batch_size", "2", "--int8",
            *data, *([] if flag == ["--int8"] else flag)]
    with pytest.raises(Reached):
        cli.main(argv)
    opts = dict(calib_images=16, act_stat="p9999",
                quant_skip=("vgg_conv1_2", "vgg_conv2_1"),
                bias_correct=False, weight_opt="none")
    value = {"--calib_images": ("calib_images", 4),
             "--calib_act_stat": ("act_stat", "amax"),
             "--quant_skip": ("quant_skip", ()),
             "--bias_correct": ("bias_correct", True),
             "--weight_opt": ("weight_opt", "gptq")}.get(flag[0])
    if value is not None:
        opts[value[0]] = value[1]
    assert seen["calib"] == (opts["calib_images"], 2)
    if cli is cli_voc:
        got = seen["quantize_model"]
        assert (got["act_stat"], got["quant_skip"], got["bias_correct"],
                got["weight_opt"], got["dtype"]) == (
                    opts["act_stat"], opts["quant_skip"],
                    opts["bias_correct"], opts["weight_opt"],
                    torch.bfloat16)
        return
    assert seen["model_q"].quant and seen["evaluated"] is seen["model_q"]
    assert seen["model_q"].quant_skip == opts["quant_skip"]
    assert seen["act_stat"] == opts["act_stat"]
    assert seen["return_means"] == opts["bias_correct"]
    assert (seen["means"] is not None) == opts["bias_correct"]
    assert (seen["hessians"] is not None) == (opts["weight_opt"] == "gptq")
    assert list(seen["run"]) == ["vgg.2.kernel_q"]
    if flag[0] == "--save_quantized":
        saved = torch.load(flag[1], weights_only=True)
        assert saved["quant_skip"] == list(opts["quant_skip"])
        assert list(saved["model"]) == ["vgg.2.kernel_q"]


def test_int8_save_quantized_and_reread(pth, tmp_path, capsys):
    """A real ``--int8 --save_quantized`` run at 320 (2 calibration
    images), then the file read back: no recalibration and the same AP
    stats; another ``--quant_skip`` is refused before anything runs. The
    convs above 20x20 stay float (on the CPU the int8 conv is a float64
    convolution)."""
    skip = ("vgg_conv1_2,vgg_conv2_1,vgg_conv2_2,vgg_conv3_1,vgg_conv3_2,"
            "vgg_conv3_3,vgg_conv4_1,vgg_conv4_2,vgg_conv4_3,tcb0_0_conv1,"
            "tcb0_0_conv2,tcb2_0_conv")
    root = str(tmp_path / "coco")
    make_coco_dataset(root, split="test", num_images=2, img_size=64, seed=3)
    saved = str(tmp_path / "int8.pth")
    base = ["--dataset_root", root, "--keep_top_k", "50", "--int8",
            "--calib_images", "2"] + COMMON + [str(tmp_path / "e")]
    stats, out = _port_main(cli_coco, ["--trained_model", pth[2],
                                       "--save_quantized", saved,
                                       "--quant_skip", skip] + base, capsys)
    assert f"quantized variables saved -> {saved}" in out
    obj = torch.load(saved, weights_only=True)
    assert obj["quant_skip"] == skip.split(",")
    assert sum(k.endswith(".kernel_q") for k in obj["model"]) == 16
    again, out2 = _port_main(cli_coco, ["--trained_model", saved,
                                        "--quant_skip", skip] + base, capsys)
    assert "restored pre-quantized checkpoint" in out2
    assert _line(out2, "AP stats:") == _line(out, "AP stats:")
    np.testing.assert_array_equal(again, stats)
    with pytest.raises(ValueError, match="different --quant_skip.*lacks "
                       r"\['tcb0_0_conv1'.*'vgg_conv4_3'\]"):
        cli_coco.main(["--trained_model", saved, "--device", "cpu"] + base)


@pytest.mark.parametrize("cli", [cli_coco, cli_voc], ids=["coco", "voc"])
def test_cli_needs_card_unless_cpu(cli, pth, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--trained_model", pth[21]])  # the card is the default


def test_loader_formats(tmp_path):
    """A port checkpoint (raw and EMA weights), a bare state_dict with or
    without ``module.``, one under ``state_dict``; an Orbax directory and
    a missing EMA raise. (Small tensors: the loader reads the format, the
    strict load is Evaluator.run's.)"""
    load = cli_coco.make_loader()
    bare = {"vgg.0.weight": torch.randn(4, 3, 3, 3),
            "vgg.0.bias": torch.randn(4),
            "conv4_3_L2Norm.weight": torch.randn(4)}
    ema = {k: v + 1 for k, v in bare.items()}
    files = {"ckpt": {"step": 3, "model": bare, "optimizer": {}, "ema": ema},
             "noema": {"step": 3, "model": bare, "optimizer": {},
                       "ema": None},
             "module": {"module." + k: v for k, v in bare.items()},
             "wrapped": {"state_dict": bare}}
    for name, obj in files.items():
        torch.save(obj, tmp_path / f"{name}.pth")
    for name in ("ckpt", "noema", "module", "wrapped"):
        got = load(tmp_path / f"{name}.pth")
        assert got.keys() == bare.keys()
        assert all(torch.equal(got[k], bare[k]) for k in bare)
    got = cli_coco.make_loader(use_ema=True)(tmp_path / "ckpt.pth")
    assert got.keys() == bare.keys()
    assert all(torch.equal(got[k], ema[k]) for k in bare)
    with pytest.raises(ValueError, match="no EMA"):
        cli_coco.make_loader(use_ema=True)(tmp_path / "noema.pth")
    with pytest.raises(ValueError, match="no EMA"):
        cli_coco.make_loader(use_ema=True)(tmp_path / "module.pth")
    orbax = tmp_path / "RefineDet320_COCO_epoches_final"
    orbax.mkdir()
    with pytest.raises(ValueError, match="Orbax.*state_dict_from_flax"):
        load(orbax)


def test_coco_sweep_cli(pth, tmp_path, capsys):
    """--sweep on the reference schedule: the epochs found are evaluated,
    the others print MISSING; an Orbax directory in the schedule raises
    with its reason."""
    root = str(tmp_path / "coco")
    make_coco_dataset(root, split="test", num_images=2, img_size=64, seed=2)
    prefix = tmp_path / "weights"
    prefix.mkdir()
    bare = torch.load(pth[2], weights_only=True)
    torch.save(bare, prefix / "RefineDet320_COCO_epoches_250.pth")
    torch.save({"step": 1, "model": bare, "optimizer": {}, "ema": None},
               prefix / "RefineDet320_COCO_epoches_final.pth")
    argv = ["--dataset_root", root, "--sweep", "--prefix", str(prefix),
            "--keep_top_k", "50", "--device", "cpu"] + COMMON + [
                str(tmp_path / "eval")]
    stats = cli_coco.main(argv)
    out = capsys.readouterr().out
    assert stats["epoch"] == [250, 300]
    assert out.count("MISSING") == 19 and "epoch 255: MISSING" in out
    assert "best ap: " in out
    saved = json.loads((tmp_path / "eval" / "weights" /
                        "ap_stats.json").read_text())
    assert saved == stats
    assert (tmp_path / "eval" / "weights" / "ap_curve.png").stat().st_size
    # a directory in the schedule is swept, and the loader refuses it
    (prefix / "RefineDet320_COCO_epoches_200").mkdir()
    paths, epochs = cli_coco.sweep_checkpoints(str(prefix), 320)
    assert epochs == [200, 250, 300] and paths[0].endswith("epoches_200")
    with pytest.raises(ValueError, match="Orbax"):
        cli_coco.make_loader()(paths[0])


def test_show_image_needs_cv2(monkeypatch, tmp_path):
    monkeypatch.setattr(cli_coco, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        cli_coco.draw_detections([], [], str(tmp_path))


def test_plot_utils_match_jax(tmp_path):
    """``utils/plot.py``: the log parser equals the JAX package's on the
    train log's lines (NaN losses included), and the plots are written."""
    from refinedet_tpu.utils import plot as jplot
    from refinedet_tpu_torch.utils import plot
    log = tmp_path / "log.txt"
    log.write_text("".join(
        f"Epoch:1/1 || Epochiter: {i}/3 || Iter: {i}/3 || ARM_L Loss: "
        f"{1.5 / i:.4f} ARM_C Loss: {2.25 / i:.4f} ODM_L Loss: "
        f"{'nan' if i == 2 else f'{0.5 / i:.4f}'} ODM_C Loss: 1.0000 loss: "
        f"{5.25 / i:.4f} || LR: {1e-3 * i:.8f} || Batchtime: 0.1 s\n"
        for i in (1, 2, 3)) + "not a loss line\n")
    got, want = plot.parse_log(str(log)), jplot.parse_log(str(log))
    assert got.keys() == want.keys() and len(got["iter"]) == 3
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert plot.plot_loss(str(log), str(tmp_path / "loss.png"), smooth=2)
    live = plot.LivePlotter(str(tmp_path / "live"), render_every=2)
    for i in range(1, 4):
        live.update(i, {k: float(i) for k in plot.LivePlotter._KEYS})
    live.end_epoch(1)
    assert live.epoch_series["loss"] == [2.0]
    assert (tmp_path / "live" / "live_loss.png").exists()
