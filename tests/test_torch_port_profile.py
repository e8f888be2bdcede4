"""Port parity: profiling on ``refinedet_tpu_torch`` against the JAX
package's tools, on the CPU.

``utils/timer.py`` (``profile_trace`` and ``span`` as its scope's range),
``utils/trace_summary.py`` on a hand-written Chrome trace with known
kernels, launches, annotations and gaps (exact numbers) and on a real
CPU trace, and the four tools (``trace_infer``, ``trace_train_step``,
``profile_train_step``, ``flops_train_step``): their command lines
against the JAX tools' module-level parsing, ``profile_train_step``'s
``full`` against ``make_train_step`` bitwise, and the FLOP count against
``conv_flops`` and against XLA's ``cost_analysis()``. The refusal
without a card is ``test_torch_port_tools.py``'s ``TOOLS`` case. Forwards
run at 128 px, batch 1, one torch thread.
"""

import copy
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from refinedet_tpu.models import build_refinedet as jbuild  # noqa: E402

from refinedet_tpu_torch.boxes.priors import generate_priors  # noqa: E402
from refinedet_tpu_torch.config import TrainConfig  # noqa: E402
from refinedet_tpu_torch.models import build_refinedet  # noqa: E402
from refinedet_tpu_torch.tools import (flops_train_step,  # noqa: E402
                                       profile_train_step, trace_infer,
                                       trace_train_step)
from refinedet_tpu_torch.tools.train_check import conv_flops  # noqa: E402
from refinedet_tpu_torch.train.train_step import (  # noqa: E402
    create_train_state, make_optimizer, make_train_step)
from refinedet_tpu_torch.utils import timer, trace_summary  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL = 128


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- utils/timer ---------------------------------------------------------------

def test_profile_trace_none_is_a_noop(tmp_path):
    with timer.profile_trace(None) as prof:
        with timer.span("nothing"):
            torch.ones(2).sum()
    assert prof is None


def test_profile_trace_needs_the_card_unless_asked(tmp_path):
    """No card here: the default ``cuda`` refuses; ``cpu`` traces."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with timer.profile_trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t").exists()


# -- utils/trace_summary on a hand-written trace ------------------------------

def _x(cat, name, ts, dur, tid=1, pid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _kernel(name, ts, dur, corr, stream=7):
    return _x("kernel", name, ts, dur, tid=stream, pid=0, correlation=corr)


def _launch(ts, corr, name="cudaLaunchKernel", tid=1):
    return _x("cuda_runtime", name, ts, 2.0, tid=tid, correlation=corr)


def _handwritten_trace():
    """Two annotated executions on the host (a nested annotation inside
    the first is not an execution), and the device events they launch:

    infer/0 (host 100-400): a cuDNN conv (two kernels, one an NHWC
      transpose), a bf16 cast, a layout copy; device 1000-1060.
    infer/1 (host 450-750): K1's op launching two kernels, a memcpy under
      a plain ``copy_``, a softmax, a graph replay's kernel (no op), and a
      kernel on a second stream that overlaps another; device 1100-1180.
    A kernel launched outside both executions counts in the split only.
    """
    ev = [{"ph": "M", "name": "process_name", "pid": 7, "tid": 0,
           "args": {"name": "python"}},
          _x("user_annotation", "infer/0", 100.0, 300.0),
          _x("user_annotation", "Optimizer.step#SGD.step", 300.0, 50.0),
          _x("user_annotation", "infer/1", 450.0, 300.0),
          # infer/0
          _x("cpu_op", "aten::conv2d", 110.0, 100.0),
          _x("cpu_op", "aten::convolution", 115.0, 90.0),
          _x("cpu_op", "aten::cudnn_convolution", 120.0, 80.0),
          _launch(130.0, 1), _kernel("sm90_xmma_fprop_bf16", 1000.0, 30.0, 1),
          _launch(140.0, 2), _kernel("nchwToNhwcKernel", 1030.0, 5.0, 2),
          _x("cpu_op", "aten::to", 220.0, 30.0),
          _x("cpu_op", "aten::_to_copy", 221.0, 28.0),
          _x("cpu_op", "aten::copy_", 222.0, 20.0),
          _launch(225.0, 3), _kernel("elementwise_cast", 1040.0, 4.0, 3),
          _x("cpu_op", "aten::contiguous", 260.0, 30.0),
          _x("cpu_op", "aten::clone", 261.0, 28.0),
          _x("cpu_op", "aten::copy_", 262.0, 20.0),
          _launch(265.0, 4), _kernel("copy_kernel", 1050.0, 10.0, 4),
          # infer/1
          _x("cpu_op", "refinedet_tpu_torch::nms_sweep", 460.0, 60.0),
          _launch(470.0, 5), _kernel("nms_sweep_kernel", 1100.0, 20.0, 5),
          _launch(480.0, 6), _kernel("nms_prefilter", 1120.0, 10.0, 6),
          _x("cpu_op", "aten::copy_", 530.0, 20.0),
          _launch(535.0, 7, "cudaMemcpyAsync"),
          _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1130.0, 6.0,
             tid=7, pid=0, correlation=7),
          _x("cpu_op", "aten::_softmax", 560.0, 20.0),
          _launch(565.0, 8), _kernel("softmax_warp", 1140.0, 20.0, 8),
          _launch(600.0, 9, "cudaGraphLaunch"),
          _kernel("graph_node", 1150.0, 30.0, 9, stream=9),
          # outside both executions
          _x("cpu_op", "aten::add", 800.0, 10.0),
          _launch(805.0, 10), _kernel("add_kernel", 1300.0, 1.0, 10),
          # an instant event and a flow event are ignored
          {"ph": "i", "cat": "cpu_instant_event", "name": "x", "pid": 7,
           "tid": 1, "ts": 500.0},
          {"ph": "s", "cat": "ac2g", "name": "f", "id": 1, "pid": 7,
           "tid": 1, "ts": 130.0}]
    return {"traceEvents": ev}


def _write(tmp_path, trace, name="host.1.pt.trace.json"):
    d = tmp_path / "trace"
    d.mkdir(exist_ok=True)
    (d / name).write_text(json.dumps(trace))
    return str(d)


def test_summary_of_a_handwritten_trace(tmp_path):
    stats = trace_summary.trace_stats(_write(tmp_path, _handwritten_trace()))
    ex = stats["executions"]
    assert [x["name"] for x in ex] == ["infer/0", "infer/1"]
    # infer/0: 1000-1035, 1040-1044, 1050-1060 -> busy 49 of span 60
    # infer/1: 1100-1136 and 1140-1180 -> busy 76 of span 80
    assert [x["busy_ms"] for x in ex] == [0.049, 0.076]
    assert [x["span_ms"] for x in ex] == [0.060, 0.080]
    assert [x["events"] for x in ex] == [4, 5]
    assert stats["gaps_ms"] == [0.040]
    assert stats["busy_ms"] == 0.125 and stats["span_ms"] == 0.180
    assert stats["idle_pct"] == pytest.approx(100 * 55 / 180, abs=1e-12)
    assert stats["categories_ms"] == {
        "convolution": 0.035, "cast (_to_copy)": 0.004,
        "layout copy": 0.010, "nms_sweep (K1)": 0.030, "memcpy": 0.006,
        "softmax": 0.020, "no launching op": 0.030, "elementwise": 0.001}
    assert stats["device_total_ms"] == pytest.approx(
        sum(stats["categories_ms"].values()), abs=1e-12)
    assert stats["kernel_counts"]["nms_sweep_kernel"] == 1
    assert stats["kernel_ops_ms"]["[convolution] nchwToNhwcKernel"] == 0.005
    assert stats["kernel_ops_ms"]["[no launching op] graph_node"] == 0.030
    assert stats["handwritten_calls"] == {"nms_sweep (K1)": 1}
    assert stats["handwritten_kernels"] == {
        "nms_sweep (K1)": 1, "int8_conv": 0, "int8_quantize": 0}
    assert set(stats["layout_copies_ms"]) == {
        "nchwToNhwcKernel <- convolution > cudnn_convolution",
        "copy_kernel <- clone > copy_"}
    text = trace_summary.format_summary(stats, batch=4)
    assert "idle 30.56% of the traced window" in text
    assert "throughput implied by device time: 64000.0 img/s" in text
    assert "hand-written op calls with device work: nms_sweep (K1) 1" \
        in text


def test_card_trace_without_kernels_raises(tmp_path):
    """CUDA activity missing: the card's summary refuses; it does not
    report host ops in the kernels' place."""
    trace = _handwritten_trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e.get("cat") not in ("kernel", "gpu_memcpy")]
    logdir = _write(tmp_path, trace)
    with pytest.raises(RuntimeError, match="no kernel events"):
        trace_summary.summarize(logdir, 4)
    with pytest.raises(FileNotFoundError, match="no .*pt.trace.json"):
        trace_summary.summarize(str(tmp_path / "empty"), 4)


def test_cpu_trace_of_a_forward(tmp_path, one_thread):
    """A real CPU trace of a 128-px batch-1 forward through
    ``profile_trace(device="cpu")``, summarized with ``device="cpu"``:
    one execution, the convolutions the largest share of op self time."""
    model = build_refinedet("test", 320, 2, device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, SMALL, SMALL, 3).astype(np.float32))
    logdir = str(tmp_path / "cpu")
    with torch.inference_mode(), timer.profile_trace(logdir, "cpu") as prof:
        assert prof is not None
        with timer.span("infer/0"):
            model.raw_forward(x)
    stats = trace_summary.trace_stats(logdir, "cpu")
    assert [x["name"] for x in stats["executions"]] == ["infer/0"]
    assert stats["executions"][0]["host_ms"] > 0 and not stats["gaps_ms"]
    cats = stats["categories_ms"]
    assert max(cats, key=cats.get) == "convolution"
    assert sum(cats.values()) == pytest.approx(sum(stats["ops_ms"].values()))
    text = trace_summary.summarize(logdir, 1, "cpu")
    assert "CPU op self time by category" in text


# -- the tools -------------------------------------------------------------------

def _jax_tool(name, argv, monkeypatch):
    """``tools/<name>.py`` imported by path with ``sys.argv`` set, as its
    module-level parsing reads it (its sys.path and environment edits are
    undone afterwards)."""
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("PROTOCOL_BUFFERS_PYTHON_IMPLEMENTATION", "python")
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool,argv", [
    *[(t, a) for t in ("trace_infer", "trace_train_step")
      for a in ([], ["64"], ["64", "2"], ["--summarize", "some/dir"])],
    *[("profile_train_step", a) for a in ([], ["32"], ["32", "5"],
                                          ["--remat"], ["16", "3",
                                                        "--remat"])],
    *[("flops_train_step", a) for a in ([], ["32"])]],
    ids=lambda v: v if isinstance(v, str) else " ".join(v) or "defaults")
def test_command_lines_match_jax(tool, argv, monkeypatch):
    """Batch, iterations and mode as the JAX tool's module-level parsing
    reads them from the same arguments."""
    jt = _jax_tool(tool, argv, monkeypatch)
    port = {"trace_infer": trace_infer, "trace_train_step": trace_train_step,
            "profile_train_step": profile_train_step,
            "flops_train_step": flops_train_step}[tool]
    args = port.parse_args(argv)
    assert args.batch == jt.BATCH and args.device == "cuda"
    if tool == "trace_infer":
        assert args.iters == jt.ITERS
    elif tool == "trace_train_step":
        assert args.steps == jt.STEPS
    elif tool == "profile_train_step":
        assert (args.iters, args.remat) == (jt.ITERS, jt.REMAT)
    if tool.startswith("trace_"):
        jax_summarizes = len(argv) > 1 and argv[0] == "--summarize"
        assert (args.summarize is not None) == jax_summarizes
        if jax_summarizes:
            assert args.summarize == argv[1]


def _small_step_model(seed):
    """RefineDet320 (2 classes, f32) on the CPU with the anchors of a
    128-px input, so the train step runs at 128 px."""
    model = build_refinedet("train", 320, 2, device="cpu", seed=seed)
    cfg = dataclasses.replace(model.cfg, min_dim=SMALL,
                              feature_maps=(16, 8, 4, 2))
    model.priors = torch.from_numpy(generate_priors(cfg))
    return model


def test_full_variant_is_make_train_steps_step(one_thread):
    """``profile_train_step``'s ``full`` at 128 px, batch 1, updates the
    weights and momentum bitwise as ``make_train_step``'s step from the
    same state; ``grad-rmt`` and ``grad-dots`` give ``grad``'s gradients
    bitwise."""
    images, boxes, labels, valid = profile_train_step.train_batch(
        1, SMALL, "cpu")
    cfg = TrainConfig(batch_size=1, max_boxes=profile_train_step.MAX_BOXES)
    models = [_small_step_model(3)]
    models.append(copy.deepcopy(models[0]))
    before = {k: v.clone() for k, v in models[0].net.state_dict().items()}
    opts = [make_optimizer(m.net.parameters(), lambda s: 1e-2)
            for m in models]
    tool = profile_train_step.variants(models[0], opts[0], cfg, boxes,
                                       labels, valid, remat=True)
    grads = {}
    for name in ("grad", "grad-rmt", "grad-dots"):
        tool[name](images)
        grads[name] = [p.grad.clone() for p in models[0].net.parameters()]
    for name in ("grad-rmt", "grad-dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads[name], grads["grad"])), name
    tool["full"](images)
    step = make_train_step(models[1], opts[1], cfg)
    step(create_train_state(models[1], opts[1]), images, boxes, labels,
         valid)
    got, want = (m.net.state_dict() for m in models)
    assert any(not torch.equal(got[k], v) for k, v in before.items())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for pa, pb in zip(*(m.net.parameters() for m in models)):
        assert torch.equal(opts[0].state[pa]["momentum_buffer"],
                           opts[1].state[pb]["momentum_buffer"])


def test_flop_count_against_conv_flops_and_xla(one_thread):
    """The 128-px batch-1 train-mode forward: ``FlopCounterMode`` counts
    exactly ``conv_flops``; XLA's ``cost_analysis()`` of JAX's forward
    (jitted once, its lowering's count; the compiled program's is
    0.006% higher, measured) counts the convolutions over unpadded taps
    (``unpadded_conv_flops``) plus the elementwise ops (0.11% more,
    measured), so it lies between that count and the port's; the
    unfused bytes are at least the weights read once."""
    model = build_refinedet("train", 320, 2, device="cpu")
    x = torch.zeros(1, SMALL, SMALL, 3)
    flops, moved = flops_train_step.count(
        lambda: model.raw_forward(x, train=True))
    assert flops == conv_flops(model.net, x) == 11_998_031_872
    unpadded = flops_train_step.unpadded_conv_flops(model.net, x)
    assert unpadded == 11_113_362_944
    weights = sum(p.numel() * 4 for p in model.net.parameters())
    assert moved > weights

    jmodel = jbuild("train", 320, 2)
    shape = jax.ShapeDtypeStruct((1, SMALL, SMALL, 3), jnp.float32)
    params = jax.eval_shape(lambda k: jmodel.module.init(
        k, jnp.zeros(shape.shape), train=False),
        jax.random.PRNGKey(0))["params"]
    xla = jax.jit(lambda p, im: jmodel.module.apply(
        {"params": p}, im, train=True)).lower(params, shape) \
        .cost_analysis()["flops"]
    assert unpadded <= xla <= 1.005 * unpadded
    assert xla < flops
