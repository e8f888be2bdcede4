"""The yardstick's arithmetic on the CPU: the trace reduction on a
hand-made trace, the serving percentile from due times, rates over the
whole window, FLOP counts against ``FlopCounterMode``, the kernel bounds,
the comparisons, and the generators' determinism in the seed."""

import time

import pytest
import torch

from portbench import flops, harness, judge, trace


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def hand_trace():
    """Two convs and a pool on the card under their host ops: kernels at
    [10, 30), [25, 40) and [60, 70) µs, a memcpy at [80, 85)."""
    return [
        _ev("cpu_op", "aten::conv2d", 0, 20),
        _ev("cpu_op", "aten::convolution", 1, 18),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _ev("cpu_op", "aten::conv2d", 21, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=2),
        _ev("cpu_op", "aten::max_pool2d", 45, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 46, 1, correlation=3),
        _ev("cpu_op", "aten::copy_", 50, 40),
        _ev("cuda_runtime", "cudaMemcpyAsync", 51, 1, correlation=4),
        _ev("kernel", "void cudnn_conv<1>", 10, 20, tid=7, correlation=1),
        _ev("kernel", "void cudnn_conv<2>", 25, 15, tid=7, correlation=2),
        _ev("kernel", "max_pool_kernel", 60, 10, tid=7, correlation=3),
        _ev("gpu_memcpy", "Memcpy HtoD", 80, 5, tid=7, correlation=4),
    ]


def test_union_and_idle_share():
    st = trace.reduce(hand_trace(), window_ns=100_000)
    assert st["busy_ns"] == 30_000 + 10_000 + 5_000
    assert st["categories"] == {"convolution": 35_000, "max_pool2d": 10_000,
                                "memcpy": 5_000}
    assert st["kernels"]["void cudnn_conv<1>"] == [20_000, 1]
    # the gaps [40, 60) and [70, 80) µs, the host inside copy_ at both
    assert st["idle_gaps"] == {"aten::copy_": 30_000}
    rec = {"window": {"trace": st, "steps": 2, "untraced_steps": 1}}
    reader = harness.load_module(harness.metric_path("idle_share.train"), "r")
    assert reader.read(rec) == pytest.approx(55.0)
    conv = harness.load_module(harness.metric_path("conv_ms.train"), "c")
    assert conv.read(rec) == pytest.approx(0.035)
    assert trace.top(st["idle_gaps"]) == [["aten::copy_", 3e-5]]


def test_interval_union_is_exact():
    assert trace.union_ns([(0, 10), (5, 7), (9, 12), (20, 21)]) == 13
    assert trace.merged([(5, 7), (0, 10), (20, 21)]) == [(0, 10), (20, 21)]


def test_rates_take_the_whole_window():
    calls = []
    w = harness.until(0.2, lambda i: (calls.append(i), time.sleep(0.01)))
    assert w["steps"] == len(calls) == w["untraced_steps"]
    assert w["seconds"] >= 0.2 and "trace" not in w


def test_forward_count_equals_flopcountermode():
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.weights import reference_net
    net = reference_net(21, "meta")
    with FlopCounterMode(display=False) as c, torch.no_grad():
        net(torch.empty((2, 64, 64, 3), device="meta"))
    shapes = flops.conv_shapes(64, 21, 2)
    assert sum(flops.conv_flops(s) for s in shapes) == c.get_total_flops()
    paths = {s["path"] for s in shapes}
    split = flops.forward_flops(64, 21, 2, {"vgg.2"})
    assert split["int8"] > 0 and split["float"] + split["int8"] == \
        c.get_total_flops()
    assert "tcb1.0" in paths


def test_train_step_count():
    fwd = flops.forward_flops(64, 21, 2)["float"]
    step = flops.train_step_flops(64, 21, 2, 128)
    first = flops.conv_flops(flops.conv_shapes(64, 21, 2)[0])
    resample = 2 * 2 * 3 * (128 * 128 * 64 + 128 * 64 * 64)
    assert step == 3 * fwd - first + resample


def test_kernel_bounds():
    # 2 groups of K = 100: tests 10*9/2 + 90 and 0 + 5
    s = flops.k1_bound_s([(10, 100), (0, 5)], 100)
    assert s == pytest.approx(max(2 * 100 * 18 / 3.35e12,
                                  15 * (45 + 90 + 5) / 67e12))
    shape = {"x": (32, 64, 160, 160), "y": (32, 64, 160, 160), "k": (3, 3),
             "transposed": False}
    ops = 2 * 32 * 160 * 160 * 64 * 9 * 64
    assert flops.int8_conv_bound_s(shape) == pytest.approx(max(
        ops / 1979e12, (32 * 160 * 160 * 64 * 3 + 64 * 9 * 64 + 8 * 64)
        / 3.35e12))
    assert flops.int8_quantize_bound_s(shape) == pytest.approx(
        (32 * 160 * 160 * 64 * 3 + 4 * 64) / 3.35e12)


def _rows(n, k, seed):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(n, 1, k, 2, generator=g)
    wh = torch.rand(n, 1, k, 2, generator=g) * 0.05 + 0.01
    boxes = torch.cat([xy, xy + wh], -1)
    score = torch.rand(n, 1, k, 1, generator=g) * 0.9 + 0.1
    return torch.cat([boxes, score], -1)


def test_det_gaps():
    want = _rows(4, 50, 0)
    assert judge.det_gaps(want.clone(), want, 0.05, 0.02) == {
        "score_gap": 0.0, "score_rms": 0.0, "missed": 0.0, "mismatched": 0.0}
    got = want.clone()
    got[..., 4] += 0.01
    gaps = judge.det_gaps(got, want, 0.05, 0.02)
    assert gaps["score_gap"] == pytest.approx(0.01, abs=1e-6)
    assert gaps["score_rms"] == pytest.approx(0.01, abs=1e-6)
    assert gaps["missed"] == gaps["mismatched"] == 0.0
    assert judge.det_gaps(got, want, 0.05, 0.005)["mismatched"] == 1.0
    got = want.clone()
    got[2:] = 0.0                       # half the batch left out
    assert judge.det_gaps(got, want, 0.05, 0.02)["missed"] == \
        pytest.approx(100 / 300)
    got = want.clone()
    got[0], got[1] = want[1], want[0]   # answers swapped between images
    assert judge.det_gaps(got, want, 0.05, 0.02)["missed"] > 0.4


def test_train_gaps():
    ref = {"a": torch.ones(10), "b": torch.full((10,), 2.0),
           "c": torch.full((10,), 1e-9)}
    same = judge.train_gaps([1.0], [1.0], ref, ref, ref, ref)
    assert same == {"loss_gap": 0.0, "loss_gap_first": 0.0, "grad_gap": 0.0,
                    "grad_gap_median": 0.0, "update_gap": 0.0,
                    "update_gap_median": 0.0}
    still = {k: torch.zeros_like(v) for k, v in ref.items()}
    out = judge.train_gaps([1.1], [1.0], ref, ref, still, ref)
    assert out["loss_gap"] == pytest.approx(0.1)
    assert out["update_gap"] == pytest.approx(1.0)   # "c" left out


@pytest.mark.parametrize("name,size", [("scenes", 64), ("sar", 64)])
def test_generators_are_seeded(name, size):
    from portbench.weights import generator
    gen = harness.generator(name)
    p = harness.load_json(harness.traffic_path(
        "train-b64" if name == "scenes" else "sar-detect-b16"))["scene"]
    a = gen.make(p, generator(2 ** 40 + 3, 2, "cpu"), 6, size, 21, 8)
    b = gen.make(p, generator(2 ** 40 + 3, 2, "cpu"), 6, size, 21, 8)
    c = gen.make(p, generator(2 ** 40 + 4, 2, "cpu"), 6, size, 21, 8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert a[0].dtype == torch.uint8 and a[0].shape == (6, size, size, 3)
    assert bool(a[3][:, 0].all())       # every image has an object


def test_logit_mismatched_takes_the_gap_of_the_margin():
    want = _rows(4, 50, 1)
    want[..., 4] = 0.5
    want[:, :, :25, 4] = 0.99
    got = want.clone()
    # margins log(p / (1 - p)) moved by 0.1 on every row, 0.3 on a fifth
    z = torch.log(want[..., 4] / (1 - want[..., 4])) + 0.1
    z[:, :, ::5] += 0.2
    got[..., 4] = torch.sigmoid(z)
    gaps = judge.det_gaps(got, want, 0.05, 0.02, 0.15)
    assert gaps["missed"] == 0.0
    assert gaps["logit_mismatched"] == pytest.approx(0.2)
    assert "logit_mismatched" not in judge.det_gaps(got, want, 0.05, 0.02)
    got[2:] = 0.0                       # half the batch left out
    assert judge.det_gaps(got, want, 0.05, 0.02, 0.15)[
        "logit_mismatched"] == pytest.approx((0.2 * 200 + 100) / 300)
