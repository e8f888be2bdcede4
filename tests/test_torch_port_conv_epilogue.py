"""The convolution epilogue (``ops/conv_epilogue.py``) on the CPU.

The op ``refinedet_tpu_torch::conv_bias_relu`` on the CPU is bitwise
``relu(conv2d(x, w, b))`` (float32 and bfloat16, channels-last and NCHW,
strided and dilated), its registered backward gives autograd's gradients
of that composition, and its fake kernel the real one's shape, dtype and
strides. The network's engagement rule (``models/refinedet.py``), read
from forwards on fake CUDA tensors (``tools/epilogue_bench.py``): 25
fused convs in RefineDet320 and 512, 3 in the int8 twin, none in the BN
variant, none on meta or CPU inputs, none on a conv or ReLU with a hook;
no traced or CPU call skips the op's dispatcher.
The benchmark's FLOP counts do not move, and its ``epilogue_ms`` reader
reads the kernel's device time per traced step or call, or nothing.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, harness
from refinedet_tpu_torch.models.refinedet import RefineDet
from refinedet_tpu_torch.ops import conv_epilogue
from refinedet_tpu_torch.quant.ptq import DEFAULT_QUANT_SKIP
from refinedet_tpu_torch.tools import epilogue_bench

GEOMETRIES = {"stride2": ((2, 2), (1, 1), (1, 1)),
              "dilation3": ((1, 1), (3, 3), (3, 3))}


def _tensors(layout, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, 11, 9, generator=g)
    w = torch.randn(24, 16, 3, 3, generator=g) / 12
    b = torch.randn(24, generator=g)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
        w = w.to(memory_format=torch.channels_last)
    return x.to(dtype), w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_op_is_conv_then_relu(dtype, layout, geom):
    x, w, b = _tensors(layout, dtype)
    got = conv_epilogue.conv_bias_relu(x, w, b, *GEOMETRIES[geom])
    want = torch.relu(F.conv2d(x, w, b, *GEOMETRIES[geom]))
    assert got.dtype == dtype and got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_backward_is_autograd_of_conv_then_relu(geom):
    fused = [t.requires_grad_() for t in _tensors("channels_last", seed=1)]
    plain = [t.detach().clone().requires_grad_() for t in fused]
    g = torch.randn(conv_epilogue.conv_bias_relu(
        *fused, *GEOMETRIES[geom]).shape, generator=torch.Generator()
        .manual_seed(2))
    (conv_epilogue.conv_bias_relu(*fused, *GEOMETRIES[geom]) * g).sum() \
        .backward()
    (torch.relu(F.conv2d(*plain, *GEOMETRIES[geom])) * g).sum().backward()
    for a, c in zip(fused, plain):
        assert torch.equal(a.grad, c.grad)


def test_cpu_autocast_casts_as_a_convolution():
    x, w, b = _tensors("channels_last")
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert conv_epilogue.compute_dtype(x) == torch.bfloat16
        assert conv_epilogue.compute_dtype(x.double()) == torch.float64
        got = conv_epilogue.conv_bias_relu(x, w, b)
        want = torch.relu(F.conv2d(x, w, b))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_fake_kernel_gives_shape_dtype_and_strides(layout):
    x, w, b = _tensors(layout, torch.bfloat16)
    want = F.conv2d(x, w, b, 2, 1)
    with FakeTensorMode() as mode:
        got = conv_epilogue.conv_bias_relu_op(
            mode.from_tensor(x), mode.from_tensor(w), mode.from_tensor(b),
            [2, 2], [1, 1], [1, 1])
    assert (got.shape, got.dtype, got.stride()) == \
        (want.shape, want.dtype, want.stride())


def test_flop_counter_counts_the_convolution():
    x, w, b = _tensors("channels_last")
    with FlopCounterMode(display=False) as fused:
        conv_epilogue.conv_bias_relu(x, w, b, (1, 1), (3, 3), (3, 3))
    with FlopCounterMode(display=False) as plain:
        F.conv2d(x, w, b, 1, 3, 3)
    assert fused.get_total_flops() == plain.get_total_flops() > 0


def test_the_benchmark_flop_counts_do_not_move():
    assert flops.train_step_flops(320, 21, 2, 640) == 454926566400
    assert len(flops.conv_shapes(512, 2, 1)) == 48


@pytest.mark.parametrize("size,num_classes,use_bn,quant_skip,fused", [
    (320, 21, False, None, 25), (512, 2, False, None, 25),
    (320, 21, False, DEFAULT_QUANT_SKIP, 3), (320, 21, True, None, 0)],
    ids=["320", "512", "int8", "bn"])
def test_engagement_on_the_card(size, num_classes, use_bn, quant_skip,
                                fused):
    calls = epilogue_bench.fused_shapes(size, num_classes, 2, use_bn,
                                        quant_skip)
    assert len(calls) == fused
    if fused:  # conv1_1 of the trunk first, channels-last bf16 or not
        assert calls[0]["x"] == (2, 3, size, size)
        assert calls[0]["y"] == (2, 64, size, size)


def _meta_net(size=320):
    with torch.device("meta"):
        return RefineDet(21, size)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_no_engagement_off_the_card(device):
    if device == "meta":
        net, size = _meta_net(), 320
    else:  # fully convolutional: the 320 net at 128 px
        net, size = RefineDet(21, 320).eval(), 128
    images = torch.zeros((1, size, size, 3), device=device)
    assert epilogue_bench.fused_calls(net, images) == []


@pytest.mark.parametrize("where,fused", [("vgg.0", 24), ("vgg.1", 24),
                                         ("tcb2.1", 24), ("global", 0)])
def test_no_engagement_through_a_hook(where, fused):
    with epilogue_bench.on_fake_card(_meta_net()) as net:
        if where == "global":
            handle = torch.nn.modules.module.register_module_forward_hook(
                lambda *a: None)
        else:
            handle = net.get_submodule(where).register_forward_hook(
                lambda *a: None)
        try:
            calls = epilogue_bench.fused_calls(
                net, torch.empty((1, 320, 320, 3), device="cuda"))
        finally:
            handle.remove()
    assert len(calls) == fused


@pytest.mark.parametrize("case", ["cpu", "fake_card"])
def test_undispatched_takes_no_traced_or_cpu_call(case):
    """The dispatcher-free path is for plain card tensors alone: a CPU
    tensor and a fake CUDA tensor (``torch.export``, the engagement
    counts) go through the op."""
    with torch.no_grad():
        if case == "cpu":
            assert not conv_epilogue._undispatched(torch.zeros(1, 8, 4, 4))
        else:
            with FakeTensorMode():
                x = torch.empty((1, 8, 4, 4), device="cuda")
                assert not conv_epilogue._undispatched(x)


def test_bytes_bound_of_the_cells():
    """Each output read and written once at 3.35 TB/s: the SSDD cell's
    call, the train cell's forward and the int8 cell's call."""
    ms = [epilogue_bench.bound_ms(epilogue_bench.fused_shapes(*a))
          for a in ((512, 2, 16), (320, 21, 64),
                    (320, 21, 32, False, DEFAULT_QUANT_SKIP))]
    assert ms == pytest.approx([1.4173, 2.2145, 0.6260], abs=1e-4)


def _trace(kernels):
    return {"kernels": kernels, "busy_ns": 1, "window_ns": 2,
            "categories": {}}


@pytest.mark.parametrize("name", ["epilogue_ms.train", "epilogue_ms.detect"])
def test_epilogue_reader(name):
    reader = harness.load_module(harness.metric_path(name), "epi")
    assert (reader.LAYER, reader.UNIT) == ("convolutions", "ms")
    kernels = {"void conv_bias_relu_kernel<__nv_bfloat16>(...)":
               [3_000_000, 200],
               "void conv_bias_relu_kernel_nchw<float>(...)": [1_000_000, 8],
               "elementwise_kernel<128, 4>": [9_000_000, 50]}
    rec = {"window": {"trace": _trace(kernels), "steps": 12,
                      "untraced_steps": 4}}
    assert reader.read(rec) == pytest.approx(0.5)
    rec["window"]["trace"] = _trace({"elementwise_kernel<128, 4>": [9, 1]})
    assert reader.read(rec) is None  # a program without the epilogue
    rec["window"] = {"steps": 12, "untraced_steps": 12}
    assert reader.read(rec) is None  # no traced stretch
