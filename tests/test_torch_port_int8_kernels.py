"""The int8 path's two kernels around what the CPU can reach
(``ops/int8_conv.py``, ``csrc/int8_conv.cu``): the activation quantize op
against JAX's quantize expression, both ops under ``torch.export``, and
the convolution kernel's tile plan, symbolically at every conv of the
320, 512 and 896 sets and in a numpy model of the kernel at small
geometries.

Tolerances, each exact:
  * the quantize op's CPU path (the plain version) against
    ``jnp.clip(jnp.round(x * (1 / in_scale)), -127, 127)`` from
    ``refinedet_tpu/models/layers.py:QuantConv``, bitwise, in bfloat16 and
    float32, on ties, +-127.5, values past +-127, +-inf, -0.0 and
    subnormals (NaN is left out: the plain version's float-to-int8 cast of
    NaN is undefined);
  * the numpy model of the kernel (M-tile boxes, TMA boxes with zero fill
    out of bounds, stride-2 parity planes, split K summed in int64)
    against ``int8_conv_accumulate``, bitwise.
The card runs the kernels themselves (``tests/test_torch_port_gpu.py``,
``chip_smoke.py`` phase 11).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refinedet_tpu_torch.models.layers import QuantConv2d
from refinedet_tpu_torch.ops import int8_conv as port_int8
from refinedet_tpu_torch.tools import int8_bench

# values whose product with 1 / in_scale is a tie, sits on +-127.5, lies
# past the clamp, or is a signed zero, an infinity or a subnormal
EDGES = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5, -127.5,
         127.0, -127.0, 128.0, -128.0, 200.0, -1e30, 3e38, float("inf"),
         float("-inf"), 0.0, -0.0, 1e-40, -1e-40, 1e-45, 5.877e-39]


@jax.jit
def _jax_quantize(x, in_scale):
    """``QuantConv``'s quantize expression (layers.py:79-80)."""
    return jnp.clip(jnp.round(x.astype(jnp.float32) * (1.0 / in_scale)),
                    -127.0, 127.0).astype(jnp.int8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_matches_jax(dtype):
    rng = np.random.RandomState(0)
    c = 64
    x = (rng.randn(2, 5, 7, c) * 80.0).astype(np.float32)
    in_scale = rng.uniform(0.05, 4.0, c).astype(np.float32)
    in_scale[:8] = 1.0
    in_scale[8:16] = 0.5  # x * 2: a tie where x is k / 2 + 1 / 4
    flat = x.reshape(-1, c)
    flat[:len(EDGES), 0] = EDGES
    flat[:len(EDGES), 1] = np.negative(EDGES)
    flat[:64, 8:16] = (np.arange(64 * 8).reshape(64, 8) - 256) / 2 + 0.25
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    np.testing.assert_array_equal(
        np.asarray(xj.astype(jnp.float32)), xt.float().numpy())  # same input
    got = port_int8.int8_quantize(xt, torch.from_numpy(in_scale))
    want = np.asarray(_jax_quantize(xj, jnp.asarray(in_scale)))
    assert got.dtype == torch.int8 and got.shape == xt.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[0, 0, :2, 0].tolist() == [0, 2]  # ties to even
    assert int(got.max()) == 127 and int(got.min()) == -127


def test_quantize_refusals():
    x = torch.zeros(1, 2, 2, 64)
    ones = torch.ones(64)
    with pytest.raises(ValueError, match="in_scale"):
        port_int8.int8_quantize(x, ones[:32])
    with pytest.raises(ValueError, match="float32 in_scale"):
        port_int8.int8_quantize(x, ones.double())
    with pytest.raises(ValueError, match="floating x"):
        port_int8.int8_quantize(x.to(torch.int8), ones)
    with pytest.raises(ValueError, match="x \\[B, H, W, C\\]"):
        port_int8.int8_quantize(x[0], ones)


def test_export_keeps_each_op_one_node():
    """A ``QuantConv2d`` under ``torch.export``: the quantize and the
    convolution one node each, and the program equal to the module."""
    rng = np.random.RandomState(1)
    conv = QuantConv2d(64, 128, 3, 1, 1, 1)
    with torch.no_grad():
        conv.kernel_q.copy_(torch.from_numpy(
            rng.randint(-127, 128, (128, 3, 3, 64)).astype(np.int8)))
        conv.w_scale.copy_(torch.from_numpy(
            rng.uniform(1e-4, 1e-2, 128).astype(np.float32)))
        conv.in_scale.copy_(torch.from_numpy(
            rng.uniform(0.01, 0.05, 64).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.randn(128).astype(np.float32)))
    x = torch.from_numpy((rng.randn(2, 9, 7, 64) * 3).astype(
        np.float32)).permute(0, 3, 1, 2)  # NCHW, channels-last strides
    program = torch.export.export(conv, (x,))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sum("int8_quantize" in t for t in targets) == 1
    assert sum("int8_conv" in t for t in targets) == 1
    assert torch.equal(program.module()(x), conv(x))


# -- the convolution kernel's tile plan ---------------------------------------

@functools.lru_cache(maxsize=None)
def _distinct(size):
    return int8_bench.distinct(int8_bench.conv_shapes(size, 21, ()))


def _covered_once(starts, extent, n):
    """Tiles ``[start, start + extent)`` cut to ``[0, n)`` cover each
    index exactly once, and none lies wholly outside."""
    starts = np.unique(starts)
    assert starts.max() < n
    count = np.zeros(n + extent, np.int64)
    for s in starts:
        count[s:s + extent] += 1
    assert np.all(count[:n] == 1)


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("size", [320, 512, 896])
def test_plan_covers_each_output_and_k_once(size, batch):
    """Every distinct conv (quant_skip=()): the units are the product of
    M tiles, N tiles and K splits, each once; the M tiles cover each
    output pixel once, the N tiles each channel once, the splits each K
    step once, and the K steps each (tap, channel) once, the tap's box
    shifted to the tap's input rows and columns. The plan fits the
    kernel's limits (rows, boxes, stages in shared memory)."""
    for case in _distinct(size):
        h, w, c = case["hwc"]
        k, s, pad, d = case["geom"]
        p = port_int8.plan(batch, h, w, c, case["o"], k, s, pad, d)
        bw, bh, bb = p.box
        assert p.rows <= port_int8.MAX_ROWS and max(p.box) <= 256
        assert c % p.bk == 0 and case["o"] % p.bn == 0
        assert p.stages * (port_int8.MAX_ROWS + p.bn) * p.bk + 1152 \
            <= 227 * 1024
        assert 1 <= p.splits <= p.ksteps and 1 <= p.grid <= p.units
        b0, oh0, ow0, n0, k0, k1, split = p.unit(np.arange(p.units))
        keys = np.stack([b0, oh0, ow0, n0, split], 1)
        assert len(np.unique(keys, axis=0)) == p.units
        _covered_once(ow0, bw, p.wo)
        _covered_once(oh0, bh, p.ho)
        _covered_once(b0, bb, batch)
        _covered_once(n0, p.bn, case["o"])
        ranges = np.unique(np.stack([split, k0, k1], 1), axis=0)
        assert len(ranges) == p.splits
        assert ranges[0, 1] == 0 and ranges[-1, 2] == p.ksteps
        assert np.all(ranges[1:, 1] == ranges[:-1, 2])
        assert np.all(ranges[:, 2] > ranges[:, 1])
        seen = set()
        for ks in range(p.ksteps):
            plane, c0, qh, qw = p.tap(ks)
            tap, chunk = divmod(ks * p.bk, c)
            r, t = divmod(tap, k)
            ph, pw = divmod(plane, s)
            assert (c0, ph + s * qh, pw + s * qw) == (
                chunk, r * d - pad, t * d - pad)
            seen.add((tap, c0))
        assert len(seen) == p.ksteps == k * k * c // p.bk


def _tma_box(src, start, shape):
    """A TMA load of a box of ``src`` at ``start`` (coordinates may lie
    out of bounds on either side, where it reads zeros)."""
    out = np.zeros(shape, src.dtype)
    lo = [max(0, -s) for s in start]
    hi = [min(n, d - s) for n, d, s in zip(shape, src.shape, start)]
    if all(a < b for a, b in zip(lo, hi)):
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = src[tuple(
            slice(s + a, s + b) for s, a, b in zip(start, lo, hi))]
    return out


def _emulate(xq, w, p):
    """The kernel in numpy: each unit's K steps load a TMA box of the
    tap's parity plane and of the weight, multiply them in int64 into a
    128-row tile, and the epilogue stores the rows that fall inside the
    output into the unit's split; the splits are summed."""
    b, _, _, c = xq.shape
    o = w.shape[0]
    s = p.stride
    planes = [xq[:, ph::s, pw::s] for ph in range(s) for pw in range(s)]
    wmat = w.reshape(o, -1)
    bw, bh, bb = p.box
    partial = np.zeros((p.splits, b, p.ho, p.wo, o), np.int64)
    stored = np.zeros(partial.shape, np.int64)
    for u in range(p.units):
        b0, oh0, ow0, n0, k0, k1, split = p.unit(u)
        acc = np.zeros((port_int8.MAX_ROWS, p.bn), np.int64)
        for ks in range(k0, k1):
            plane, c0, qh, qw = p.tap(ks)
            box = _tma_box(planes[plane], (b0, oh0 + qh, ow0 + qw, c0),
                           (bb, bh, bw, p.bk))
            acc[:p.rows] += box.reshape(p.rows, p.bk) @ \
                wmat[n0:n0 + p.bn, ks * p.bk:(ks + 1) * p.bk].T
        for row in range(p.rows):
            rest, ww = divmod(row, bw)
            bi, hh = divmod(rest, bh)
            at = (split, b0 + bi, oh0 + hh, ow0 + ww)
            if at[1] < b and at[2] < p.ho and at[3] < p.wo:
                partial[at + (slice(n0, n0 + p.bn),)] = acc[row]
                stored[at + (slice(n0, n0 + p.bn),)] += 1
    assert np.all(stored == 1)
    return partial.sum(0)


@pytest.mark.parametrize("num_sms", [132, 1], ids=["split", "whole"])
@pytest.mark.parametrize("shape,o,geom", [
    ((2, 9, 7, 64), 128, (3, 1, 1, 1)),
    ((2, 6, 5, 96), 64, (1, 1, 0, 1)),
    ((3, 11, 9, 64), 128, (3, 2, 1, 1)),
    ((2, 10, 10, 128), 64, (3, 1, 3, 3)),
    ((5, 5, 5, 256), 256, (3, 1, 1, 1)),
], ids=["k3p1", "k1", "stride2", "d3p3", "5x5"])
def test_kernel_model_matches_accumulate(shape, o, geom, num_sms):
    k, s, pad, d = geom
    rng = np.random.RandomState(sum(shape) + o)
    xq = rng.randint(-127, 128, shape).astype(np.int8)
    w = rng.randint(-127, 128, (o, k, k, shape[-1])).astype(np.int8)
    xq.reshape(-1)[:3] = [127, -127, 127]
    w.reshape(-1)[:3] = [-127, -127, 127]
    p = port_int8.plan(*shape, o, k, s, pad, d, num_sms)
    if num_sms == 1:
        assert p.splits == 1
    got = _emulate(xq.astype(np.int64), w.astype(np.int64), p)
    want = port_int8.int8_conv_accumulate(torch.from_numpy(xq),
                                          torch.from_numpy(w), s, pad, d)
    np.testing.assert_array_equal(got, want.numpy())


def test_some_model_case_splits():
    """The split cases above do split K (the 5x5 level's plan)."""
    assert port_int8.plan(5, 5, 5, 256, 256, 3, 1, 1, 1).splits > 1
    assert port_int8.plan(32, 5, 5, 256, 256, 3, 1, 1, 1).splits > 1


@pytest.mark.parametrize("args,match", [
    ((1, 8, 8, 48, 64, 3, 1, 1, 1), "multiple of 32"),
    ((1, 8, 8, 64, 96, 3, 1, 1, 1), "multiple of 64"),
    ((1, 8, 8, 64, 64, 3, 3, 1, 1), "stride 1 or 2"),
    ((1, 1, 8, 64, 64, 1, 2, 0, 1), "stride 1 or 2"),
    ((1, 2, 2, 64, 64, 3, 1, 0, 1), "empty output"),
])
def test_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        port_int8.plan(*args)
