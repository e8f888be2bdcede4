"""Post-training int8 quantization (PTQ) of RefineDet for serving.

Port of ``refinedet_tpu/quant/ptq.py``. The scheme is the JAX package's:
symmetric int8 with per-channel everything.

  * weights: per-output-channel int8, ``w_scale[o] = max|W'[..., o]| / 127``;
  * activations: per-INPUT-channel scales folded into the weights
    (SmoothQuant-style): ``x_q[c] = round(x[c] / in_scale[c])`` and ``W' =
    W * in_scale`` before the weights are quantized. ``in_scale[c]`` is a
    clip point (the max or a high percentile) of ``|x[c]|`` over the
    calibration stream, recorded per channel by ``calibrate_amax``;
  * quantized layers: the VGG trunk, extras and TCB convs, minus
    ``quant_skip`` (by default ``DEFAULT_QUANT_SKIP``, the early VGG convs).
    Heads, conv1_1, L2Norm and the deconvs stay in the model's dtype.

Calibration captures each quantizable conv's input with forward pre-hooks
that exist only while ``calibrate_amax`` (or the Hessian pass of
``quant/gptq.py``) runs, so a normal forward pays nothing, as JAX's gate on
the mutable ``calib`` collection does. The statistics, clip points and
weight folding are the JAX package's numpy code, so ``kernel_q``,
``w_scale``, ``in_scale`` and ``bias`` come out bit for bit equal from the
same weights and statistics. Names are the JAX package's (flax) names
(``vgg_conv2_2``, ``tcb0_3_conv1``, ...); ``models/convert.py:
module_names`` maps them to module paths.

Typical use::

    model = build_refinedet("test", 320, 21, dtype=torch.bfloat16)
    model.net.load_state_dict(state)
    model_q, state_q = quantize_model(model, calib_batches)
    boxes, scores = model_q(images)
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from refinedet_tpu_torch.models.convert import module_names
from refinedet_tpu_torch.models.refinedet import source_channels

# Percentiles of |input| recorded besides the max
# (refinedet_tpu/models/refinedet.py:CALIB_PERCENTILES).
CALIB_PERCENTILES = (99.99, 99.9, 99.0)
# activation clip-point choices -> row of the recorded stats
# [amax, *CALIB_PERCENTILES]
ACT_STATS = {"amax": 0, "p9999": 1, "p999": 2, "p99": 3}
assert len(ACT_STATS) == 1 + len(CALIB_PERCENTILES)

# Early VGG convs kept in the model's dtype by default: their image-like,
# high-dynamic-range activations are the dominant int8 accuracy cost.
DEFAULT_QUANT_SKIP = ("vgg_conv1_2", "vgg_conv2_1")


def flax_to_path(net) -> Dict[str, str]:
    """Flax name -> module path of every layer with weights of ``net``."""
    names = module_names(net.use_bn, len(source_channels(net.size)))
    return {flax: path for flax, (path, _) in names.items()}


def quant_modules(net) -> Dict[str, nn.Module]:
    """The convs ``net`` calibrates (float network) or quantizes (int8
    twin), by flax name, in forward order: the quantizable set minus the
    network's ``quant_skip``."""
    paths = flax_to_path(net)
    return {name: net.get_submodule(paths[name]) for name in net.calibrated}


@contextlib.contextmanager
def conv_input_hooks(net, names: Iterable[str],
                     fn: Callable[[str, nn.Module, torch.Tensor], None]
                     ) -> Iterator[None]:
    """While inside, ``fn(name, module, x)`` sees the input ``x`` of each
    named conv of ``net`` on every forward; the hooks go on exit."""
    mods = quant_modules(net)
    handles = []
    try:
        for name in names:
            mod = mods[name]
            handles.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: fn(name, m, args[0])))
        yield
    finally:
        for h in handles:
            h.remove()


def _percentile_taps(n: int):
    """``jnp.percentile(..., method="linear")`` over ``n`` sorted values,
    in JAX's float32 arithmetic: (low index, high index, low weight, high
    weight) for each of ``CALIB_PERCENTILES``."""
    q = np.asarray(CALIB_PERCENTILES, np.float32) / np.float32(100)
    qn = q * (np.float32(n) - np.float32(1))
    low, high = np.floor(qn), np.ceil(qn)
    high_w = qn - low
    low_w = np.float32(1) - high_w
    low = np.clip(low, 0, n - 1).astype(np.int64)
    high = np.clip(high, 0, n - 1).astype(np.int64)
    return [(int(lo), int(hi), float(lw), float(hw))
            for lo, hi, lw, hw in zip(low, high, low_w, high_w)]


def input_stats(x: torch.Tensor):
    """Of a conv input ``x [B, C, H, W]``: the ``[amax, p99.99, p99.9,
    p99] x [C]`` matrix of ``|x|`` per channel over all B·H·W positions
    (percentiles from the sorted values with JAX's interpolation:
    ``torch.quantile`` refuses more than 2^24 values) and the signed
    per-channel mean, both float32. Only the top ranks down to the lowest
    tap are sorted (``topk``): the same values as a full sort's."""
    c = x.shape[1]
    xc = x.float().transpose(0, 1).reshape(c, -1)
    n = xc.shape[1]
    taps = _percentile_taps(n)
    top = torch.topk(xc.abs(), n - min(lo for lo, _, _, _ in taps),
                     dim=1).values  # descending: rank r at column n - 1 - r
    rows = [top[:, 0]]
    for lo, hi, lw, hw in taps:
        rows.append(top[:, n - 1 - lo] * lw + top[:, n - 1 - hi] * hw)
    return torch.stack(rows), xc.mean(dim=1)


def _images(model, images) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images.to(model.device, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(
        images, np.float32)).to(model.device)


def calibrate_amax(model, batches: Iterable, return_means: bool = False):
    """Run calibration batches through the float (f32 or bf16) ``model``
    and collect, per calibrated conv, the ``[amax, p99.99, p99.9, p99] x
    [cin]`` statistics of its input: ``{flax name: stats}``, the
    elementwise running max over all batches (exact for amax, a slight
    overestimate for the percentiles of the pooled stream: the right
    direction for a clip point).

    ``batches`` yields images ``[B, H, W, 3]`` (numpy or tensors),
    preprocessed exactly as at inference. With ``return_means=True``,
    returns ``(stats, means)`` where ``means`` is ``{flax name: E[x] per
    input channel}`` over the stream, weighted by batch size: the input
    of PTQ bias correction (``bias_correction_delta``)."""
    stats: Dict[str, np.ndarray] = {}
    mean_sums: Dict[str, np.ndarray] = {}
    captured: Dict[str, tuple] = {}
    n = 0
    weight = 0.0

    def record(name, _module, x):
        captured[name] = input_stats(x)

    with conv_input_hooks(model.net, model.net.calibrated, record), \
            torch.inference_mode():
        for images in batches:
            captured.clear()
            model.raw_forward(_images(model, images))
            b = float(np.shape(images)[0])
            for name, (st, mean) in captured.items():
                st = st.cpu().numpy().astype(np.float32)
                prev = stats.get(name)
                stats[name] = st if prev is None else np.maximum(prev, st)
                # per-batch mean over B*H*W positions; H*W is constant per
                # conv, so weighting by B makes the pooled mean exact even
                # with a ragged final batch
                mean_sums[name] = mean_sums.get(name, 0.0) + \
                    b * mean.cpu().numpy().astype(np.float32)
            n += 1
            weight += b
    if n == 0:
        raise ValueError("calibration stream was empty")
    if not return_means:
        return stats
    means = {name: (s / weight).astype(np.float32)
             for name, s in mean_sums.items()}
    return stats, means


def bias_correction_delta(w: np.ndarray, kernel_q: np.ndarray,
                          w_scale: np.ndarray, in_scale: np.ndarray,
                          mean_x: np.ndarray) -> np.ndarray:
    """Expected-output-error bias correction (DFQ-style, Nagel et al.
    2019): the int8 conv's effective weight ``kernel_q * w_scale /
    in_scale`` differs from the f32 ``w`` (HWIO) by the weight-rounding
    residual, which turns the calibration stream's per-channel input mean
    E[x] into a systematic per-output-channel offset. Returns ``delta[o]
    = sum_{kh,kw,c} (w - w_eff)[kh,kw,c,o] * E[x[c]]`` to ADD to the
    bias (activation rounding treated as zero-mean; E[x] applied at every
    tap, zero-padded borders included)."""
    w = np.asarray(w, np.float32)
    w_eff = (kernel_q.astype(np.float32)
             * np.asarray(w_scale, np.float32)[None, None, None, :]
             / np.asarray(in_scale, np.float32)[None, None, :, None])
    return np.einsum("hwco,c->o", w - w_eff,
                     np.asarray(mean_x, np.float32)).astype(np.float32)


def _clip_point(stat, act_stat: str) -> np.ndarray:
    """Per-input-channel clip points [cin] from a stats matrix (or a
    scalar/vector amax, for hand-built calibration dicts)."""
    stat = np.asarray(stat, np.float32)
    if stat.ndim <= 1:  # scalar or per-channel amax given directly
        return np.atleast_1d(stat)
    return stat[ACT_STATS[act_stat]]


def _hwio(t: torch.Tensor) -> np.ndarray:
    """A torch conv weight [O, C, kh, kw] as flax's HWIO float32."""
    return np.ascontiguousarray(np.transpose(
        t.detach().cpu().float().numpy(), (2, 3, 1, 0)))


def _gptq_kernel(name, w, in_scale, w_scale, hessian, gptq_cache, device):
    from refinedet_tpu_torch.quant.gptq import gptq_round
    cached = None if gptq_cache is None else gptq_cache.get(name)
    # Reused only for the same weights, scales AND Hessian: two
    # calibrations with equal scales can still differ in their Hessians.
    if cached is not None and all(
            np.array_equal(a, b) for a, b in zip(
                cached[:4], (in_scale, w_scale, w, hessian))):
        return cached[4]
    kernel_q = gptq_round(w, in_scale, w_scale, hessian, device=device)
    if gptq_cache is not None:
        gptq_cache[name] = (in_scale.copy(), w_scale.copy(), w.copy(),
                            np.array(hessian, copy=True), kernel_q)
    return kernel_q


def quantize_variables(model_q, state: Mapping[str, torch.Tensor],
                       amax: Dict, act_stat: str = "p9999",
                       means: Optional[Dict] = None,
                       hessians: Optional[Dict] = None,
                       gptq_cache: Optional[Dict] = None
                       ) -> Dict[str, torch.Tensor]:
    """The int8 twin's state_dict (CPU tensors) from the float network's
    ``state`` (reference key names).

    ``model_q`` is the ``quant=True`` twin (same size, classes and
    variant); its ``QuantConv2d`` modules decide which convs are
    quantized. Weights get per-output-channel scales; the input scale
    comes from ``amax`` (``calibrate_amax`` stats, or plain floats) with
    the ``act_stat`` clip point per input channel: 'p9999' (default)
    clips the top 0.01% of activations; 'amax', 'p999' and 'p99' are the
    alternatives. Percentile clip points are floored at 1e-3 x the
    channel max so sparse channels do not saturate, and calibration-dead
    channels at 5% of the layer's max (with a warning).

    ``means`` (from ``calibrate_amax(..., return_means=True)``) adds the
    bias correction; ``hessians`` (from ``quant.gptq.
    accumulate_hessians``) switches the covered convs from
    round-to-nearest to the GPTQ solver, on ``model_q``'s device.
    ``gptq_cache`` (a caller-owned dict) memoizes GPTQ kernels per conv
    across calls; an entry is reused only when the raw weights, both
    scales and the Hessian are all equal, so a shared cache degrades to a
    recompute, never a wrong kernel."""
    net = model_q.net
    paths = flax_to_path(net)
    qmods = quant_modules(net) if net.quant else {}
    qpaths = {paths[name] for name in qmods}
    out: Dict[str, torch.Tensor] = {}
    for key in net.state_dict():
        path = key.rsplit(".", 1)[0]
        if path in qpaths:
            continue
        if key not in state:
            raise KeyError(f"missing f32 params for {key!r}")
        out[key] = state[key].detach().cpu()
    for name in qmods:
        path = paths[name]
        if name not in amax:
            raise KeyError(
                f"no calibration amax for quantized conv {name!r}; "
                f"calibrated: {sorted(amax)}")
        if path + ".weight" not in state:
            raise KeyError(f"missing f32 params for module {name!r}")
        w = _hwio(state[path + ".weight"])
        b = state[path + ".bias"].detach().cpu().float().numpy()
        # per-input-channel activation scales, folded into the weights
        # (see QuantConv2d): x_q[c] = x[c] / in_scale[c], W' = W * in_scale
        clip = _clip_point(amax[name], act_stat)
        stat = np.asarray(amax[name], np.float32)
        if stat.ndim == 2:
            clip = np.maximum(clip, 1e-3 * stat[0])
        amax_vec = stat[0] if stat.ndim == 2 else np.atleast_1d(stat)
        layer_max = float(amax_vec.max()) if amax_vec.size else 0.0
        dead = amax_vec <= 0.0
        if dead.any() and layer_max > 0.0:
            warnings.warn(
                f"PTQ: {name!r} has {int(dead.sum())}/{dead.size} "
                "calibration-dead input channels (|x| max 0 on the "
                "calibration stream); flooring their clip point at 5% of "
                "the layer-wide max. Consider more calibration images.")
            clip = np.where(np.broadcast_to(dead, clip.shape),
                            0.05 * layer_max, clip)
        in_scale = np.maximum(clip / 127.0, 1e-12).astype(np.float32)
        if in_scale.shape == (1,) and w.shape[2] != 1:
            in_scale = np.broadcast_to(in_scale, (w.shape[2],)).copy()
        w_folded = w * in_scale[None, None, :, None]
        w_scale = np.abs(w_folded).max(axis=(0, 1, 2)) / 127.0
        w_scale = np.maximum(w_scale, 1e-12).astype(np.float32)
        if hessians is not None and name in hessians:
            kernel_q = _gptq_kernel(name, w, in_scale, w_scale,
                                    hessians[name], gptq_cache,
                                    model_q.device)
        else:
            kernel_q = np.clip(np.round(w_folded / w_scale),
                               -127, 127).astype(np.int8)
        if means is not None:
            if name not in means:
                raise KeyError(f"bias correction requested but no input "
                               f"mean for quantized conv {name!r}; "
                               f"calibrated: {sorted(means)}")
            b = b + bias_correction_delta(w, kernel_q, w_scale, in_scale,
                                          means[name])
        out[path + ".kernel_q"] = torch.from_numpy(
            np.ascontiguousarray(kernel_q.transpose(3, 0, 1, 2)))
        out[path + ".w_scale"] = torch.from_numpy(w_scale)
        out[path + ".in_scale"] = torch.from_numpy(in_scale)
        out[path + ".bias"] = torch.from_numpy(
            np.asarray(b, np.float32).copy())
    return out


def quantized_names(state: Mapping[str, torch.Tensor], net) -> set:
    """Flax names of the convs a state_dict holds quantized."""
    path_names = {path: name for name, path in flax_to_path(net).items()}
    return {path_names.get(k[:-len(".kernel_q")], k[:-len(".kernel_q")])
            for k in state if k.endswith(".kernel_q")}


def check_quantized_set(state: Mapping[str, torch.Tensor], model_q,
                        path: str) -> None:
    """Raise unless the convs ``state`` holds quantized are the ones the
    int8 twin ``model_q`` quantizes (a checkpoint written with another
    ``--quant_skip``), with the JAX CLI's message."""
    want_q = set(quant_modules(model_q.net))
    have_q = quantized_names(state, model_q.net)
    if want_q != have_q:
        raise ValueError(
            f"quantized checkpoint {path!r} was saved with a different "
            "--quant_skip than requested: checkpoint quantizes "
            f"{sorted(have_q - want_q) or 'nothing extra'} that the "
            "requested model keeps bf16, and lacks "
            f"{sorted(want_q - have_q) or 'nothing'}. Re-pass the "
            "--quant_skip used at --save_quantized time.")


def calib_batches_from_dataset(dataset, transform, num_images: int,
                               batch_size: int):
    """Yield calibration batches of eval-preprocessed images from a
    dataset with the ``pull_image`` accessor (VOC/COCO/SSDD loaders)."""
    n = min(num_images, len(dataset))
    if n == 0:
        raise ValueError("dataset is empty; cannot calibrate")
    for b0 in range(0, n, batch_size):
        idx = range(b0, min(b0 + batch_size, n))
        imgs = []
        for i in idx:
            raw = dataset.pull_image(i)
            raw = raw[0] if isinstance(raw, tuple) else raw
            imgs.append(transform(raw))
        yield np.stack(imgs).astype(np.float32)


def quantize_model(model, calib_batches: Iterable,
                   dtype: torch.dtype = torch.bfloat16,
                   amax: Optional[Dict] = None,
                   act_stat: str = "p9999",
                   quant_skip: tuple = DEFAULT_QUANT_SKIP,
                   bias_correct: bool = False,
                   weight_opt: str = "none",
                   weight_opt_names: Optional[tuple] = None):
    """One-call PTQ of the float ``model`` (weights loaded): calibrate on
    ``calib_batches`` (ignored if ``amax`` is given) and return
    ``(model_q, state_q)``, the int8 serving twin (its state loaded, same
    detector, on the same device) and its state_dict. ``quant_skip``
    names convs kept unquantized. ``bias_correct=True`` folds the
    expected weight-rounding output error into each quantized conv's bias
    from the calibration means. ``weight_opt='gptq'`` replaces
    round-to-nearest with the second-order solver (``quant/gptq.py``),
    which needs a second pass over ``calib_batches`` for the per-layer
    input Hessians; ``weight_opt_names`` restricts it to some convs."""
    from refinedet_tpu_torch.models.builder import build_refinedet

    if weight_opt not in ("none", "gptq"):
        raise ValueError(f"weight_opt must be 'none' or 'gptq', "
                         f"got {weight_opt!r}")
    if weight_opt == "gptq":
        # the Hessian pass re-consumes the stream; materialize generators
        calib_batches = list(calib_batches)
    means = None
    if amax is None:
        if bias_correct:
            amax, means = calibrate_amax(model, calib_batches,
                                         return_means=True)
        else:
            amax = calibrate_amax(model, calib_batches)
    elif bias_correct or weight_opt == "gptq":
        raise ValueError("bias_correct/weight_opt need the calibration "
                         "stream; pass calib_batches instead of a "
                         "precomputed amax")
    hessians = None
    if weight_opt == "gptq":
        from refinedet_tpu_torch.quant.gptq import accumulate_hessians
        hessians = accumulate_hessians(model, calib_batches,
                                       names=weight_opt_names)
    model_q = build_refinedet(
        "test", model.size, model.num_classes, detector=model.detect,
        use_bn=model.use_bn, dtype=dtype, device=model.device, quant=True,
        quant_skip=quant_skip)
    state_q = quantize_variables(model_q, model.net.state_dict(), amax,
                                 act_stat=act_stat, means=means,
                                 hessians=hessians)
    model_q.net.load_state_dict(state_q, strict=True)
    return model_q, state_q
