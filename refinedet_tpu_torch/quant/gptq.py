"""Second-order weight rounding for int8 PTQ (GPTQ-style).

Port of ``refinedet_tpu/quant/gptq.py``. Round-to-nearest treats every
weight alone; a layer's output error is ``dW^T H dW`` with ``H = E[x
x^T]`` over the im2col patches of the calibration stream, so the best
rounding of one weight depends on the others through the input
covariance. ``gptq_round`` quantizes the K patch dimensions of a conv
kernel in order and, after each, shifts the rows not yet quantized to
absorb its residual through the Cholesky factor of ``H^-1`` (Frantar et
al., the OBQ lineage). The host does one K x K inverse and Cholesky per
layer in numpy float64, as JAX does; the solve, a loop of masked rank-1
updates, runs in torch on the model's device in JAX's order.

``accumulate_hessians`` captures each named conv's input with a forward
pre-hook (only while it runs) and reduces ``patches^T @ patches`` on the
device per sub-batch; only the [K, K] matrix comes to the host.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from refinedet_tpu_torch.device import DeviceLike
from refinedet_tpu_torch.quant.ptq import _images, conv_input_hooks


def conv_geometry(name: str, kernel_shape) -> tuple:
    """(kh, kw, stride, padding, dilation) of a quantizable RefineDet conv
    from its flax name and HWIO kernel shape: conv6 is 3x3 pad 3
    dilation 3, extra_conv2 stride 2, 1x1 convs pad 0, every other one
    3x3 pad 1."""
    kh, kw = int(kernel_shape[0]), int(kernel_shape[1])
    stride = 2 if name == "extra_conv2" else 1
    dilation = 3 if name == "vgg_conv6" else 1
    if name == "vgg_conv6":
        padding = 3
    else:
        padding = 0 if kh == 1 else 1
    return kh, kw, stride, padding, dilation


def module_geometry(module) -> tuple:
    """(kernel, stride, padding, dilation) the module itself runs."""
    pair = lambda v: int(v[0]) if isinstance(v, (tuple, list)) else int(v)
    return (pair(module.kernel_size), pair(module.stride),
            pair(module.padding), pair(module.dilation))


# Patches one float64 product of ``hessian_of`` takes (~0.6 GB at K=576).
HESSIAN_ROWS = 1 << 17


def hessian_of(x: torch.Tensor, kh: int, kw: int, stride: int,
               padding: int, dilation: int):
    """``H = patches^T @ patches`` over all positions of ``x [B, C, H,
    W]``, [K, K] float64 with K = C·kh·kw in channel-major (c, kh, kw)
    order, which is both ``F.unfold``'s and ``lax.
    conv_general_dilated_patches``' order; and the number of patches.

    The products accumulate in float64, ``HESSIAN_ROWS`` patches at a
    time, also inside a bf16 model's autocast (the hooks run there): a
    float32 Gram matrix over RefineDet512's ~10^6 conv1_2 patches a
    forward came out with a negative eigenvalue beyond GPTQ's damping,
    and the solve's Cholesky failed."""
    with torch.autocast(x.device.type, enabled=False):
        p = F.unfold(x.float(), (kh, kw), dilation=dilation,
                     padding=padding, stride=stride)
        pm = p.transpose(1, 2).reshape(-1, p.shape[1])
        h = pm.new_zeros((pm.shape[1], pm.shape[1]), dtype=torch.float64)
        for r in range(0, pm.shape[0], HESSIAN_ROWS):
            rows = pm[r:r + HESSIAN_ROWS].double()
            h += rows.T @ rows
        return h, pm.shape[0]


def accumulate_hessians(model, batches: Iterable,
                        names: Optional[Sequence[str]] = None,
                        max_sub_batch: int = 4) -> Dict[str, np.ndarray]:
    """Per-conv im2col input Hessians ``E[x x^T]`` over the calibration
    stream, ``{flax name: H [K, K] float32}``, normalized by the patch
    count. ``model`` is the float (f32/bf16) model; ``names`` restricts
    the convs (default: every calibrated one). Batches are split into
    ``max_sub_batch`` images a forward. Each conv's geometry from the
    name table (``conv_geometry``) is checked against the one the module
    runs, and a mismatch raises."""
    net = model.net
    names = [n for n in net.calibrated if names is None or n in names]
    hs: Dict[str, np.ndarray] = {}
    counts: Dict[str, float] = {}

    def record(name, module, x):
        weight_shape = module.weight.shape  # [O, C, kh, kw]
        geom = conv_geometry(name, (weight_shape[2], weight_shape[3],
                                    weight_shape[1], weight_shape[0]))
        k, s, p, d = module_geometry(module)
        if (k, k, s, p, d) != geom:
            raise ValueError(
                f"conv {name!r}: model geometry "
                f"(kernel={k}, stride={s}, pad={p}, dil={d}) "
                f"disagrees with quant.gptq.conv_geometry's "
                f"table {geom}; update conv_geometry")
        h, cnt = hessian_of(x, *geom)
        hs[name] = hs.get(name, 0.0) + h.cpu().numpy().astype(np.float64)
        counts[name] = counts.get(name, 0.0) + float(cnt)

    n = 0
    with conv_input_hooks(net, names, record), torch.inference_mode():
        for images in batches:
            for s0 in range(0, np.shape(images)[0], max_sub_batch):
                model.raw_forward(_images(model,
                                          images[s0:s0 + max_sub_batch]))
                n += 1
    if n == 0:
        raise ValueError("calibration stream was empty")
    return {name: (h / counts[name]).astype(np.float32)
            for name, h in hs.items()}


def gptq_solve(w_mat: torch.Tensor, scale: torch.Tensor,
               u_upper: torch.Tensor) -> torch.Tensor:
    """Ordered quantization with error feedback, on the tensors' device.

    ``w_mat`` [K, O] float32 (folded weights, channel-major patch order),
    ``scale`` [O] per-output-channel step, ``u_upper`` [K, K] the upper
    Cholesky factor of H^-1 (H^-1 = U^T U). Row k is rounded to the grid;
    its residual, divided by ``U[k, k]``, shifts the rows after k along
    ``U[k]`` (the OBQ compensation; rows at or before k are left as they
    are, as JAX's mask leaves them). Returns the int8 grid indices [K, O].

    XLA fuses each multiply-subtract of the JAX solve into one FMA; here
    each is the float64 difference of float32 values and their exact
    float64 product, rounded to float32, which is that FMA but for a rare
    double rounding (the weights stay float32 values, held in float64). Rounded twice in float32, a flipped grid point in
    one row moves the rows after it (0.1% of tcb2_0_conv's weights, some
    by 2 steps, in the CPU tests); this way the solve matches JAX's.
    """
    w = w_mat.double()  # float32 values, held in float64
    u = u_upper.double()
    scale64 = scale.double()
    diag = torch.diagonal(u_upper)
    q = torch.empty_like(w_mat)
    for k in range(w.shape[0]):
        w_k = w[k]
        q_k = torch.clamp(torch.round(w_k.float() / scale), -127.0, 127.0)
        err = ((w_k - q_k.double() * scale64).float() / diag[k]).double()
        rest = w[k + 1:]
        rest.copy_(torch.addcmul(rest, u[k, k + 1:, None], err[None, :],
                                 value=-1.0).float())
        q[k] = q_k
    return q.to(torch.int8)


def gptq_round(w: np.ndarray, in_scale: np.ndarray, w_scale: np.ndarray,
               hessian: np.ndarray, percdamp: float = 0.01,
               device: DeviceLike = "cpu") -> np.ndarray:
    """Hessian-aware int8 rounding of one conv kernel.

    ``w`` [kh, kw, cin, cout] raw f32 weights (flax's HWIO), ``in_scale``
    [cin] folded activation scales, ``w_scale`` [cout] weight steps (from
    the folded weights, as round-to-nearest), ``hessian`` [K, K] from
    ``accumulate_hessians`` (raw inputs; the in_scale fold is applied
    here). Returns kernel_q int8 [kh, kw, cin, cout] minimizing the
    calibration stream's output MSE under ordered elimination; the solve
    runs on ``device``."""
    kh, kw, cin, cout = w.shape
    kdim = kh * kw * cin
    if hessian.shape != (kdim, kdim):
        raise ValueError(f"hessian shape {hessian.shape} != ({kdim},{kdim}) "
                         f"for kernel {w.shape}")
    w_folded = np.asarray(w, np.float32) * \
        np.asarray(in_scale, np.float32)[None, None, :, None]
    # channel-major (c, kh, kw) patch order, as hessian_of's
    w_mat = w_folded.transpose(2, 0, 1, 3).reshape(kdim, cout)
    s_rep = np.repeat(np.asarray(in_scale, np.float64), kh * kw)
    h = np.asarray(hessian, np.float64) / (s_rep[:, None] * s_rep[None, :])

    # Dead patch dimensions (never active on the calibration stream):
    # decouple them (zero row and column, unit diagonal) so the
    # factorization is defined, the compensation never routes through
    # them, and their own weights fall back to round-to-nearest.
    dead = np.diagonal(h) <= 0.0
    if dead.any():
        h[dead, :] = 0.0
        h[:, dead] = 0.0
        h[dead, dead] = 1.0
    damp = percdamp * float(np.mean(np.diagonal(h)))
    h[np.arange(kdim), np.arange(kdim)] += damp

    h_inv = np.linalg.inv(h)
    # numpy cholesky: A = L L^T (lower); U = L^T gives H^-1 = U^T U
    u_upper = np.linalg.cholesky(h_inv).T.astype(np.float32)

    dev = torch.device(device)
    with torch.inference_mode():
        q = gptq_solve(torch.from_numpy(np.ascontiguousarray(w_mat)).to(dev),
                       torch.from_numpy(np.asarray(w_scale, np.float32)).to(
                           dev),
                       torch.from_numpy(np.ascontiguousarray(u_upper)).to(
                           dev)).cpu().numpy()
    return q.reshape(cin, kh, kw, cout).transpose(1, 2, 0, 3)
