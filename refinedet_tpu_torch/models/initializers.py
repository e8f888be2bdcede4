"""Weight-initialization helpers: the mmcv-style functions of the
reference's ``weights_init.py:6-50`` and its train-side Xavier
re-initialization (``train_refinedet.py:166-175, 295-305``).

Port of ``refinedet_tpu/models/initializers.py``, with its own copy of
the numpy code: each function draws from an explicit
``np.random.RandomState`` on a Flax HWIO kernel shape ``[kh, kw, in,
out]``, as the JAX package's does, so the same seed gives the same
values in both packages. ``torch_layout`` turns such a kernel into a
torch conv or transposed-conv weight, as ``models/convert.py`` does.
The nets initialize themselves (``RefineDet.reset_parameters``); these
helpers serve code ported from the reference that initializes
imperatively, and re-initializing imported weights.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from refinedet_tpu_torch.models.convert import _conv, _deconv, module_names


def constant_init(shape, val: float, bias: float = 0.0):
    return {"kernel": np.full(shape, val, np.float32),
            "bias": np.full(shape[-1], bias, np.float32)}


def _fans(shape):
    """torch/mmcv fan convention for HWIO kernels: both fans include the
    receptive-field size (fan_in = I*H*W, fan_out = O*H*W); dense [I, O]
    kernels degenerate to (I, O)."""
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in = int(shape[-2]) * receptive if len(shape) > 1 else int(shape[0])
    fan_out = int(shape[-1]) * receptive
    return fan_in, fan_out


def xavier_init(rng, shape, gain: float = 1.0, distribution: str = "normal"):
    fan_in, fan_out = _fans(shape)
    if distribution == "uniform":
        a = gain * np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-a, a, shape).astype(np.float32)
    std = gain * np.sqrt(2.0 / (fan_in + fan_out))
    return (rng.randn(*shape) * std).astype(np.float32)


def normal_init(rng, shape, mean: float = 0.0, std: float = 1.0):
    return (rng.randn(*shape) * std + mean).astype(np.float32)


def uniform_init(rng, shape, a: float = 0.0, b: float = 1.0):
    return rng.uniform(a, b, shape).astype(np.float32)


def kaiming_init(rng, shape, a: float = 0.0, mode: str = "fan_out",
                 nonlinearity: str = "relu",
                 distribution: str = "normal"):
    fan_in, fan_out = _fans(shape)
    fan = fan_out if mode == "fan_out" else fan_in
    gain = np.sqrt(2.0 / (1 + a ** 2)) if nonlinearity == "leaky_relu" \
        else np.sqrt(2.0)
    if distribution == "uniform":
        bound = gain * np.sqrt(3.0 / fan)
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    std = gain / np.sqrt(fan)
    return (rng.randn(*shape) * std).astype(np.float32)


def torch_layout(kernel: np.ndarray, transposed: bool = False
                 ) -> torch.Tensor:
    """A Flax HWIO kernel as a torch weight: ``[out, in, kh, kw]`` for a
    conv; for a transposed conv ``[in, out, kh, kw]``, spatially mirrored
    (Flax's ConvTranspose stores the mirrored kernel)."""
    return (_deconv if transposed else _conv)(kernel)


def head_init_order(use_bn: bool = False, num_sources: int = 4
                    ) -> List[str]:
    """Flax names of the convs outside the VGG trunk, in the order the
    JAX model's init creates them (its forward's order, which is the
    order of its params dict): the extras, the ARM heads, the TCB from
    the top source down, the ODM heads."""
    names = ["extra_conv1", "extra_conv2"]
    names += [f"arm_{h}{i}" for i in range(num_sources)
              for h in ("loc", "conf")]
    for i in reversed(range(num_sources)):
        names += [f"tcb0_{i}_conv1", f"tcb0_{i}_conv2"]
        if i < num_sources - 1:
            names.append(f"tcb1_{i}_deconv")
        names.append(f"tcb2_{i}_conv")
    names += [f"odm_{h}{i}" for i in range(num_sources)
              for h in ("loc", "conf")]
    return names


def reinit_heads_xavier(net: nn.Module, seed: int = 0) -> None:
    """Re-initialize, in place, every conv of ``net`` that is neither VGG
    nor L2Norm with Xavier-uniform and a zero bias (the reference's
    ``weights_init`` on the extras, heads and TCB). Draws as JAX's
    ``reinit_heads_xavier`` does on the params of its model's init: one
    ``RandomState(seed)``, one draw per conv in ``head_init_order``, on
    the Flax HWIO shape. Quantized convs are left as they are (their
    Flax leaves hold no ``kernel``)."""
    num_sources = len(net.arm_loc)
    paths = module_names(net.use_bn, num_sources)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name in head_init_order(net.use_bn, num_sources):
            path, kind = paths[name]
            mod = net.get_submodule(path)
            if not isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            w = mod.weight
            if kind == "deconv":  # torch [in, out, kh, kw]
                shape = (w.shape[2], w.shape[3], w.shape[0], w.shape[1])
            else:  # torch [out, in, kh, kw]
                shape = (w.shape[2], w.shape[3], w.shape[1], w.shape[0])
            kernel = xavier_init(rng, shape, distribution="uniform")
            w.copy_(torch_layout(kernel, kind == "deconv"))
            mod.bias.zero_()
