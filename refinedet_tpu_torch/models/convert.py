"""Weights from the JAX package's variables to the port's state_dict.

The port's own converter (reference naming, both variants, four or five
sources). It takes the Flax variables as numpy-convertible arrays, so both
packages can be given the same weights:

  * conv kernels: Flax HWIO ``[kh, kw, in, out]`` -> torch ``[out, in, kh,
    kw]``;
  * deconv kernels: Flax's ConvTranspose stores the spatially mirrored
    torch kernel, so it is transposed to ``[in, out, kh, kw]`` and flipped
    back;
  * quantized convs (the int8 twin's ``QuantConv`` leaves): ``kernel_q``
    int8 HWIO -> ``[out, kh, kw, in]`` (the int8 conv kernel's layout);
    ``w_scale``, ``in_scale`` and ``bias`` as they are;
  * BatchNorm: ``params`` scale/bias -> ``weight``/``bias``,
    ``batch_stats`` mean/var -> ``running_mean``/``running_var``, and
    ``num_batches_tracked`` 0 (torch's key, never read at a fixed
    momentum).

The variant and the source count are read from the tree: a
``vgg_conv1_1_bn`` entry means BN, an ``arm_loc4`` entry five sources,
a ``stem_conv1`` entry the space-to-depth stem twin (its stem modules
keep their flax names).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from refinedet_tpu_torch.models.refinedet import L2NORM_TAPS, \
    vgg_conv_indices
from refinedet_tpu_torch.models.stem_s2d import STEM_PHASES


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(k) -> torch.Tensor:
    return _tensor(np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1)))


def _deconv(k) -> torch.Tensor:
    w = np.transpose(np.asarray(k, np.float32), (2, 3, 0, 1))
    return _tensor(w[:, :, ::-1, ::-1])


def module_names(use_bn: bool = False, num_sources: int = 4,
                 stem_s2d: bool = False) -> Dict[str, Tuple[str, str]]:
    """Flax name -> (torch module name, kind) of every layer with weights,
    kind one of ``conv``, ``deconv``, ``bn``, ``l2norm``: the reference
    layout of ``refinedet.py`` (plain) or ``refinedet_bn.py`` (BN); with
    ``stem_s2d`` the stem twin's (``stem_conv1`` and the four
    ``stem_conv2_{di}{dj}`` in place of conv1_1 and conv1_2)."""
    names: Dict[str, Tuple[str, str]] = {}
    if stem_s2d:
        names["stem_conv1"] = ("stem_conv1", "conv")
        for phase in STEM_PHASES:
            names[f"stem_conv2_{phase}"] = (f"stem_conv2_{phase}", "conv")
    for idx, name in vgg_conv_indices(use_bn).items():
        if stem_s2d and name in ("conv1_1", "conv1_2"):
            continue
        names[f"vgg_{name}"] = (f"vgg.{idx}", "conv")
        if use_bn:
            names[f"vgg_{name}_bn"] = (f"vgg.{idx + 1}", "bn")
    for conv, norm, _ in L2NORM_TAPS:
        if conv != "conv3_3" or num_sources == 5:
            names[norm] = (norm, "l2norm")
    extras = {"extra_conv1": 0, "extra_conv1_bn": 1, "extra_conv2": 3,
              "extra_conv2_bn": 4} if use_bn else {"extra_conv1": 0,
                                                   "extra_conv2": 1}
    for flax_name, idx in extras.items():
        names[flax_name] = (f"extras.{idx}",
                            "bn" if flax_name.endswith("_bn") else "conv")
    for i in range(num_sources):
        for head in ("arm_loc", "arm_conf", "odm_loc", "odm_conf"):
            names[f"{head}{i}"] = (f"{head}.{i}", "conv")
        names[f"tcb0_{i}_conv1"] = (f"tcb0.{3 * i}", "conv")
        names[f"tcb0_{i}_conv2"] = (f"tcb0.{3 * i + 2}", "conv")
        names[f"tcb2_{i}_conv"] = (f"tcb2.{3 * i + 1}", "conv")
        if i < num_sources - 1:
            names[f"tcb1_{i}_deconv"] = (f"tcb1.{i}", "deconv")
    return names


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict (CPU tensors) from Flax variables: a bare
    params tree (plain variant), or ``{"params": ...}`` with
    ``"batch_stats"`` for the BN variant."""
    params = variables["params"] if "params" in variables else variables
    stats = variables.get("batch_stats") or {}
    names = module_names("vgg_conv1_1_bn" in params,
                         5 if "arm_loc4" in params else 4,
                         "stem_conv1" in params)
    state: Dict[str, torch.Tensor] = {}
    for flax_name, (module, kind) in names.items():
        leaf = params[flax_name]
        if kind == "l2norm":
            state[module + ".weight"] = _tensor(leaf["weight"])
        elif kind == "bn":
            state[module + ".weight"] = _tensor(leaf["scale"])
            state[module + ".bias"] = _tensor(leaf["bias"])
            state[module + ".running_mean"] = _tensor(
                stats[flax_name]["mean"])
            state[module + ".running_var"] = _tensor(stats[flax_name]["var"])
            state[module + ".num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
        elif "kernel_q" in leaf:
            state[module + ".kernel_q"] = torch.from_numpy(np.array(
                np.transpose(np.asarray(leaf["kernel_q"], np.int8),
                             (3, 0, 1, 2)), order="C"))
            for key in ("w_scale", "in_scale", "bias"):
                state[module + "." + key] = _tensor(leaf[key])
        else:
            state[module + ".weight"] = (_deconv if kind == "deconv"
                                         else _conv)(leaf["kernel"])
            state[module + ".bias"] = _tensor(leaf["bias"])
    return state
