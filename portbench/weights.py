"""Seeded weights for both sides, made on the device in a few large calls.

One ``torch.Generator`` on the card, keyed by the run's seed, draws one
normal vector for every weight at once; each leaf is a slice of it at
its own scale: He's ``sqrt(2 / fan_in)`` for the VGG trunk, whose first
conv is divided by ``input_std`` (the pixel-scale input's spread) so
that the features are of unit scale, as a pretrained trunk's first layer
absorbs the input's scale; Xavier's ``sqrt(2 / (fan_in + fan_out))`` for
the extras, the TCB and the deconvs; biases normal at ``bias_std``; the
L2Norm scales at 10 and 8. With zero biases, the augmentation's mean
fill (an input of exactly 0) gives features of exactly 0 around which
the L2Norm's gradient, 1 / (norm + 1e-10), runs to 1e6 and more: a
gradient no two precisions agree on, and no trained trunk has. The heads
are then scaled from one float32 forward of the cell's own images
(``calibrate_heads``) so that their outputs have the spread a trained
detector's have: localization offsets of standard deviation
``head_std_loc``, confidence logits of ``head_std_conf``, each channel
centred, the background logit raised by ``background_bias``. Random
heads at the trunk's scale give logits in the hundreds, saturated scores
with exact ties and boxes far outside the image, on which no two
precisions order the candidates alike.

The result is a state_dict under the fork's keys, float32 on the device,
handed to the program and to the reference alike.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from portbench.reference.net import RefineDet

HEADS = ("arm_loc", "arm_conf", "odm_loc", "odm_conf")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` keyed by (seed, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed % 2 ** 64, stream])
                      .generate_state(1, np.uint64)[0]))
    return g


def reference_net(num_classes: int, device):
    """The reference network on ``device``, its storage uninitialized."""
    with torch.device("meta"):
        net = RefineDet(num_classes)
    return net.to_empty(device=device)


def _std(name: str, w: torch.Tensor) -> float:
    rf = w[0, 0].numel()
    fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    if name.startswith("vgg."):
        return (2.0 / fan_in) ** 0.5
    return (2.0 / (fan_in + fan_out)) ** 0.5


@torch.no_grad()
def fill(net: nn.Module, seed: int, input_std: float,
         bias_std: float) -> None:
    """Draw every weight of ``net`` from ``seed`` in one call."""
    params = dict(net.named_parameters())
    leaves = [(n, p) for n, p in params.items() if p.dim() == 4
              or n.endswith("bias")]
    total = sum(p.numel() for _, p in leaves)
    dev = next(net.parameters()).device
    buf = torch.randn(total, generator=generator(seed, 1, dev), device=dev)
    off = 0
    for n, p in leaves:
        std = _std(n, p) if p.dim() == 4 else bias_std
        p.copy_(buf[off:off + p.numel()].view_as(p) * std)
        off += p.numel()
    net.vgg[0].weight.div_(input_std)
    net.conv4_3_L2Norm.weight.fill_(10.0)
    net.conv5_3_L2Norm.weight.fill_(8.0)


@torch.no_grad()
def calibrate_heads(net: nn.Module, images: torch.Tensor, loc_std: float,
                    conf_std: float, background_bias: float) -> None:
    """Scale each head conv so that its output on ``images`` (NHWC
    float32, as the network takes them) has the standard deviation asked
    for, shift each of its channels to mean zero there, and raise the
    background logit of both confidence heads."""
    outs: Dict[nn.Module, tuple] = {}
    mods = [m for h in HEADS for m in getattr(net, h)]
    handles = [m.register_forward_hook(lambda m, i, o: outs.__setitem__(
        m, (o.float().std(), o.float().mean((0, 2, 3))))) for m in mods]
    net(images)
    for h in handles:
        h.remove()
    for head in HEADS:
        want = loc_std if head.endswith("loc") else conf_std
        for m in getattr(net, head):
            std, mean = outs[m]
            scale = want / max(float(std), 1e-12)
            m.weight.mul_(scale)
            m.bias.copy_(-mean * scale)
            if head.endswith("conf"):
                c = m.out_channels // 3
                m.bias.view(3, c)[:, 0] += background_bias


def make_state(cfg: dict, seed: int, images: torch.Tensor, device
               ) -> Dict[str, torch.Tensor]:
    """The run's float32 weights on ``device``: drawn from ``seed``, the
    heads calibrated on ``images`` (NHWC float32, mean subtracted)."""
    net = reference_net(cfg["num_classes"], device)
    w = cfg["weights"]
    fill(net, seed, w["input_std"], w["bias_std"])
    calibrate_heads(net, images, w["head_std_loc"], w["head_std_conf"],
                    w["background_bias"])
    return {k: v.detach().clone() for k, v in net.state_dict().items()}
