"""The reference's RefineDet training loss and optimizer step.

The fork's ``RefineDetMultiBoxLoss`` (ARM, then ODM) in plain PyTorch, as
the port computes it: smooth-L1 over positives (the residual zeroed before
the nonlinearity), hard negatives ranked by logsumexp - logit[target] with
a stable descending sort, ``min(3 N, P - 1)`` of them per image, ODM
positives dropped where ARM P(object) <= theta, both losses over the
batch's positive count. Then the update: optax's ``clip_by_global_norm``
(no epsilon), weight decay added to the gradient, heavy-ball momentum and
the lr, as ``torch.optim.SGD(momentum, weight_decay)`` computes it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference.boxes import refine_match


def _smooth_l1(x):
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def _head_loss(loc, conf, loc_t, conf_t, pos, negpos_ratio):
    mask = pos[..., None]
    diff = torch.where(mask, loc - loc_t, 0.0)
    loss_l = torch.where(mask, _smooth_l1(diff), 0.0).sum()
    ce = torch.logsumexp(conf, -1) - torch.gather(
        conf, -1, conf_t[..., None])[..., 0]
    p = conf.shape[1]
    mining = torch.where(pos, 0.0, ce.detach())
    order = torch.sort(mining, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(p, device=order.device).expand_as(order))
    num_pos = pos.sum(1)
    neg = rank < torch.clamp(negpos_ratio * num_pos, max=p - 1)[:, None]
    loss_c = torch.where(pos | neg, ce, 0.0).sum()
    n = num_pos.sum().float()
    safe = torch.clamp(n, min=1.0)
    return (torch.where(n >= 1, loss_l / safe, 0.0),
            torch.where(n >= 1, loss_c / safe, 0.0))


def refinedet_loss(heads, pri, boxes, labels, valid, num_classes: int,
                   var: Sequence[float] = (0.1, 0.2),
                   overlap: float = 0.5, negpos_ratio: int = 3,
                   theta: float = 0.01) -> torch.Tensor:
    """ARM + ODM loss of the raw heads against normalized point-form GT
    ``boxes`` [B, M, 4], 1-based ``labels`` and ``valid``."""
    arm_loc, arm_conf, odm_loc, odm_conf = heads
    if odm_conf.shape[-1] != num_classes:
        raise ValueError("class count does not match the ODM head")
    with torch.no_grad():
        loc_a, conf_a = refine_match(boxes, torch.ones_like(labels), valid,
                                     pri, var, overlap)
        loc_o, conf_o = refine_match(boxes, labels, valid, pri, var, overlap,
                                     arm_loc=arm_loc.detach())
        pos_o = (conf_o > 0) & (torch.softmax(arm_conf.detach(), 2)[..., 1]
                                > theta)
    al, ac = _head_loss(arm_loc, arm_conf, loc_a, conf_a, conf_a > 0,
                        negpos_ratio)
    ol, oc = _head_loss(odm_loc, odm_conf, loc_o, conf_o, pos_o,
                        negpos_ratio)
    return al + ac + ol + oc


def clip_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)


class Sgd:
    """Momentum SGD with weight decay over named float32 parameters:
    g += wd * p; buf = m * buf + g (buf = g at the first step);
    p -= lr * buf. ``first_grad`` keeps each leaf's clipped gradient of
    the first step, the gradient the optimizer gets."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 momentum: float, weight_decay: float, clip: float):
        self.params, self.lr, self.m = params, lr, momentum
        self.wd, self.clip = weight_decay, clip
        self.buf: Dict[str, torch.Tensor] = {}
        self.first_grad: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self) -> None:
        names = [n for n, p in self.params.items() if p.grad is not None]
        if self.clip > 0:
            clip_global_norm_([self.params[n].grad for n in names], self.clip)
        first = not self.buf
        for n in names:
            p = self.params[n]
            g = p.grad
            if first:
                self.first_grad[n] = g.clone()
            d = g + self.wd * p
            buf = self.buf.get(n)
            buf = d.clone() if buf is None else buf.mul_(self.m).add_(d)
            self.buf[n] = buf
            p.sub_(self.lr * buf)
            p.grad = None
