"""The RefineDet training step on one device.

Port of ``refinedet_tpu/train/train_step.py`` (its single-device half; the
mesh/SPMD half comes with multi-GPU). One step: the forward (bf16 autocast
around the network only when the model's dtype is bf16; heads, matching
and losses stay float32), ARM + ODM matching and the mined losses,
backward, then the optax chain the JAX package uses, which is
``torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)``
over every parameter with the lr of the step count before the step:

    [clip_by_global_norm] -> add_decayed_weights -> trace -> scale_by_lr

and optionally the serving-side EMA of the weights. The BN variant's
running statistics are buffers of the net, updated by the forward; the
EMA, like the JAX package's ``ema_params``, covers parameters only (BN
scale and bias included, running statistics not). Nothing in the step
waits on the host: metrics come back as device scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from refinedet_tpu_torch.config import TrainConfig
from refinedet_tpu_torch.losses.multibox import refinedet_multibox_loss

Metrics = Dict[str, torch.Tensor]


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` whose lr follows ``lr_schedule(t)`` at step t
    (the count before the step, as optax counts), with optax's
    ``clip_by_global_norm`` before the weight decay when
    ``grad_clip_norm > 0``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr_schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 grad_clip_norm: float = 0.0):
        super().__init__(params, lr=float(lr_schedule(0)),
                         momentum=momentum, dampening=0.0,
                         weight_decay=weight_decay, nesterov=False)
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = float(grad_clip_norm)

    def apply_gradients(self, step: int) -> None:
        """Clip (if on), set lr(step), and take the SGD step."""
        if self.grad_clip_norm > 0:
            grads = [p.grad for g in self.param_groups for p in g["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = float(self.lr_schedule(step))
        for group in self.param_groups:
            group["lr"] = lr
        self.step()


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: ``g / ||g|| * max_norm``
    when ``||g|| >= max_norm``, else ``g``. No epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``) and no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))


@dataclasses.dataclass
class TrainState:
    """The step count, the net (its BN running statistics included), its
    optimizer and the EMA of the parameters (name -> tensor; None when
    the EMA is off)."""

    step: int
    net: nn.Module
    optimizer: SGD
    ema: Optional[Dict[str, torch.Tensor]] = None


def make_optimizer(params: Iterable[torch.Tensor],
                   lr_schedule: Callable[[int], float],
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   grad_clip_norm: float = 0.0) -> SGD:
    """torch SGD over ``params`` (biases and L2Norm scales included):
    grad += wd * param; buf = m * buf + grad; param -= lr(t) * buf."""
    return SGD(params, lr_schedule, momentum, weight_decay, grad_clip_norm)


def ema_copy(net: nn.Module) -> Dict[str, torch.Tensor]:
    """A fresh EMA equal to the net's current parameters."""
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def create_train_state(model, optimizer: SGD, ema: bool = False
                       ) -> TrainState:
    """Step 0 on ``model.net``'s current weights."""
    return TrainState(step=0, net=model.net, optimizer=optimizer,
                      ema=ema_copy(model.net) if ema else None)


def train_losses(model, heads, boxes: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, train_cfg: TrainConfig
                 ) -> Tuple[torch.Tensor, Metrics]:
    """ARM (2 classes) + ODM losses on the raw heads: the summed loss and
    the metrics dict (device scalars, the JAX package's keys)."""
    preds = (*heads, model.priors)
    kw = dict(variances=model.cfg.variance,
              overlap_thresh=train_cfg.overlap_thresh,
              negpos_ratio=train_cfg.negpos_ratio, theta=train_cfg.theta)
    arm = refinedet_multibox_loss(preds, boxes, labels, valid,
                                  num_classes=2, use_arm=False, **kw)
    odm = refinedet_multibox_loss(preds, boxes, labels, valid,
                                  num_classes=model.cfg.num_classes,
                                  use_arm=True, **kw)
    loss = arm.loss_l + arm.loss_c + odm.loss_l + odm.loss_c
    metrics = {
        "loss": loss,
        "arm_loss_l": arm.loss_l, "arm_loss_c": arm.loss_c,
        "odm_loss_l": odm.loss_l, "odm_loss_c": odm.loss_c,
        "num_pos_arm": arm.num_pos, "num_pos_odm": odm.num_pos,
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def ema_update_(ema: Dict[str, torch.Tensor], net: nn.Module, step: int,
                decay: float) -> None:
    """e = d * e + (1 - d) * p with d = min(decay, (1 + t) / (10 + t)),
    t the step count after the update."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    params = [p.detach() for p in net.parameters()]
    tensors = list(ema.values())
    torch._foreach_mul_(tensors, d)
    torch._foreach_add_(tensors, params, alpha=1.0 - d)


def make_train_step(model, optimizer: SGD, train_cfg: TrainConfig
                    ) -> Callable:
    """The step: (state, images, boxes, labels, valid) -> (state,
    metrics). ``model`` is a train-phase RefineDetModel whose ``net`` the
    ``optimizer`` updates in place; images NHWC float32, boxes [B, M, 4]
    normalized point form, labels [B, M] 1-based, valid [B, M] bool, all
    on the model's device."""
    if train_cfg.on_device_augment:
        raise NotImplementedError(
            "on-device augmentation is not ported yet (ROADMAP.md §1, "
            "item 2)")
    ema_decay = float(train_cfg.ema_decay)

    def step(state: TrainState, images, boxes, labels, valid):
        optimizer.zero_grad(set_to_none=True)
        # Train mode: the BN variant normalises with the batch statistics
        # and moves its running ones, as the JAX step's mutable
        # batch_stats do.
        heads = model.raw_forward(images, train=True)
        loss, metrics = train_losses(model, heads, boxes, labels, valid,
                                     train_cfg)
        loss.backward()
        optimizer.apply_gradients(state.step)
        if ema_decay > 0:
            if state.ema is None:
                raise ValueError("ema_decay > 0 needs a state with an EMA "
                                 "(create_train_state(..., ema=True))")
            ema_update_(state.ema, model.net, state.step + 1, ema_decay)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step
