"""RefineDet / SSD multibox losses on batched tensors.

Port of ``refinedet_tpu/losses/multibox.py``. Static shapes throughout:
matching is batched (boxes/matcher.py) and hard-negative mining ranks the
priors with one stable sort and its inverse permutation, so nothing waits
on the host.

Semantics kept:
  * smooth-L1 (beta=1) localization loss summed over positives, with the
    residual zeroed *before* the nonlinearity (targets against degenerate
    ARM-decoded anchors can be non-finite; no NaN may reach the gradient);
  * mining score = logsumexp(logits) - logit[target], positives zeroed,
    ranked by a stable descending sort (ties to the lower prior index);
  * num_neg = min(negpos_ratio * num_pos, num_priors - 1) per image;
  * confidence loss = cross-entropy summed over (pos | mined neg);
  * ODM mode: ``arm_loc`` is detached before matching, and positives with
    ARM objectness P(object) <= theta are dropped;
  * both losses divided by the positive count N over the whole batch;
    N < 1 gives (0, 0). Under data parallelism (``group``), the whole
    batch is every rank's: N is all-reduced before the division, as the
    JAX step's global ``jnp.sum(num_pos)`` is, and each rank's losses are
    its share of the global ones (they sum to them over the ranks).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from refinedet_tpu_torch.boxes.matcher import match_batch, \
    refine_match_batch


class LossOutput(NamedTuple):
    loss_l: torch.Tensor   # scalar localization loss (the rank's share)
    loss_c: torch.Tensor   # scalar confidence loss (the rank's share)
    num_pos: torch.Tensor  # scalar total positives, every rank's


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (huber beta=1), as F.smooth_l1_loss."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def _cross_entropy_rows(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Per-row CE: logsumexp(logits) - logits[target]; [..., C] -> [...]."""
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def _mined_confidence_loss(conf_data, conf_t, pos, negpos_ratio):
    """Hard-negative mining + summed CE over (pos | neg).

    conf_data [B, P, C] logits, conf_t [B, P] targets, pos [B, P] bool.
    Returns the scalar CE sum and num_pos [B].
    """
    p = conf_data.shape[1]
    ce = _cross_entropy_rows(conf_data, conf_t)               # [B, P]
    mining = torch.where(pos, 0.0, ce.detach())
    # Rank of each prior by descending mining loss: the inverse of the
    # stable sort's permutation (a scatter of unique indices).
    order = torch.sort(mining, dim=1, descending=True, stable=True).indices
    iota = torch.arange(p, device=order.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, iota)
    num_pos = pos.sum(dim=1)                                   # [B]
    num_neg = torch.clamp(negpos_ratio * num_pos, max=p - 1)
    neg = rank < num_neg[:, None]
    loss_c = torch.where(pos | neg, ce, 0.0).sum()
    return loss_c, num_pos


def _masked_smooth_l1_sum(loc_data, loc_t, pos):
    """Sum over positives of smooth_l1(loc_data - loc_t); masked entries
    are zeroed before the nonlinearity, so a non-finite target there
    reaches neither the value nor the gradient."""
    mask = pos[..., None]
    diff = torch.where(mask, loc_data - loc_t, 0.0)
    return torch.where(mask, smooth_l1(diff), 0.0).sum()


def _finalize(loss_l, loss_c, num_pos,
              group: Optional[dist.ProcessGroup] = None) -> LossOutput:
    n = num_pos.sum().float()
    if group is not None:
        dist.all_reduce(n, group=group)
    safe_n = torch.clamp(n, min=1.0)
    valid = n >= 1.0
    return LossOutput(torch.where(valid, loss_l / safe_n, 0.0),
                      torch.where(valid, loss_c / safe_n, 0.0), n)


def refinedet_multibox_loss(
    predictions,
    gt_boxes: torch.Tensor,    # [B, M, 4] point-form, normalized
    gt_labels: torch.Tensor,   # [B, M] int (1-based foreground ids)
    gt_valid: torch.Tensor,    # [B, M] bool
    *,
    num_classes: int,
    use_arm: bool,
    variances: Sequence[float] = (0.1, 0.2),
    overlap_thresh: float = 0.5,
    negpos_ratio: int = 3,
    theta: float = 0.01,
    group: Optional[dist.ProcessGroup] = None,
) -> LossOutput:
    """RefineDet loss for one head (ARM when use_arm=False, else ODM).

    ``predictions`` is the train-phase model output (arm_loc [B,P,4],
    arm_conf [B,P,2], odm_loc [B,P,4], odm_conf [B,P,C], priors [P,4]).
    With ``group`` the batch is this rank's rows of a global batch: N is
    the global positive count.
    """
    arm_loc, arm_conf, odm_loc, odm_conf, priors = predictions
    if use_arm:
        loc_data, conf_data = odm_loc, odm_conf
    else:
        loc_data, conf_data = arm_loc, arm_conf
    if conf_data.shape[-1] != num_classes:
        raise ValueError(
            f"num_classes={num_classes} does not match the "
            f"{'ODM' if use_arm else 'ARM'} logits' class dim "
            f"{conf_data.shape[-1]}")

    with torch.no_grad():
        if use_arm:
            loc_t, conf_t = refine_match_batch(
                gt_boxes, gt_labels, gt_valid, priors, variances,
                overlap_thresh, arm_loc=arm_loc.detach())
        else:
            # ARM is class-agnostic: any valid GT is objectness 1.
            loc_t, conf_t = refine_match_batch(
                gt_boxes, torch.ones_like(gt_labels), gt_valid, priors,
                variances, overlap_thresh)
        pos = conf_t > 0
        if use_arm:
            arm_obj = torch.softmax(arm_conf.detach(), dim=2)[:, :, 1]
            pos = pos & (arm_obj > theta)

    loss_l = _masked_smooth_l1_sum(loc_data, loc_t, pos)
    loss_c, num_pos = _mined_confidence_loss(conf_data, conf_t, pos,
                                             negpos_ratio)
    return _finalize(loss_l, loss_c, num_pos, group)


def multibox_loss(
    predictions,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,   # [B, M] int 0-based class ids
    gt_valid: torch.Tensor,
    *,
    num_classes: int,
    variances: Sequence[float] = (0.1, 0.2),
    overlap_thresh: float = 0.5,
    negpos_ratio: int = 3,
) -> LossOutput:
    """Plain SSD multibox loss (legacy path).

    ``predictions`` = (loc [B,P,4], conf [B,P,C], priors [P,4]); labels are
    0-based and shifted +1 inside matching.
    """
    del num_classes  # the logits carry it
    loc_data, conf_data, priors = predictions
    with torch.no_grad():
        loc_t, conf_t = match_batch(gt_boxes, gt_labels, gt_valid, priors,
                                    variances, overlap_thresh)
        pos = conf_t > 0
    loss_l = _masked_smooth_l1_sum(loc_data, loc_t, pos)
    loss_c, num_pos = _mined_confidence_loss(conf_data, conf_t, pos,
                                             negpos_ratio)
    return _finalize(loss_l, loss_c, num_pos)


class RefineDetMultiBoxLoss:
    """The reference loss class's constructor signature; callable on
    (predictions, gt_boxes, gt_labels, gt_valid) -> (loss_l, loss_c)."""

    def __init__(self, num_classes, overlap_thresh, prior_for_matching=True,
                 bkg_label=0, neg_mining=True, neg_pos=3, neg_overlap=0.5,
                 encode_target=False, use_gpu=True, theta=0.01,
                 use_ARM=False, variances=(0.1, 0.2)):
        del prior_for_matching, bkg_label, neg_mining, neg_overlap
        del encode_target, use_gpu
        self.num_classes = num_classes
        self.overlap_thresh = overlap_thresh
        self.negpos_ratio = neg_pos
        self.theta = theta
        self.use_arm = use_ARM
        self.variances = variances

    def __call__(self, predictions, gt_boxes, gt_labels, gt_valid):
        out = refinedet_multibox_loss(
            predictions, gt_boxes, gt_labels, gt_valid,
            num_classes=self.num_classes, use_arm=self.use_arm,
            variances=self.variances, overlap_thresh=self.overlap_thresh,
            negpos_ratio=self.negpos_ratio, theta=self.theta)
        return out.loss_l, out.loss_c
