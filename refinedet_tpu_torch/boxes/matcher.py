"""Anchor-GT matching (bipartite + threshold assignment), batched.

Port of ``refinedet_tpu/boxes/matcher.py``. Where the JAX package vmaps a
per-image function, this one works on the whole batch at once: GT tables
``[B, M, ...]`` padded to ``max_boxes`` rows with a validity mask, IoU
``[B, M, P]``, targets ``[B, P]``. No host round trip, no data-dependent
shape. The single-image forms add and drop the batch dimension.

Semantics kept exactly:
  * invalid (padding) GT rows get overlap -1, so they never win;
  * ties go to the first maximal index (``torch.argmax``, like
    ``jnp.argmax``; ``torch.max(dim)``'s indices make no such promise);
  * the force step (overlap := 2 at each valid GT's best anchor) lets the
    **last** GT win where several share a best anchor, written as the JAX
    code writes it (hits, a flip, an argmax), not as a scatter with
    duplicate indices, whose winner CUDA does not define;
  * labels shift by +1 in SSD ``match`` only;
  * ODM mode matches against ARM-decoded anchors and encodes relative to
    their center-size form.

The matched rows are picked with a gather: exact, and the torch idiom
(the JAX package's one-hot contraction exists for the TPU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from refinedet_tpu_torch.boxes.codec import decode, encode
from refinedet_tpu_torch.boxes.geometry import center_size, jaccard, \
    point_form


class MatchResult(NamedTuple):
    loc_t: torch.Tensor   # [..., P, 4] encoded regression targets
    conf_t: torch.Tensor  # [..., P] int64 class targets (0 = background)


def _bipartite_assign(overlaps: torch.Tensor, valid: torch.Tensor):
    """overlaps [B, M, P] IoU, valid [B, M] bool -> best_truth_idx [B, P]
    int64 and best_truth_overlap [B, P]."""
    m, p = overlaps.shape[-2:]
    # Python scalars, not new tensors: a scalar copied to the card is a
    # blocking copy that would stall the host behind the device.
    overlaps = torch.where(valid[..., None], overlaps, -1.0)
    best_prior_idx = torch.argmax(overlaps, dim=2)          # [B, M]
    best_truth_overlap = torch.amax(overlaps, dim=1)        # [B, P]
    best_truth_idx = torch.argmax(overlaps, dim=1)          # [B, P]

    # Force each valid GT onto its best anchor; the last GT wins.
    arange_p = torch.arange(p, device=overlaps.device)
    hits = valid[..., None] & (best_prior_idx[..., None] == arange_p)
    forced = hits.any(dim=1)                                 # [B, P]
    last_j = (m - 1) - torch.argmax(hits.flip(1).to(torch.uint8), dim=1)
    best_truth_idx = torch.where(forced, last_j, best_truth_idx)
    best_truth_overlap = torch.where(forced, 2.0, best_truth_overlap)
    return best_truth_idx, best_truth_overlap


def _assign(truths, labels, valid, anchors_pf, encode_base, variances,
            threshold, label_offset):
    overlaps = jaccard(truths, anchors_pf)                   # [B, M, P]
    idx, overlap = _bipartite_assign(overlaps, valid)
    matches = torch.gather(truths, 1, idx[..., None].expand(-1, -1, 4))
    conf = torch.gather(labels.long(), 1, idx) + label_offset
    conf = torch.where(overlap < threshold, 0, conf)
    return MatchResult(encode(matches, encode_base, variances), conf)


def match_batch(truths: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor, priors: torch.Tensor,
                variances: Sequence[float],
                threshold: float) -> MatchResult:
    """SSD matching over the batch: anchors = raw priors, labels + 1.

    truths [B, M, 4] point form (padding rows arbitrary), labels [B, M]
    0-based class ids, valid [B, M] bool, priors [P, 4] center-size.
    """
    return _assign(truths, labels, valid, point_form(priors), priors,
                   variances, threshold, 1)


def refine_match_batch(truths: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, priors: torch.Tensor,
                       variances: Sequence[float], threshold: float,
                       arm_loc: Optional[torch.Tensor] = None
                       ) -> MatchResult:
    """Cascaded matching over the batch.

    ARM mode (``arm_loc is None``): anchors = raw priors, labels as given
    (callers pass binary objectness labels). ODM mode: anchors = the
    ARM-decoded boxes of ``arm_loc`` [B, P, 4]; targets are encoded
    relative to their center-size form.
    """
    if arm_loc is None:
        anchors_pf = point_form(priors)
        encode_base = priors
    else:
        anchors_pf = decode(arm_loc, priors, variances)
        encode_base = center_size(anchors_pf)
    return _assign(truths, labels, valid, anchors_pf, encode_base,
                   variances, threshold, 0)


def _one(result: MatchResult) -> MatchResult:
    return MatchResult(result.loc_t[0], result.conf_t[0])


def match(truths, labels, valid, priors, variances,
          threshold) -> MatchResult:
    """SSD matching of one image: truths [M, 4], labels [M], valid [M]."""
    return _one(match_batch(truths[None], labels[None], valid[None], priors,
                            variances, threshold))


def refine_match(truths, labels, valid, priors, variances, threshold,
                 arm_loc=None) -> MatchResult:
    """Cascaded matching of one image (``arm_loc`` [P, 4] in ODM mode)."""
    return _one(refine_match_batch(
        truths[None], labels[None], valid[None], priors, variances,
        threshold, None if arm_loc is None else arm_loc[None]))
