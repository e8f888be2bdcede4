from refinedet_tpu_torch.boxes.codec import decode, encode
from refinedet_tpu_torch.boxes.geometry import (center_size, iou_pairwise,
                                                jaccard, point_form)
from refinedet_tpu_torch.boxes.matcher import (MatchResult, match,
                                               match_batch, refine_match,
                                               refine_match_batch)
from refinedet_tpu_torch.boxes.priors import generate_priors

__all__ = ["MatchResult", "center_size", "decode", "encode",
           "generate_priors", "iou_pairwise", "jaccard", "match",
           "match_batch", "point_form", "refine_match", "refine_match_batch"]
