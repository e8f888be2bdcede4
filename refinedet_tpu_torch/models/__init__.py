from refinedet_tpu_torch.models.builder import (RefineDetModel,
                                                anchor_config_for,
                                                build_refinedet,
                                                build_refinedet_bn)
from refinedet_tpu_torch.models.convert import state_dict_from_flax
from refinedet_tpu_torch.models.refinedet import RefineDet
from refinedet_tpu_torch.models.stem_s2d import fold_stem_state_dict

__all__ = ["RefineDet", "RefineDetModel", "anchor_config_for",
           "build_refinedet", "build_refinedet_bn", "fold_stem_state_dict",
           "state_dict_from_flax"]
