from refinedet_tpu_torch.models.builder import (RefineDetModel,
                                                anchor_config_for,
                                                build_refinedet,
                                                build_refinedet_bn)
from refinedet_tpu_torch.models.convert import state_dict_from_flax
from refinedet_tpu_torch.models.refinedet import RefineDet

__all__ = ["RefineDet", "RefineDetModel", "anchor_config_for",
           "build_refinedet", "build_refinedet_bn", "state_dict_from_flax"]
