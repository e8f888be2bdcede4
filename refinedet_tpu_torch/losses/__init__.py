from refinedet_tpu_torch.losses.multibox import (LossOutput,
                                                 RefineDetMultiBoxLoss,
                                                 multibox_loss,
                                                 refinedet_multibox_loss,
                                                 smooth_l1)

__all__ = ["LossOutput", "RefineDetMultiBoxLoss", "multibox_loss",
           "refinedet_multibox_loss", "smooth_l1"]
