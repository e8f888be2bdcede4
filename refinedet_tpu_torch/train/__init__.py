from refinedet_tpu_torch.train.checkpoints import CheckpointManager
from refinedet_tpu_torch.train.schedule import make_lr_schedule
from refinedet_tpu_torch.train.train_step import (SGD, TrainState,
                                                  create_train_state,
                                                  make_optimizer,
                                                  make_train_step,
                                                  train_losses)
from refinedet_tpu_torch.train.trainer import Trainer

__all__ = ["CheckpointManager", "SGD", "TrainState", "Trainer",
           "create_train_state", "make_lr_schedule", "make_optimizer",
           "make_train_step", "train_losses"]
