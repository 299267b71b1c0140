"""Training: the cycle loss, the Adam groups with the non-finite-step skip,
the train and evaluation steps, and the Trainer (counterpart of
cotr_tpu/training)."""

from cotr_tpu_torch.training.loss import cotr_loss, masked_mse
from cotr_tpu_torch.training.optim import build_optimizer, param_labels
from cotr_tpu_torch.training.train_step import (TrainState,
                                                create_train_state,
                                                make_eval_step,
                                                make_train_step)
from cotr_tpu_torch.training.trainer import Trainer

__all__ = [
    "cotr_loss",
    "masked_mse",
    "build_optimizer",
    "param_labels",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
    "Trainer",
]
