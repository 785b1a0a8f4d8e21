"""Train and eval steps (counterpart of auformer/parallel), one device."""
from .step import (FROZEN_PREFIXES, TrainState, create_train_state,
                   learning_rate, make_eval_step, make_optimizer,
                   make_train_step, prep_batch, task_loss, trainable_mask)

__all__ = ["FROZEN_PREFIXES", "TrainState", "create_train_state",
           "learning_rate", "make_eval_step", "make_optimizer",
           "make_train_step", "prep_batch", "task_loss", "trainable_mask"]
