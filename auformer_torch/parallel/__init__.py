"""Train and eval steps (counterpart of auformer/parallel), one device."""
from .step import (FROZEN_PREFIXES, MultiTrainStep, TrainState,
                   create_train_state, expand_dedup_batch,
                   gather_arena_windows, learning_rate, make_device_stacker,
                   make_eval_step, make_multi_train_step, make_optimizer,
                   make_train_step, prep_batch, stack_batches, task_loss,
                   trainable_mask)

__all__ = ["FROZEN_PREFIXES", "MultiTrainStep", "TrainState",
           "create_train_state", "expand_dedup_batch",
           "gather_arena_windows", "learning_rate", "make_device_stacker",
           "make_eval_step", "make_multi_train_step", "make_optimizer",
           "make_train_step", "prep_batch", "stack_batches", "task_loss",
           "trainable_mask"]
