"""Checkpoints (counterpart of auformer/core/checkpointing.py; reference
utils.py:7-11, train.py:247,273-276).

A checkpoint is ``torch.save`` of the model's reference-layout state dict
(CPU f32 tensors) at ``{dir}/{name}.pth``: ``latest.pth`` every epoch,
``best.pth`` from the early stopper. These are the files the upstream
reference reads, the JAX package's ``--resume`` falls back to
(train_lib.py:203-211, ``convert_checkpoint`` + ``merge_into``), and the
port's ``load_reference_state_dict`` / ``test_aff2`` read. Optimizer state
is not saved, in either package.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from .weights import load_reference_state_dict


def checkpoint_file(checkpoint_dir: str, name: str) -> str:
    return os.path.join(checkpoint_dir, f"{name}.pth")


def model_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's state dict as CPU tensors (f32 parameters and BatchNorm
    statistics; ``num_batches_tracked`` as torch keeps it)."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def save_checkpoint(checkpoint_dir: str,
                    state_dict: Mapping[str, torch.Tensor],
                    name: str = "latest") -> str:
    """Write ``state_dict`` to ``{checkpoint_dir}/{name}.pth`` (through a
    temporary file, so a reader never sees half a checkpoint)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = checkpoint_file(checkpoint_dir, name)
    torch.save(dict(state_dict), path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(checkpoint_dir: str, name: str = "latest"
                    ) -> Optional[dict[str, torch.Tensor]]:
    """The state dict at ``{checkpoint_dir}/{name}.pth``, or None when
    absent (the DDP ``module.`` prefix stripped)."""
    path = checkpoint_file(checkpoint_dir, name)
    if not os.path.isfile(path):
        return None
    return load_reference_state_dict(path)


class EarlyStopper:
    """Best-score tracking + patience (reference train.py:84-103)."""

    def __init__(self, num_trials: int, checkpoint_dir: str):
        self.num_trials = num_trials
        self.trial_counter = 0
        self.best_accuracy = 0.0
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)

    def is_continuable(self, state_dict: Mapping[str, torch.Tensor] | None,
                       accuracy: float) -> bool:
        """Track ``accuracy``; a new best writes ``state_dict`` to
        ``best.pth`` (None writes nothing: a data-parallel rank other than
        0, which takes the same decisions from the same scores)."""
        if accuracy > self.best_accuracy:
            self.best_accuracy = accuracy
            self.trial_counter = 0
            if state_dict is not None:
                save_checkpoint(self.checkpoint_dir, state_dict, name="best")
            return True
        if self.trial_counter + 1 < self.num_trials:
            self.trial_counter += 1
            return True
        return False
