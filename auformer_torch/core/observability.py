"""Step timing and training curves (counterpart of
auformer/core/observability.py; reference train.py:22-82).

  * ``StepTimer``: per-step host timing split into data wait and step
    (the t1/t2 pattern of train.py:197-205);
  * ``RecorderMeter``: epoch-indexed loss/accuracy curves, written as
    ``curves.json``. The JAX package's optional matplotlib plot is not
    ported (the card's machine has no matplotlib), nor its profiler scope
    (``profile_dir`` raises in ``train_lib``).
"""
from __future__ import annotations

import json
import time

import numpy as np


class StepTimer:
    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self._t = time.perf_counter()

    def mark_data(self):
        now = time.perf_counter()
        self.data_time = now - self._t
        self._t = now

    def mark_step(self):
        now = time.perf_counter()
        self.step_time = now - self._t
        self._t = now


class RecorderMeter:
    """Epoch loss/accuracy recorder (reference train.py:22-82)."""

    def __init__(self, total_epoch: int):
        self.reset(total_epoch)

    def reset(self, total_epoch: int):
        self.total_epoch = total_epoch
        self.current_epoch = 0
        self.epoch_losses = np.zeros((total_epoch, 2), np.float32)
        self.epoch_accuracy = np.zeros((total_epoch, 2), np.float32)

    def update(self, idx, train_loss, train_acc, val_loss, val_acc):
        self.epoch_losses[idx, 0] = train_loss * 50
        self.epoch_losses[idx, 1] = val_loss * 50
        self.epoch_accuracy[idx, 0] = train_acc
        self.epoch_accuracy[idx, 1] = val_acc
        self.current_epoch = idx + 1

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump({"losses_x50": self.epoch_losses.tolist(),
                       "accuracy": self.epoch_accuracy.tolist(),
                       "current_epoch": self.current_epoch}, f)
