"""Step timing, profiler traces and training curves (counterpart of
auformer/core/observability.py; reference train.py:22-82).

  * ``StepTimer``: per-step host timing split into data wait and step
    (the t1/t2 pattern of train.py:197-205);
  * ``profile``: a ``torch.profiler`` scope that writes a Chrome trace
    into a directory (``--profile_dir``: steps 10-15 of training's first
    epoch, ``train_lib.train``);
  * ``RecorderMeter``: epoch-indexed loss/accuracy curves, written as
    ``curves.json``. The JAX package's optional matplotlib plot is not
    ported (the card's machine has no matplotlib).
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


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


@contextlib.contextmanager
def profile(trace_dir: str, device: torch.device):
    """``torch.profiler`` scope over the host's activity and, on a CUDA
    device, the card's; on exit it writes ``trace_<time>_<pid>.json``
    (Chrome trace format) into ``trace_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
        f"{os.getpid()}.json"))


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
