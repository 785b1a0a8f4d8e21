"""Reproducibility (counterpart of auformer/core/prng.py; reference
utils.py:14-19).

``setup_seed`` seeds Python's ``random`` (samplers), numpy and torch's
global RNG (module initialisation), and returns the step's device
``torch.Generator``. ``key_seq`` replaces the JAX package's key sequence:
one fresh generator per train step, seeded from (root seed, step number)
on the host, so a step's draws (augmentation, flip, dropout) do not depend
on how many numbers earlier steps drew, nor on how many steps one dispatch
runs (ROADMAP.md C: the JAX package's K-step dispatch folds one key per
dispatch instead).
"""
from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed the host RNGs and torch's, and return a generator on
    ``device`` seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


class key_seq:
    """Per-step generators: ``ks = key_seq(root); g1 = ks(); g2 = ks()``.
    Each is a new generator on ``root``'s device, seeded from the root's
    seed and the call number by numpy's SeedSequence. ``next_seed()``
    takes the next step's seed instead of its generator: a generator
    reseeded with it draws what ``ks()`` would (the K steps of one
    dispatch, ``parallel.step.make_multi_train_step``, take K of them, so
    the stream does not depend on K)."""

    def __init__(self, root: torch.Generator):
        self.device = root.device
        self.seed = root.initial_seed()
        self.count = 0

    def next_seed(self) -> int:
        state = np.random.SeedSequence(self.seed, spawn_key=(self.count,))
        self.count += 1
        return int(state.generate_state(1, np.uint64)[0] >> 1)

    def __call__(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.next_seed())
