"""Model registry (counterpart of auformer/nn/registry.py). Only avformer is
ported so far; ROADMAP.md queues the rest of the zoo."""
from __future__ import annotations

import torch

from ..core.config import Config
from ..losses import SUITES, LossSuite


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def build_model(cfg: Config,
                dtype: torch.dtype | None = None) -> torch.nn.Module:
    """The model named by ``cfg.model_name``, on the CPU, with random
    weights, in ``dtype`` (default ``cfg.compute_dtype``, as inference runs
    it; training keeps f32 parameters and computes under autocast)."""
    if cfg.model_name != "avformer":
        raise NotImplementedError(
            f"model {cfg.model_name!r} is not ported to auformer_torch yet; "
            f"ROADMAP.md (queue A, the rest of the model zoo) lists it")
    from .avformer import TwoStreamAuralVisualFormer
    model = TwoStreamAuralVisualFormer(
        modality=cfg.modality, task=cfg.task, n_frames=cfg.n_frames,
        dropout=cfg.dropout_rate)
    return model.to(dtype or compute_dtype(cfg))


def loss_suite(model) -> LossSuite:
    """The losses the model's reference constructor binds."""
    return SUITES[getattr(model, "loss_key", "resnet")]
