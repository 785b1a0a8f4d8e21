"""Model registry (counterpart of auformer/nn/registry.py). Only avformer is
ported so far; ROADMAP.md queues the rest of the zoo."""
from __future__ import annotations

import torch

from ..core.config import Config
from ..losses import SUITES, LossSuite


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def compute_autocast(cfg: Config, device) -> torch.autocast:
    """The context every forward runs its modules in: bf16 ``torch.autocast``
    under ``compute_dtype=bfloat16`` (bf16 convolutions and matmuls on f32
    parameters, f32 norms with f32 statistics, the AU heads' token
    projection and logits f32 from bf16 operands), the counterpart of the
    JAX modules' ``dtype`` with f32 ``param_dtype``
    (auformer/nn/registry.py); a no-op in float32. Inference and training
    share it."""
    return torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                          enabled=compute_dtype(cfg) == torch.bfloat16)


def prepare_inference(cfg: Config, model: torch.nn.Module,
                      device: torch.device) -> torch.nn.Module:
    """Move ``model`` (in place) to ``device`` with f32 parameters, in eval
    mode, for forwards under ``compute_autocast``. Under bf16 its
    convolution and Linear weights are rounded to bf16 here, once: the
    copies autocast would otherwise make at every call, so the arithmetic
    is the same (rounding a weight once equals rounding it at each use).
    Norms and their statistics, biases and embeddings stay f32. The model
    is then an inference model: its rounded weights do not return to f32
    values."""
    model.to(device=device, dtype=torch.float32).eval()
    if compute_dtype(cfg) == torch.bfloat16:
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.weight.data = m.weight.data.bfloat16()
    return model


def build_model(cfg: Config,
                dtype: torch.dtype | None = None) -> torch.nn.Module:
    """The model named by ``cfg.model_name``, on the CPU, with random
    weights, in ``dtype`` (default float32: inference and training keep f32
    parameters and compute under ``compute_autocast``)."""
    if cfg.model_name != "avformer":
        raise NotImplementedError(
            f"model {cfg.model_name!r} is not ported to auformer_torch yet; "
            f"ROADMAP.md (queue A, the rest of the model zoo) lists it")
    from .avformer import TwoStreamAuralVisualFormer
    model = TwoStreamAuralVisualFormer(
        modality=cfg.modality, task=cfg.task, n_frames=cfg.n_frames,
        dropout=cfg.dropout_rate)
    return model.to(dtype or torch.float32)


def loss_suite(model) -> LossSuite:
    """The losses the model's reference constructor binds."""
    return SUITES[getattr(model, "loss_key", "resnet")]
