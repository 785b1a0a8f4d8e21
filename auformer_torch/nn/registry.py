"""Model registry (counterpart of auformer/nn/registry.py; dispatch as the
reference's train.py:292-315): every model of the JAX package's zoo,
avformer, vformer, sformer, tformer, dsformer, vggformer, audio, van,
emonet, i3d, mc3d, tsav and the resnet baseline, which is also the
fallback for unknown names."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.config import Config
from ..losses import SUITES, LossSuite


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def compute_autocast(cfg: Config, device,
                     cache_enabled: bool = True) -> torch.autocast:
    """The context every forward runs its modules in: bf16 ``torch.autocast``
    under ``compute_dtype=bfloat16`` (bf16 convolutions and matmuls on f32
    parameters, f32 norms with f32 statistics, the AU heads' token
    projection and logits f32 from bf16 operands), the counterpart of the
    JAX modules' ``dtype`` with f32 ``param_dtype``
    (auformer/nn/registry.py); a no-op in float32. Inference and training
    share it. ``cache_enabled=False`` for a region captured in a CUDA
    graph, as PyTorch requires: each use casts anew, to the same values."""
    return torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                          enabled=compute_dtype(cfg) == torch.bfloat16,
                          cache_enabled=cache_enabled)


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
    # every convolution and Linear of the zoo is one of these
    if compute_dtype(cfg) == torch.bfloat16:
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d,
                              torch.nn.Linear)):
                m.weight.data = m.weight.data.bfloat16()
    return model


def output_table(logits: torch.Tensor) -> torch.Tensor:
    """A model's output in the (B, 21) layout [12 AU | 7 EX | 2 VA] that
    the losses, the evaluation and the submission writers read. tsav's 22
    columns [12 AU | 8 EX | 2 VA] map to columns [0:12 | 12:19 | 20:22]
    (ROADMAP.md C5: the JAX package reads its columns 19 and 20 as VA, the
    8th EX logit and valence); every other model's 21 columns pass as they
    are."""
    if logits.shape[1] == 22:
        return torch.cat([logits[:, :19], logits[:, 20:]], dim=1)
    return logits


#: models whose clip is one frame (the JAX package's example_batch)
SINGLE_FRAME = ("sformer", "dsformer", "van", "emonet", "resnet")


def _build(cfg: Config) -> torch.nn.Module:
    name, modality, task = cfg.model_name, cfg.modality, cfg.task
    if name == "avformer":
        from .avformer import TwoStreamAuralVisualFormer
        return TwoStreamAuralVisualFormer(modality, task, cfg.n_frames,
                                          cfg.dropout_rate)
    if name == "vformer":
        from .vformer import VisualFormer
        return VisualFormer(modality, task, cfg.n_frames)
    if name == "vggformer":
        from .vggformer import VGGVisualFormer
        return VGGVisualFormer(modality, task, cfg.n_frames)
    if name == "tformer":
        from .tformer import SpatialTemporalFormer
        return SpatialTemporalFormer(modality, task, cfg.n_frames,
                                     cfg.dropout_rate)
    if name == "sformer":
        from .sformer import SpatialFormer
        return SpatialFormer(modality, task, cfg.dropout_rate)
    if name == "dsformer":
        from .dual_sformer import DualSpatialFormer
        return DualSpatialFormer(modality, task)
    if name == "audio":
        from .avformer import AudioOnly
        return AudioOnly(modality, task, cfg.dropout_rate)
    if name == "van":
        from .van import SpatialVAN
        return SpatialVAN(modality, task)
    if name == "emonet":
        from .emonet import ImageEmoNetModel
        return ImageEmoNetModel(modality, task)
    if name == "i3d":
        from .i3d import VisualI3DModel
        return VisualI3DModel(modality, task)
    if name == "mc3d":
        from .mc3d import VisualMC3DModel
        return VisualMC3DModel(modality, task)
    if name == "tsav":
        from .tsav import TwoStreamAuralVisualModel
        return TwoStreamAuralVisualModel(modality, task)
    from .resnet_image import ImageResNetModel
    return ImageResNetModel(task, cfg.clip_channels)


def build_model(cfg: Config,
                dtype: torch.dtype | None = None) -> torch.nn.Module:
    """The model named by ``cfg.model_name`` (the resnet baseline for an
    unknown name, as the reference's dispatch), on the CPU, with random
    weights, in ``dtype`` (default float32: inference and training keep f32
    parameters and compute under ``compute_autocast``)."""
    return _build(cfg).to(dtype or torch.float32)


def example_batch(cfg: Config, batch_size: int | None = None,
                  rng: np.random.RandomState | None = None
                  ) -> dict[str, Any]:
    """A correctly shaped numpy input dict for the configured model (the
    JAX package's ``example_batch``): a normalized-scale clip (T = 1 for
    the single-frame models; none for ``audio``) and, where the model or
    ``cfg.use_audio`` takes them, audio features."""
    rng = rng or np.random.RandomState(0)
    b = batch_size or cfg.batch_size
    name = cfg.model_name
    t = 1 if name in SINGLE_FRAME else cfg.n_frames
    c = cfg.clip_channels if "V" in cfg.modality or "M" in cfg.modality \
        else 3
    x: dict[str, Any] = {}
    if name != "audio":
        x["clip"] = rng.randn(b, t, cfg.image_size, cfg.image_size,
                              c).astype(np.float32)
    if cfg.use_audio or name in ("avformer", "audio", "tsav"):
        x["audio_features"] = rng.randn(b, 1, cfg.n_mels,
                                        cfg.mel_frames).astype(np.float32)
    return x


def loss_suite(model) -> LossSuite:
    """The losses the model's reference constructor binds."""
    return SUITES[getattr(model, "loss_key", "resnet")]
