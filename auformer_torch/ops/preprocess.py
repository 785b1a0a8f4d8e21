"""Clip preprocessing on the device (counterpart of auformer/ops/preprocess.py).

The host ships raw uint8 clips (4x fewer bytes over PCIe than f32); /255 +
per-channel normalize + the optional train-time flip run on the device.
The public layout stays the JAX package's ``(..., H, W, C)``.

Constants are the Kinetics statistics used everywhere in the reference
(aff2compdataset.py:69-77); the 4th entry is the mask channel (0.5/0.225).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.mesh import draw_rows

CLIP_MEAN = np.array([0.43216, 0.394666, 0.37645, 0.5], np.float32)
CLIP_STD = np.array([0.22803, 0.22145, 0.216989, 0.225], np.float32)


@functools.lru_cache(maxsize=None)
def clip_constants(c: int, device: torch.device, dtype: torch.dtype
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, std, 1/255) of a C-channel clip on ``device`` in ``dtype``,
    made once per (C, device, dtype): a step makes no host-to-device copy,
    so it can be captured in a CUDA graph. Read-only: every caller shares
    them."""
    return (torch.as_tensor(CLIP_MEAN[:c], device=device).to(dtype),
            torch.as_tensor(CLIP_STD[:c], device=device).to(dtype),
            torch.tensor(1.0 / 255.0, dtype=dtype, device=device))


def normalize_clip(clip_u8: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., H, W, C) uint8 -> normalized float. C in {1, 3, 4}; C <= 3
    takes the leading (RGB) constants, C == 4 appends the mask stats."""
    mean, std, inv255 = clip_constants(clip_u8.shape[-1], clip_u8.device,
                                       dtype)
    return (clip_u8.to(dtype) * inv255 - mean) / std


def denormalize_clip(clip: torch.Tensor) -> torch.Tensor:
    """Inverse transform (clip_transforms.py:21-28,85-87): float -> uint8."""
    c = clip.shape[-1]
    mean = torch.as_tensor(CLIP_MEAN[:c], device=clip.device).to(clip.dtype)
    std = torch.as_tensor(CLIP_STD[:c], device=clip.device).to(clip.dtype)
    x = (clip * std + mean) * 255.0
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def random_flip_clips(clip: torch.Tensor, generator: torch.Generator,
                      p: float = 0.5, mesh=None) -> torch.Tensor:
    """Per-sample whole-clip horizontal flip (clip_transforms.py:111-128).
    clip: (B, T, H, W, C). One Bernoulli draw per clip, same for all
    frames, drawn from ``generator`` (which must live on clip's device);
    under a ``mesh`` (core/mesh.py), this rank's rows of the global
    batch's draw."""
    b = clip.shape[0]
    flip = draw_rows(lambda s: torch.rand(s, generator=generator,
                                          device=clip.device),
                     (b,), mesh) < p
    flipped = torch.flip(clip, dims=(3,))
    return torch.where(flip[:, None, None, None, None], flipped, clip)


def normalize_spec_batch(feats: torch.Tensor, mean: float = -14.8,
                         std: float = 19.895) -> torch.Tensor:
    """Audio feature normalize when features come precomputed from host."""
    return (feats - mean) / std
