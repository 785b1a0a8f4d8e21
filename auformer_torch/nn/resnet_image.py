"""ImageResNetModel, the simplest single-frame baseline (counterpart of
auformer/nn/resnet_image.py; reference models/resnet.py:16-80): plain
resnet18 features + Dropout(0) + Linear(21), also the fallback for unknown
model names (train.py:315).

The JAX registry builds it with its default modality ("V;M", 4 channels)
and slices the clip's last 4 channels, so its first convolution takes
whatever the clip carries: ``cfg.clip_channels``. The port's takes
``in_channels`` explicitly.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import Dropout
from .resnet import ResNet18
from .vformer import frames_nchw


class ImageResNetModel(nn.Module):
    """(B, 1, H, W, C) clip -> (B, 21) logits."""

    modes = ("clip",)
    loss_key = "resnet"

    def __init__(self, task: str = "AU", in_channels: int = 3):
        super().__init__()
        self.task = task
        self.num_channels = in_channels
        self.base_model = ResNet18(in_channels)
        self.fc = nn.Sequential(Dropout(0.0), nn.Linear(512, 21))

    def forward(self, x: dict) -> torch.Tensor:
        clip = x["clip"][..., -self.num_channels:]
        assert clip.shape[1] == 1, \
            "resnet baseline is single-frame (resnet.py:37)"
        return self.fc(self.base_model(frames_nchw(clip)))
