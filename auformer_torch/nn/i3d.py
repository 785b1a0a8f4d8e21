"""Inception-v1 I3D and VisualI3DModel (counterpart of auformer/nn/i3d.py;
reference models/i3d.py).

Every convolution pads as flax's ``padding="SAME"`` and every pool as the
JAX package's TF-SAME ``max_pool_same``, asymmetrically where the stride
asks for it (``blocks.ConvSame``, ``blocks.max_pool_same``): the
reference's dynamic MaxPool3dSamePadding / Unit3D ``compute_pad``
(i3d.py:21-125). The trunk ends in a global mean over (T, H, W) at any
input size (the reference's fixed [2, 7, 7] pool is that mean at
16x112x112; auformer/nn/i3d.py:124-128). Features (B, 1024) -> Linear 256
-> BN -> Linear 21; the model takes the clip's last three channels.

Parameter names follow ``convert_i3d`` (auformer/core/torch_import.py:
370-390): ``video_model.{endpoint}.conv3d`` / ``.bn`` for the three stem
units, ``video_model.{Mixed_*}.{b0,b1a,b1b,b2a,b2b,b3b}.conv3d`` / ``.bn``
and ``fc.{0,1,2}``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import BatchNorm1d, BatchNorm3d, ConvSame, max_pool_same
from .mc3d import clip_ncthw, rgb_only

# the inception endpoints' channels [b0, b1a, b1b, b2a, b2b, b3b]
# (reference i3d.py:251-295)
MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
STEM_UNITS = ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3")


class Unit3D(nn.Module):
    """SAME Conv3d (no bias) + BatchNorm (eps 1e-3, flax momentum 0.99 =
    torch 0.01) + ReLU (reference i3d.py:55-125)."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.conv3d = ConvSame(in_channels, features, kernel, stride)
        self.bn = BatchNorm3d(features, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv3d(x)))


class InceptionModule(nn.Module):
    """Four branches concatenated on the channels (reference
    i3d.py:128-153): 1x1; 1x1 -> 3x3x3; 1x1 -> 3x3x3; SAME 3x3x3 max pool
    -> 1x1."""

    def __init__(self, in_channels: int, oc: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(in_channels, oc[0])
        self.b1a = Unit3D(in_channels, oc[1])
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, oc[3])
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, oc[5])
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3d(nn.Module):
    """The feature trunk to Mixed_5c and its global mean: (B, 3, T, H, W)
    -> (B, 1024) (reference i3d.py:156-345)."""

    # the SAME max pools that come before these endpoints
    POOLS = {"Conv3d_2b_1x1": ((1, 3, 3), (1, 2, 2)),
             "Mixed_3b": ((1, 3, 3), (1, 2, 2)),
             "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
             "Mixed_5b": ((2, 2, 2), (2, 2, 2))}

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.add_module("Conv3d_1a_7x7",
                        Unit3D(in_channels, 64, (7, 7, 7), (2, 2, 2)))
        self.add_module("Conv3d_2b_1x1", Unit3D(64, 64))
        self.add_module("Conv3d_2c_3x3", Unit3D(64, 192, (3, 3, 3)))
        channels = 192
        for name, oc in MIXED.items():
            module = InceptionModule(channels, oc)
            self.add_module(name, module)
            channels = module.out_channels
        self.endpoints = STEM_UNITS + tuple(MIXED)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.endpoints:
            if name in self.POOLS:
                x = max_pool_same(x, *self.POOLS[name])
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3, 4))


class VisualI3DModel(nn.Module):
    """i3d (reference i3d.py:356-403): the clip's last 3 channels ->
    (B, 21)."""

    modes = ("clip",)
    loss_key = "i3d"

    def __init__(self, modality: str = "V", task: str = "AU"):
        super().__init__()
        rgb_only("i3d", modality)
        self.modality = modality
        self.task = task
        self.video_model = InceptionI3d()
        self.fc = nn.Sequential(nn.Linear(1024, 256), BatchNorm1d(256),
                                nn.Linear(256, 21))

    def forward(self, x: dict) -> torch.Tensor:
        return self.fc(self.video_model(clip_ncthw(x["clip"][..., -3:])))
