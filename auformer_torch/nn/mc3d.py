"""MC3-18 and VisualMC3DModel (counterpart of auformer/nn/mc3d.py;
reference models/mc3d.py:37-83).

MC3 ("mixed convolution") is torchvision's 3-d ResNet-18: a full-3D stem
and layer1 (3x3x3 convolutions), then spatial-only (1x3x3) convolutions
with stride (1, s, s) in layers 2-4, their downsample strided the same
way. Features (B, 512) -> Linear 256 -> BN -> Linear 21.

Clips arrive (B, T, H, W, C) and are viewed as (B, C, T, H, W), a
channels-last-3d tensor for the convolutions. Parameter names are
torchvision's ``mc3_18`` under ``video_model`` (``stem.{0,1}``,
``layer{l}.{b}.conv{1,2}.{0,1}``, ``downsample.{0,1}``) and the
reference's ``fc`` Sequential (``fc.0``, ``fc.1``, ``fc.2``), as
``convert_mc3d`` (auformer/core/torch_import.py:393-418) reads them.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import BatchNorm1d, BatchNorm3d


def clip_ncthw(clip: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, C, T, H, W), a view."""
    return clip.permute(0, 4, 1, 2, 3)


def rgb_only(name: str, modality: str) -> None:
    """The 3-d RGB models take no mask channel (reference mc3d.py:44,
    i3d.py:363)."""
    if "V" not in modality or "M" in modality:
        raise ValueError(f"{name} is RGB-only: modality {modality!r}")


def conv_bn(in_planes: int, planes: int, kernel, stride,
            relu: bool = False) -> nn.Sequential:
    """Conv3d (padding k // 2, no bias) -> BatchNorm3d [-> ReLU]."""
    layers = [nn.Conv3d(in_planes, planes, kernel, stride,
                        tuple(k // 2 for k in kernel), bias=False),
              BatchNorm3d(planes)]
    return nn.Sequential(*layers, *([nn.ReLU(inplace=True)] if relu else []))


class BasicBlock3D(nn.Module):
    """torchvision's video BasicBlock with Conv3DSimple (3x3x3) or
    Conv3DNoTemporal (1x3x3) convolutions."""

    def __init__(self, in_planes: int, planes: int, temporal: bool,
                 stride: int = 1, downsample: bool = False):
        super().__init__()
        k = (3, 3, 3) if temporal else (1, 3, 3)
        s = (stride,) * 3 if temporal else (1, stride, stride)
        self.conv1 = conv_bn(in_planes, planes, k, s, relu=True)
        self.conv2 = conv_bn(planes, planes, k, (1, 1, 1))
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (conv_bn(in_planes, planes, (1, 1, 1), s)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(self.conv2(self.conv1(x)) + identity)


class MC3_18(nn.Module):
    """(B, 3, T, H, W) -> (B, 512)."""

    # (planes, temporal, stride) of layers 1-4, two blocks each
    LAYERS = ((64, True, 1), (128, False, 2), (256, False, 2),
              (512, False, 2))

    def __init__(self):
        super().__init__()
        # BasicStem: Conv3d(3, 64, (3,7,7), s(1,2,2), p(1,3,3)) + BN + ReLU
        self.stem = nn.Sequential(
            nn.Conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False),
            BatchNorm3d(64), nn.ReLU(inplace=True))
        in_planes = 64
        for li, (planes, temporal, stride) in enumerate(self.LAYERS):
            ds = stride != 1 or in_planes != planes
            setattr(self, f"layer{li + 1}", nn.Sequential(
                BasicBlock3D(in_planes, planes, temporal, stride, ds),
                BasicBlock3D(planes, planes, temporal)))
            in_planes = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3, 4))          # AdaptiveAvgPool3d(1)


class VisualMC3DModel(nn.Module):
    """mc3d (reference mc3d.py:37-83): the clip's last 3 channels ->
    (B, 21)."""

    modes = ("clip",)
    loss_key = "mc3d"

    def __init__(self, modality: str = "V", task: str = "AU"):
        super().__init__()
        rgb_only("mc3d", modality)
        self.modality = modality
        self.task = task
        self.video_model = MC3_18()
        self.fc = nn.Sequential(nn.Linear(512, 256), BatchNorm1d(256),
                                nn.Linear(256, 21))

    def forward(self, x: dict) -> torch.Tensor:
        return self.fc(self.video_model(clip_ncthw(x["clip"][..., -3:])))
