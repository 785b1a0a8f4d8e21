"""TwoStreamAuralVisualModel, the ABAW2020 TNT baseline (counterpart of
auformer/nn/tsav.py; reference models/tsav.py:65-143): an R(2+1)D-18
video stream and the 1-channel resnet18 audio stream, 512 + 512 features
(audio first) -> Dropout(0) + Linear -> 22 outputs: 12 AU, 8 EX, 2 VA.

The 22 columns are the JAX module's; ``nn.registry.output_table`` maps them
into the (B, 21) layout every consumer reads (ROADMAP.md C5).

R(2+1)D factorises every 3-d convolution into a (1,3,3) spatial one with
stride (1, s, s), BatchNorm + ReLU, and a (3,1,1) temporal one with
stride (s, 1, 1); the downsample is a 1x1x1 convolution with stride
(s, s, s). Each factorised convolution has the midplane count
``(in * out * 27) // (in * 9 + 3 * out)`` of its own in/out planes, as the
JAX module computes it (auformer/nn/tsav.py:29-31): torchvision's block
computes it once from the block's (in, out) planes for both, which differs
in the second convolution of layers 2-4's first blocks (ROADMAP.md C6).

Parameter names follow ``convert_tsav`` (auformer/core/torch_import.py:
499-524): torchvision's Conv2Plus1D Sequentials under
``video_model.r2plus1d`` (``stem.{0,1,3,4}``, ``layer{l}.{b}.conv{1,2}.0.
{0,1,3}`` and ``.1``, ``downsample.{0,1}``), ``audio_model.resnet`` and
``fc.1``.
"""
from __future__ import annotations

import torch
from torch import nn

from .avformer import AudioModel
from .blocks import BatchNorm3d, Dropout
from .mc3d import clip_ncthw


def midplanes(in_planes: int, out_planes: int) -> int:
    return (in_planes * out_planes * 27) // (in_planes * 9 + 3 * out_planes)


class Conv2Plus1D(nn.Sequential):
    """(1,3,3) spatial conv -> BN -> ReLU -> (3,1,1) temporal conv."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        mid = midplanes(in_planes, out_planes)
        super().__init__(
            nn.Conv3d(in_planes, mid, (1, 3, 3), (1, stride, stride),
                      (0, 1, 1), bias=False),
            BatchNorm3d(mid), nn.ReLU(inplace=True),
            nn.Conv3d(mid, out_planes, (3, 1, 1), (stride, 1, 1), (1, 0, 0),
                      bias=False))


class R2Plus1DBlock(nn.Module):
    """torchvision's video BasicBlock with Conv2Plus1D convolutions."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(Conv2Plus1D(in_planes, planes, stride),
                                   BatchNorm3d(planes), nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(Conv2Plus1D(planes, planes),
                                   BatchNorm3d(planes))
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(
            nn.Conv3d(in_planes, planes, 1, stride, bias=False),
            BatchNorm3d(planes)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(self.conv2(self.conv1(x)) + identity)


class R2Plus1D18(nn.Module):
    """(B, C, T, H, W) -> (B, 512). The stem: (1,7,7) s(1,2,2) to 45
    channels, BN, ReLU, (3,1,1) to 64, BN, ReLU."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv3d(in_channels, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                      bias=False),
            BatchNorm3d(45), nn.ReLU(inplace=True),
            nn.Conv3d(45, 64, (3, 1, 1), 1, (1, 0, 0), bias=False),
            BatchNorm3d(64), nn.ReLU(inplace=True))
        in_planes = 64
        for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2),
                                               (512, 2))):
            ds = stride != 1 or in_planes != planes
            setattr(self, f"layer{li + 1}", nn.Sequential(
                R2Plus1DBlock(in_planes, planes, stride, ds),
                R2Plus1DBlock(planes, planes)))
            in_planes = planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3, 4))


class VideoStream(nn.Module):
    """The reference's video stream module: ``r2plus1d`` (its fc replaced
    by Dummy in the reference, so omitted)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.r2plus1d = R2Plus1D18(in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.r2plus1d(x)


class TwoStreamAuralVisualModel(nn.Module):
    """tsav: ``{"clip": (B, T, H, W, C), "audio_features": (B, 1, 64, T)}``
    -> (B, 22) float32 logits."""

    modes = ("clip", "audio_features")
    loss_key = "tsav"

    def __init__(self, modality: str = "A;V", task: str = "AU"):
        super().__init__()
        self.modality = modality
        self.task = task
        self.num_channels = 4 if ("M" in modality and "V" in modality) else 3
        self.audio_model = AudioModel()
        self.video_model = VideoStream(self.num_channels)
        self.fc = nn.Sequential(Dropout(0.0), nn.Linear(1024, 22))

    def forward(self, x: dict) -> torch.Tensor:
        clip = clip_ncthw(x["clip"][..., -self.num_channels:])
        feats = torch.cat([self.audio_model(x["audio_features"]),
                           self.video_model(clip)], dim=1)
        return self.fc(feats).float()
