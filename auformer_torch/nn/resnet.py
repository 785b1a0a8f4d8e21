"""ResNet-18 trunks (counterpart of auformer/nn/resnet.py).

  * ``ResFormerTrunk`` — the Former-DFER "S-Former" trunk
    (reference vformer.py:168-268): resnet18 stem + layers1-3, a 49-token
    256-dim spatial transformer between layer3 and layer4, then layer4 +
    global average pool -> (B, 512).
  * ``ResNet18`` — a plain resnet18 feature extractor (torchvision
    semantics) for the audio stream (reference audio.py:22-39).

Layout: the trunks take NCHW tensors (torch's convention; the JAX package's
are NHWC) and keep torchvision's parameter names (``conv1``, ``bn1``,
``layer{i}.{j}.downsample.{0,1}``). BatchNorm: eps 1e-5, momentum 0.1;
in train mode it normalizes with the batch statistics and updates its
running variance with the biased batch variance, as flax does
(``blocks.BatchNorm2d``).
MaxPool2d(3, 2, 1) pads with -inf, as the JAX ``stem_maxpool`` does. The
JAX package's space-to-depth stem is a TPU layout trick with the same
weights and is not ported.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import BatchNorm2d, Transformer


def conv3x3(in_planes: int, planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)


def conv1x1(in_planes: int, planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, planes, 1, stride, 0, bias=False)


class BasicBlock(nn.Module):
    """reference vformer.py:128-165 (torchvision BasicBlock semantics)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.Sequential(conv1x1(in_planes, planes, stride),
                                         BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class ResNetStage(nn.Sequential):
    """Two BasicBlocks (resnet18); the first strides and downsamples."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        needs_ds = stride != 1 or in_planes != planes
        super().__init__(BasicBlock(in_planes, planes, stride, needs_ds),
                         BasicBlock(planes, planes))


class ResNetStem(nn.Module):
    """conv7x7 s2 + BN + relu + maxpool3x3 s2. The reference keeps these
    layers at the top of the trunk (``conv1``, ``bn1``), so the trunks
    inherit the stem instead of nesting it."""

    def __init__(self, in_channels: int, width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, width, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool(self.relu(self.bn1(self.conv1(x))))


class ResFormerTrunk(ResNetStem):
    """S-Former: (B*T, C, H, W) -> (B*T, 512). The layer3 map becomes
    h*w tokens of dim 256, flattened row-major over (h, w) as the JAX
    package's NHWC reshape does, with a learned positional embedding."""

    def __init__(self, in_channels: int = 3, num_patches: int = 49,
                 dim: int = 256, depth: int = 1, heads: int = 8,
                 mlp_dim: int = 512, dim_head: int = 32,
                 dropout: float = 0.0):
        super().__init__(in_channels)
        self.layer1 = ResNetStage(64, 64, 1)
        self.layer2 = ResNetStage(64, 128, 2)
        self.layer3 = ResNetStage(128, 256, 2)
        self.pos_embedding = nn.Parameter(torch.randn(1, num_patches, dim))
        self.spatial_transformer = Transformer(dim, depth, heads, dim_head,
                                               mlp_dim, dropout)
        self.layer4 = ResNetStage(256, 512, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer3(self.layer2(self.layer1(self.stem(x))))
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)                  # (b, h*w, c)
        tokens = tokens + self.pos_embedding[:, :h * w].to(tokens.dtype)
        tokens = self.spatial_transformer(tokens)
        x = tokens.transpose(1, 2).reshape(b, c, h, w)
        return self.layer4(x).mean(dim=(2, 3))


class ResNet18(ResNetStem):
    """Plain resnet18 trunk: (B, C, H, W) -> (B, 512) pooled features."""

    def __init__(self, in_channels: int = 3):
        super().__init__(in_channels)
        self.layer1 = ResNetStage(64, 64, 1)
        self.layer2 = ResNetStage(64, 128, 2)
        self.layer3 = ResNetStage(128, 256, 2)
        self.layer4 = ResNetStage(256, 512, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer2(self.layer1(self.stem(x)))
        return self.layer4(self.layer3(x)).mean(dim=(2, 3))
