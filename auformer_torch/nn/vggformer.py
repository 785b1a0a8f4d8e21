"""VGGFace2-backboned visual former (counterpart of auformer/nn/vggformer.py;
reference models/vggformer.py).

``VGGFace2Extractor``: the ResNet-50 Bottleneck trunk of the VGGFace2 repo,
its stride on each bottleneck's conv1 and its stem max-pool in ceil mode
(vggformer.py:62-115) -> (B*T, 2048, 4, 4) at 112 px. ``VGGFormerTrunk``:
the trunk, a 1x1 conv to 512, a depth-1 spatial transformer over the h*w
tokens with ``pos_embedding[:, :h*w]``, and the mean over tokens
(vggformer.py:250-296). ``VGGConvTrunk`` is the no-transformer ablation
(vggformer.py:218-248). ``VGGVisualFormer``: the trunk per frame ->
TFormer -> Linear + BN + ReLU + Linear (vggformer.py:364-402; this head
has a ReLU and no input BN, unlike vformer's).

Parameter names follow the reference: ``video_model.s_former.VGG_model.
layer{i}.{j}.conv1`` ..., ``fc.0`` / ``fc.1`` / ``fc.3``.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import BatchNorm1d, BatchNorm2d, Transformer
from .resnet import conv1x1
from .vformer import TFormer, frames_nchw

#: (planes, blocks) of the four stages: resnet50
VGG_LAYERS = ((64, 3), (128, 4), (256, 6), (512, 3))


class Bottleneck(nn.Module):
    """1x1 (strided, as the VGGFace2 repo's, vggformer.py:30) -> 3x3 ->
    1x1 to 4 x planes, each with BatchNorm, plus the identity or a strided
    1x1 downsample."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv1x1(in_planes, planes, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv1x1(planes, planes * 4)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (nn.Sequential(conv1x1(in_planes, planes * 4, stride),
                                         BatchNorm2d(planes * 4))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + identity)


class VGGFace2Extractor(nn.Module):
    """ResNet-50 trunk: (N, 3, H, W) -> (N, 2048, h, w). The stem's
    MaxPool2d(3, 2, 0, ceil_mode=True) lets the last partial window count,
    as the JAX package's right/bottom -inf padding does."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 0, ceil_mode=True)
        in_planes = 64
        for li, (planes, blocks) in enumerate(VGG_LAYERS):
            stride = 1 if li == 0 else 2
            stage = []
            for bi in range(blocks):
                st = stride if bi == 0 else 1
                stage.append(Bottleneck(
                    in_planes, planes, st,
                    bi == 0 and (st != 1 or in_planes != planes * 4)))
                in_planes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x


class VGGFormerTrunk(nn.Module):
    """trunk + conv1x1(2048->512) + spatial transformer + mean over tokens:
    (N, 3, H, W) -> (N, 512)."""

    def __init__(self, dim: int = 512, depth: int = 1, heads: int = 8,
                 mlp_dim: int = 512, dim_head: int = 32,
                 num_patches: int = 49, dropout: float = 0.0):
        super().__init__()
        self.VGG_model = VGGFace2Extractor()
        self.conv = conv1x1(2048, dim)
        self.pos_embedding = nn.Parameter(torch.randn(1, num_patches, dim))
        self.spatial_transformer = Transformer(dim, depth, heads, dim_head,
                                               mlp_dim, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(self.VGG_model(x))
        _, _, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)                  # (N, h*w, c)
        tokens = tokens + self.pos_embedding[:, :h * w].to(tokens.dtype)
        return self.spatial_transformer(tokens).mean(dim=1)


class VGGConvTrunk(nn.Module):
    """The no-transformer ablation: trunk + conv1x1 + mean -> (N, 512)."""

    def __init__(self):
        super().__init__()
        self.VGG_model = VGGFace2Extractor()
        self.conv = conv1x1(2048, 512)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.VGG_model(x)).mean(dim=(2, 3))


class VGGVideoModel(nn.Module):
    """``s_former`` per frame -> ``t_former`` -> (B, 512)."""

    def __init__(self, n_frames: int = 16):
        super().__init__()
        self.s_former = VGGFormerTrunk()
        self.t_former = TFormer(num_patches=n_frames)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        x = clip[..., -3:]
        feats = self.s_former(frames_nchw(x))
        return self.t_former(feats.reshape(x.shape[0], x.shape[1], 512))


class VGGVisualFormer(nn.Module):
    """vggformer: the clip -> (B, 21). Temporal: its TFormer reshapes the
    frame features to (-1, n_frames, 512), so a clip carries n_frames
    frames."""

    modes = ("clip",)
    loss_key = "vggformer"

    def __init__(self, modality: str = "V", task: str = "AU",
                 n_frames: int = 16):
        super().__init__()
        self.modality = modality
        self.task = task
        self.video_model = VGGVideoModel(n_frames)
        self.fc = nn.Sequential(nn.Linear(512, 256), BatchNorm1d(256),
                                nn.ReLU(inplace=True), nn.Linear(256, 21))

    def forward(self, x: dict) -> torch.Tensor:
        return self.fc(self.video_model(x["clip"]))
