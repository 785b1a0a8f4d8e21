"""EmoNet, the landmark-attention single-frame model (counterpart of
auformer/nn/emonet.py; reference models/emonet.py).

A 2-module FAN hourglass of InstanceNorm ConvBlocks gives 68-channel
landmark heatmaps; the channel sum of the last one gates the hourglass
features (the attention mask, auformer/nn/emonet.py:128-129); an emo
branch of 4 ConvBlocks and max pools pools to 256-dim features, which feed
an 8 + 2 expression / valence-arousal MLP and an AU_former.

The output is the (B, 21) layout [AU | EX's first 7 of 8 | VA]
(auformer/nn/emonet.py:176-185). The hourglass halves the resolution four
times below the stem's 4x, so H and W must be multiples of 64: EmoNet's
full width is 256x256. Upsampling is nearest-neighbour (each sample
repeated 2x2). InstanceNorms are affine-free (``blocks.instance_norm``).

Parameter names follow ``convert_emonet`` (auformer/core/torch_import.py:
456-496): ``base_model.conv1``, ConvBlocks ``conv{2,3,4}``,
``m{i}.{b1,b2,b3}_{level}``, ``m{i}.b2_plus_1``, ``top_m_{i}`` (each
``conv{1,2,3}`` and ``downsample.2``), ``conv_last{i}``, ``l{i}``,
``bl0``, ``al0``, ``conv1x1_input_emo_2``, ``emo_net_2.{0,2,4,6}``,
``emo_fc_2.{0,1,3}`` and ``au_head``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm1d, instance_norm
from .heads import AUFormerHead
from .vformer import frames_nchw, modality_channels


def conv3x3(in_planes: int, planes: int) -> nn.Conv2d:
    return nn.Conv2d(in_planes, planes, 3, 1, 1, bias=False)


class InstanceNorm(nn.Module):
    """``instance_norm`` as a module (the reference's affine-free
    ``InstanceNorm2d``: no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class ConvBlock(nn.Module):
    """IN -> ReLU -> 3x3 conv, three times, each to half, then a quarter,
    then a quarter of the output channels, concatenated, plus the input
    (through IN -> ReLU -> 1x1 conv where the widths differ) (reference
    emonet.py:18-60)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.conv1 = conv3x3(in_planes, out_planes // 2)
        self.conv2 = conv3x3(out_planes // 2, out_planes // 4)
        self.conv3 = conv3x3(out_planes // 4, out_planes // 4)
        self.downsample = (nn.Sequential(
            InstanceNorm(), nn.ReLU(),
            nn.Conv2d(in_planes, out_planes, 1, bias=False))
            if in_planes != out_planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o1 = self.conv1(F.relu(instance_norm(x)))
        o2 = self.conv2(F.relu(instance_norm(o1)))
        o3 = self.conv3(F.relu(instance_norm(o2)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([o1, o2, o3], dim=1) + res


class HourGlass(nn.Module):
    """The recursive hourglass of depth 4 (reference emonet.py:62-104)."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            for stem in ("b1", "b2", "b3"):
                self.add_module(f"{stem}_{level}",
                                ConvBlock(features, features))
        self.add_module("b2_plus_1", ConvBlock(features, features))

    def level(self, x: torch.Tensor, level: int) -> torch.Tensor:
        up1 = getattr(self, f"b1_{level}")(x)
        low = getattr(self, f"b2_{level}")(F.max_pool2d(x, 2, 2))
        low = (self.level(low, level - 1) if level > 1
               else self.b2_plus_1(low))
        low = getattr(self, f"b3_{level}")(low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.level(x, self.depth)


class EmoNet(nn.Module):
    """The FAN stem, ``num_modules`` hourglasses and the attention-gated
    emo branch (reference emonet.py:106-202): (B, C, H, W) -> (AU logits
    (B, 12), expression (B, 8), valence/arousal (B, 2))."""

    def __init__(self, in_channels: int = 3, num_modules: int = 2,
                 n_expression: int = 8, n_reg: int = 2, n_blocks: int = 4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"l{i}", nn.Conv2d(256, 68, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(68, 256, 1))
        self.conv1x1_input_emo_2 = nn.Conv2d(256 * (num_modules + 1), 256, 1)
        # [ConvBlock, MaxPool] x n_blocks: the ConvBlocks at even indices
        self.emo_net_2 = nn.Sequential(*[
            m for _ in range(n_blocks)
            for m in (ConvBlock(256, 256), nn.MaxPool2d(2, 2))])
        self.emo_fc_2 = nn.Sequential(
            nn.Linear(256, 128), BatchNorm1d(128), nn.ReLU(),
            nn.Linear(128, n_expression + n_reg))
        self.au_head = AUFormerHead(input_dim=256)

    def forward(self, img: torch.Tensor):
        x = F.relu(instance_norm(self.conv1(img)))
        x = self.conv4(self.conv3(F.max_pool2d(self.conv2(x), 2, 2)))
        previous, hg_features = x, []
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(instance_norm(getattr(self, f"conv_last{i}")(ll)))
            heatmap = getattr(self, f"l{i}")(ll)
            if i < self.num_modules - 1:
                previous = (previous + getattr(self, f"bl{i}")(ll)
                            + getattr(self, f"al{i}")(heatmap))
            hg_features.append(ll)
        feats = torch.cat(hg_features, dim=1)
        feats = feats * heatmap.sum(dim=1, keepdim=True)   # attention mask
        emo = self.conv1x1_input_emo_2(torch.cat([x, feats], dim=1))
        final = self.emo_net_2(emo).mean(dim=(2, 3))
        predict = self.emo_fc_2(final)
        return self.au_head(final)[0], predict[:, :-2], predict[:, -2:]


class ImageEmoNetModel(nn.Module):
    """emonet (reference emonet.py:218-286): the (B, 1, H, W, C) clip ->
    (B, 21) [AU | EX (7) | VA]; H and W multiples of 64."""

    modes = ("clip",)
    loss_key = "emonet"

    def __init__(self, modality: str = "V", task: str = "AU"):
        super().__init__()
        self.modality = modality
        self.task = task
        self.num_channels = modality_channels(modality)
        self.base_model = EmoNet(in_channels=self.num_channels)

    def forward(self, x: dict) -> torch.Tensor:
        clip = x["clip"][..., -self.num_channels:]
        _, t, h, w, _ = clip.shape
        assert t == 1, "emonet is single-frame (reference emonet.py:237)"
        if h % 64 or w % 64:
            raise ValueError(f"emonet needs H and W divisible by 64 (the "
                             f"hourglass geometry), got {h}x{w}")
        au, expression, va = self.base_model(frames_nchw(clip))
        return torch.cat([au.float(), expression[:, :7].float(), va.float()],
                         dim=1)
