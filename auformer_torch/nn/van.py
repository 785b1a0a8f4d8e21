"""The Visual Attention Network backbone and SpatialVAN (counterpart of
auformer/nn/van.py; reference models/van.py).

VAN-base: 4 stages of overlap patch embedding + blocks of large-kernel
attention (LKA: a 5x5 depthwise, a 7x7 depthwise with dilation 3 and
padding 9, a 1x1 pointwise, gating the input), BatchNorm block norms,
layer-scaled residuals, stochastic depth, and a token LayerNorm (eps 1e-6)
over row-major tokens at the end of each stage. SpatialVAN: single-frame
van_base features -> the BN-MLP head's 21 logits, whose AU slice the
AU_former's 12 overwrite (auformer/nn/van.py:213-215).

Numerics that follow the JAX package: GELU is the exact erf form here
(the transformer blocks' is the tanh form); a layer scale is an f32
parameter cast to the activation's dtype before the product (under bf16
autocast an f32 parameter times a bf16 tensor would promote to f32); the
stage LayerNorm's output keeps its input's dtype, as flax's LayerNorm with
``dtype`` does.

Parameter names follow ``convert_van`` (auformer/core/torch_import.py:
331-367): ``base_model.patch_embed{i}.{proj,norm}``,
``base_model.block{i}.{j}.{norm1,attn,norm2,mlp,layer_scale_1,
layer_scale_2}``, ``base_model.norm{i}``, ``fc.{0-3}`` and ``au_head``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import LAYER_NORM_EPS, BatchNorm2d, Dropout, DropPath
from .heads import AUFormerHead
from .vformer import MLPHead, frames_nchw

# van_base (reference van.py:320-328)
EMBED_DIMS = (64, 128, 320, 512)
MLP_RATIOS = (8, 8, 4, 4)
DEPTHS = (3, 3, 12, 3)


def depthwise(dim: int, kernel: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(dim, dim, kernel, padding=dilation * (kernel // 2),
                     dilation=dilation, groups=dim)


class DWConv(nn.Module):
    """3x3 depthwise (reference van.py:270-277)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = depthwise(dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x)


class VanMlp(nn.Module):
    """1x1 conv -> depthwise 3x3 -> GELU (erf) -> 1x1 conv (reference
    van.py:27-61)."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(self.dwconv(self.fc1(x))))
        return self.drop(self.fc2(x))


class LKA(nn.Module):
    """Large-kernel attention (reference van.py:66-80):
    u * conv1(conv_spatial(conv0(u)))."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = depthwise(dim, 5)
        self.conv_spatial = depthwise(dim, 7, dilation=3)
        self.conv1 = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class SpatialAttention(nn.Module):
    """proj_1 -> GELU (erf) -> LKA -> proj_2, plus the input (reference
    van.py:83-99)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.spatial_gating_unit = LKA(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.spatial_gating_unit(F.gelu(self.proj_1(x)))
        return self.proj_2(h) + x


class VanBlock(nn.Module):
    """BN -> attention and BN -> MLP, each layer-scaled, drop-pathed and
    added to the stream (reference van.py:102-138)."""

    def __init__(self, dim: int, mlp_ratio: float, drop: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = BatchNorm2d(dim)
        self.attn = SpatialAttention(dim)
        self.norm2 = BatchNorm2d(dim)
        self.mlp = VanMlp(dim, int(dim * mlp_ratio), drop)
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.drop_path = DropPath(drop_path)

    @staticmethod
    def scaled(scale: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return scale.to(h.dtype)[:, None, None] * h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.scaled(self.layer_scale_1,
                                           self.attn(self.norm1(x))))
        return x + self.drop_path(self.scaled(self.layer_scale_2,
                                              self.mlp(self.norm2(x))))


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv + BN (reference van.py:141-179)."""

    def __init__(self, in_channels: int, dim: int, patch_size: int,
                 stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride,
                              patch_size // 2)
        self.norm = BatchNorm2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x))


class VAN(nn.Module):
    """van_base: (B, 3, H, W) -> (B, 512), the mean of the last stage's
    normalised tokens. Drop-path rates rise linearly over the blocks to
    ``drop_path_rate``."""

    def __init__(self, drop_rate: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        total = sum(DEPTHS)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        in_channels, cur = 3, 0
        for i, (dim, ratio, depth) in enumerate(zip(EMBED_DIMS, MLP_RATIOS,
                                                    DEPTHS)):
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(
                in_channels, dim, 7 if i == 0 else 3, 4 if i == 0 else 2))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                VanBlock(dim, ratio, drop_rate, rates[cur + j])
                for j in range(depth)))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(dim,
                                                       eps=LAYER_NORM_EPS))
            in_channels, cur = dim, cur + depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, len(DEPTHS) + 1):
            x = getattr(self, f"patch_embed{i}")(x)
            for block in getattr(self, f"block{i}"):
                x = block(x)
            b, c, h, w = x.shape
            tokens = x.flatten(2).transpose(1, 2)          # (b, h*w, c)
            tokens = getattr(self, f"norm{i}")(tokens).to(tokens.dtype)
            x = tokens.transpose(1, 2).reshape(b, c, h, w)
        return tokens.mean(dim=1)


class SpatialVAN(nn.Module):
    """van (reference van.py:330-438): the (B, 1, H, W, C) clip's last 3
    channels -> (B, 21)."""

    modes = ("clip",)
    loss_key = "van"

    def __init__(self, modality: str = "V", task: str = "AU"):
        super().__init__()
        self.modality = modality
        self.task = task
        self.base_model = VAN()
        self.fc = MLPHead()
        self.au_head = AUFormerHead()

    def forward(self, x: dict) -> torch.Tensor:
        clip = x["clip"][..., -3:]        # VAN stays 3-channel (van.py:340)
        assert clip.shape[1] == 1, "van is single-frame (reference van.py:361)"
        feats = self.base_model(frames_nchw(clip))
        out = self.fc(feats).float()
        return torch.cat([self.au_head(feats)[0].float(), out[:, 12:]], 1)
