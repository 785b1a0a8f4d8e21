"""Former-DFER style visual stream (counterpart of auformer/nn/vformer.py).

``TFormer``: CLS-token temporal encoder over the 16 per-frame embeddings
(reference vformer.py:270-293). ``VideoModel``: S-Former trunk folding time
into batch + TFormer (vformer.py:295-311). Clips arrive (B, T, H, W, C); the
model consumes the LAST ``num_channels`` channels (vformer.py:313-331).
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import Transformer
from .resnet import ResFormerTrunk


class TFormer(nn.Module):
    """Temporal CLS transformer (reference vformer.py:270-293)."""

    def __init__(self, num_patches: int = 16, dim: int = 512, depth: int = 3,
                 heads: int = 8, mlp_dim: int = 1024, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        self.num_patches = num_patches
        self.dim = dim
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, num_patches + 1, dim))
        self.spatial_transformer = Transformer(dim, depth, heads, dim_head,
                                               mlp_dim, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(-1, self.num_patches, self.dim)
        b, n, _ = x.shape
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding[:, :n + 1].to(x.dtype)
        return self.spatial_transformer(x)[:, 0]


class VideoModel(nn.Module):
    """S-Former + T-Former feature extractor: (B, T, H, W, C) -> (B, 512)."""

    def __init__(self, num_channels: int = 3, n_frames: int = 16,
                 dropout: float = 0.0):
        super().__init__()
        self.num_channels = num_channels
        self.s_former = ResFormerTrunk(num_channels, dropout=dropout)
        self.t_former = TFormer(num_patches=n_frames, dropout=dropout)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        x = clip[..., -self.num_channels:]
        b, t, h, w, c = x.shape
        # NHWC frames viewed as NCHW: a channels-last tensor for the convs
        x = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        feats = self.s_former(x).reshape(b, t, -1)
        return self.t_former(feats)
