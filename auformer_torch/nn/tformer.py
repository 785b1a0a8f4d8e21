"""SpatialTemporalFormer (counterpart of auformer/nn/tformer.py; reference
models/tformer.py:296-455): per-frame AU_former tokens (12 x 128 = 1536
per frame) become the temporal sequence of a dim-1536 TFormer; a depth-3
tformer_AU_head over the pooled 12 x 128 tokens writes the AU columns.
"""
from __future__ import annotations

import torch
from torch import nn

from .heads import AUFormerHead, FormerAUHead
from .resnet import ResFormerTrunk
from .vformer import MLPHead, TFormer, frames_nchw, modality_channels

TOKENS_DIM = 12 * 128


class TformerVideoModel(nn.Module):
    """s_former -> per-frame AU tokens -> TFormer(dim=1536) -> (B, 1536)
    (reference tformer.py:296-316)."""

    def __init__(self, num_channels: int = 3, n_frames: int = 16,
                 dropout: float = 0.2):
        super().__init__()
        self.num_channels = num_channels
        self.s_former = ResFormerTrunk(num_channels)
        self.au_head = AUFormerHead(dropout=dropout)
        self.t_former = TFormer(num_patches=n_frames, dim=TOKENS_DIM)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        x = clip[..., -self.num_channels:]
        b, t = x.shape[:2]
        _, tokens = self.au_head(self.s_former(frames_nchw(x)))
        return self.t_former(tokens.reshape(b, t, TOKENS_DIM))


class SpatialTemporalFormer(nn.Module):
    """tformer: the clip -> (B, 21); the AU columns always come from the
    tformer_AU_head (tformer.py:415,429-434), whatever the task."""

    modes = ("clip",)
    loss_key = "tformer"

    def __init__(self, modality: str = "V", task: str = "AU",
                 n_frames: int = 16, dropout: float = 0.2):
        super().__init__()
        self.modality = modality
        self.task = task
        self.num_channels = modality_channels(modality)
        self.video_model = TformerVideoModel(self.num_channels, n_frames,
                                             dropout)
        self.fc = MLPHead(in_features=TOKENS_DIM)
        self.au_head = FormerAUHead(emb_dim=128, dropout=dropout, depth=3,
                                    mlp_dim=256)

    def forward(self, x: dict) -> torch.Tensor:
        feats = self.video_model(x["clip"])
        out = self.fc(feats).float()
        au = self.au_head(feats.reshape(-1, 12, 128)).float()
        return torch.cat([au, out[:, 12:]], 1)
