"""SpatialFormer, the single-frame spatial model (counterpart of
auformer/nn/sformer.py; reference models/sformer.py:338-449): the ResFormer
trunk with dropout 0.2, the BN-MLP 512->256->21 head, and the AU_former /
VA_former heads overriding the AU / VA slices by task.
"""
from __future__ import annotations

import torch
from torch import nn

from .heads import AUFormerHead, VAFormerHead
from .resnet import ResFormerTrunk
from .vformer import MLPHead, frames_nchw, modality_channels


class SpatialFormer(nn.Module):
    """(B, 1, H, W, C) clip -> (B, 21): the MLP head's logits, the AU
    columns from ``au_head`` under task AU, the VA columns from ``va_head``
    under task VA."""

    modes = ("clip",)
    loss_key = "sformer"

    def __init__(self, modality: str = "V", task: str = "AU",
                 dropout: float = 0.2):
        super().__init__()
        self.modality = modality
        self.task = task
        self.num_channels = modality_channels(modality)
        self.base_model = ResFormerTrunk(self.num_channels, dropout=dropout)
        self.fc = MLPHead()
        if task == "AU":
            self.au_head = AUFormerHead(dropout=dropout)
        if task == "VA":
            self.va_head = VAFormerHead(dropout=dropout)

    def forward(self, x: dict) -> torch.Tensor:
        clip = x["clip"][..., -self.num_channels:]
        assert clip.shape[1] == 1, \
            "sformer is single-frame (reference sformer.py:368)"
        feats = self.base_model(frames_nchw(clip))
        out = self.fc(feats).float()
        if self.task == "AU":
            out = torch.cat([self.au_head(feats)[0].float(), out[:, 12:]], 1)
        if self.task == "VA":
            out = torch.cat([out[:, :-2], self.va_head(feats)[0].float()], 1)
        return out
