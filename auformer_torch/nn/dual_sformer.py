"""DualSpatialFormer (counterpart of auformer/nn/dual_sformer.py; reference
models/dual_sformer.py:279-365): two single-frame ResFormer trunks, RGB
(3 channels) and mask (1 channel), whose 512-dim features are summed before
the BN-MLP head. Modality ``V;M`` only: the mask is the clip's last
channel (the dataset's ``use_mask`` path).
"""
from __future__ import annotations

import torch
from torch import nn

from .resnet import ResFormerTrunk
from .vformer import MLPHead, frames_nchw


class DualSpatialFormer(nn.Module):
    """(B, 1, H, W, 4) clip -> (B, 21)."""

    modes = ("clip",)
    loss_key = "dsformer"

    def __init__(self, modality: str = "V;M", task: str = "AU"):
        super().__init__()
        if not ("V" in modality and "M" in modality):
            raise ValueError("dsformer needs RGB + mask input, modality "
                             f"'V;M' (dual_sformer.py:282); got {modality!r}")
        self.modality = modality
        self.task = task
        self.rgb_model = ResFormerTrunk(3)
        self.mask_model = ResFormerTrunk(1)
        self.fc = MLPHead()

    def forward(self, x: dict) -> torch.Tensor:
        clip = x["clip"]
        assert clip.shape[1] == 1, \
            "dsformer is single-frame (dual_sformer.py:308)"
        frames = frames_nchw(clip)
        feats = (self.rgb_model(frames[:, :-1])
                 + self.mask_model(frames[:, -1:]))  # (dual_sformer.py:315)
        return self.fc(feats)
