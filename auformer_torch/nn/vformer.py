"""Former-DFER style visual stream (counterpart of auformer/nn/vformer.py).

``TFormer``: CLS-token temporal encoder over the 16 per-frame embeddings
(reference vformer.py:270-293). ``VideoModel``: S-Former trunk folding time
into batch + TFormer (vformer.py:295-311). ``VisualFormer``: the vformer
model with the BN-MLP 512->256->21 head (vformer.py:358-405). Clips arrive
(B, T, H, W, C); the model consumes the LAST ``num_channels`` channels
(vformer.py:313-331).
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import BatchNorm1d, Transformer
from .resnet import ResFormerTrunk


def modality_channels(modality: str) -> int:
    """Clip channels a model consumes (reference vformer.py:313-331): 4 for
    RGB + mask, 1 for the mask alone, else 3."""
    if "M" in modality:
        return 4 if "V" in modality else 1
    return 3


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


def frames_nchw(clip: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, C, H, W): NHWC frames viewed as NCHW, a
    channels-last tensor for the convolutions."""
    b, t, h, w, c = clip.shape
    return clip.reshape(b * t, h, w, c).permute(0, 3, 1, 2)


class VideoModel(nn.Module):
    """S-Former + T-Former feature extractor: (B, T, H, W, C) -> (B, 512);
    ``num_classes`` adds the torch model's ``fc`` (replaced by Dummy where
    the model is embedded, vformer.py:374)."""

    def __init__(self, num_channels: int = 3, n_frames: int = 16,
                 dropout: float = 0.0, num_classes: int | None = None):
        super().__init__()
        self.num_channels = num_channels
        self.s_former = ResFormerTrunk(num_channels, dropout=dropout)
        self.t_former = TFormer(num_patches=n_frames, dropout=dropout)
        if num_classes is not None:
            self.fc = nn.Linear(512, num_classes)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        x = clip[..., -self.num_channels:]
        feats = self.s_former(frames_nchw(x)).reshape(x.shape[0],
                                                      x.shape[1], -1)
        out = self.t_former(feats)
        return self.fc(out) if hasattr(self, "fc") else out


class MLPHead(nn.Sequential):
    """BN -> Linear(256) -> BN -> Linear(21) (reference vformer.py:368-373;
    the same head in sformer, tformer and dual_sformer), named ``0``-``3``
    as the reference's ``nn.Sequential``."""

    def __init__(self, in_features: int = 512, out_features: int = 21):
        super().__init__(BatchNorm1d(in_features), nn.Linear(in_features, 256),
                         BatchNorm1d(256), nn.Linear(256, out_features))


class VisualFormer(nn.Module):
    """vformer (reference vformer.py:358-405): the clip -> (B, 21)."""

    modes = ("clip",)
    loss_key = "vformer"

    def __init__(self, modality: str = "V", task: str = "AU",
                 n_frames: int = 16):
        super().__init__()
        self.modality = modality
        self.task = task
        self.num_channels = modality_channels(modality)
        self.video_model = VideoModel(self.num_channels, n_frames)
        self.fc = MLPHead()

    def forward(self, x: dict) -> torch.Tensor:
        return self.fc(self.video_model(x["clip"]))
