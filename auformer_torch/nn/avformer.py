"""The two-stream aural-visual former (counterpart of auformer/nn/avformer.py;
reference models/avformer.py).

  audio (B,1,64,1001) -> 1-ch resnet18 -> (B,512) -> AU_former -> (B,12,128)
  clip  (B,T,H,W,C)   -> VideoModel (S+T former) -> (B,512) -> AU_former
                                                   -> (B,12,128)
  concat on the feature dim, audio tokens first -> (B,12,256)
  -> FormerAUHead -> 12 AU logits; out (B,21): AU slice filled, EX/VA zero.
"""
from __future__ import annotations

import torch
from torch import nn

from .heads import AUFormerHead, FormerAUHead
from .resnet import ResNet18
from .vformer import VideoModel


class AudioModel(nn.Module):
    """1-channel resnet18 over the log-mel image -> (B, 512) features
    (reference audio.py:22-39; its 22-way fc is replaced by Dummy in every
    user, so it is omitted). The (B, 1, n_mels, T) input is already NCHW.

    ``time_major=True`` takes the dense sweep's phase-mel layout
    (B, T, n_mels, 1) and permutes it into (B, 1, n_mels, T): one copy of
    the features. The JAX package instead runs HW-swapped conv kernels on
    the transposed image (sweep.py::swap_conv_hw), a TPU layout trick."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet18(in_channels=1)

    def forward(self, audio_features: torch.Tensor,
                time_major: bool = False) -> torch.Tensor:
        if time_major:
            audio_features = audio_features.permute(0, 3, 2, 1).contiguous()
        return self.resnet(audio_features)


class AudioFormer(nn.Module):
    """Audio stream: AudioModel + AU_former -> (B, 12, 128) AU tokens
    (reference avformer.py:37-55)."""

    def __init__(self, dropout: float = 0.2):
        super().__init__()
        self.audio_model = AudioModel()
        self.au_head = AUFormerHead(dropout=dropout)

    def forward(self, audio_features: torch.Tensor) -> torch.Tensor:
        return self.au_head(self.audio_model(audio_features))[1]


class AVVisualFormer(nn.Module):
    """Visual stream: VideoModel + AU_former -> (B, 12, 128) AU tokens
    (reference avformer.py:57-71)."""

    def __init__(self, num_channels: int = 3, n_frames: int = 16):
        super().__init__()
        self.video_model = VideoModel(num_channels, n_frames, dropout=0.0)
        self.au_head = AUFormerHead(input_dim=512)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        return self.au_head(self.video_model(clip))[1]


class TwoStreamAuralVisualFormer(nn.Module):
    """avformer (reference avformer.py:73-106): late fusion of A/V AU tokens
    through the reconstructed FormerAUHead. Takes the batch dict
    ``{"clip": (B,T,H,W,C) normalized, "audio_features": (B,1,64,T)}``."""

    modes = ("clip", "audio_features")

    def __init__(self, modality: str = "A;V", task: str = "AU",
                 n_frames: int = 16, dropout: float = 0.2):
        super().__init__()
        self.modality = modality
        self.task = task
        self.audio_model = AudioFormer(dropout)
        self.video_model = AVVisualFormer(self.num_channels, n_frames)
        if task == "AU":
            self.au_head = FormerAUHead(emb_dim=256, dropout=dropout)

    @property
    def num_channels(self) -> int:
        if "M" in self.modality:
            return 4 if "V" in self.modality else 1
        return 3

    def forward(self, x: dict) -> torch.Tensor:
        audio_tokens = self.audio_model(x["audio_features"])
        video_tokens = self.video_model(x["clip"])
        fused = torch.cat([audio_tokens, video_tokens], dim=2)
        out = torch.zeros((fused.shape[0], 21), dtype=torch.float32,
                          device=fused.device)
        if self.task == "AU":
            out[:, :12] = self.au_head(fused).float()
        return out
