"""Fused log-mel frontend for the fixed 10 s buffer (counterpart of
auformer/ops/audio_pallas.py).

``mel_frontend`` launches the CUDA kernel ``csrc/mel.cu`` for a CUDA
tensor: (B, 441000) f32 raw audio -> (B, 1, 64, 1001) normalized log-mel in
one pass over the audio (framing with reflect padding, windowed DFT, power,
mel projection, feature_len masking, dB) plus one in-place pass for the
per-sample 80 dB floor and the normalization. ``mel_frontend_reference`` is
its plain PyTorch version: the chain of ``ops/audio.py`` with bf16 DFT
operands and f32 accumulation, the Pallas kernel's numerics class.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .audio import (N_FFT, N_MELS, OUT_FRAMES, WIN_LENGTH, _dft_basis,
                    mel_filterbank, plain_frontend)
from .build import check, library

MEL_LEN = 441000                 # fixed 10 s @ 44.1 kHz serving buffer
_F = N_FFT // 2 + 1              # 513 freq bins
_LEFT = (N_FFT - WIN_LENGTH) // 2  # 71: window support offset in the frame


def _check_input(audio: torch.Tensor) -> None:
    if audio.dim() != 2 or audio.shape[-1] != MEL_LEN:
        raise ValueError(f"mel frontend needs (B, {MEL_LEN}) audio, got "
                         f"{tuple(audio.shape)}")


def mel_frontend_reference(audio: torch.Tensor,
                           feature_len: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain version of the kernel: (B, 441000) -> (B, 1, 64, 1001)."""
    _check_input(audio)
    return plain_frontend(audio, feature_len, mel_bf16=True)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("mel")
    lib.mel_frontend_forward.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.mel_frontend_forward.restype = ctypes.c_int
    lib.mel_padded_bins.restype = ctypes.c_int
    return lib


def _kernel_tables(padded_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's constant operands, in f32: the windowed DFT basis
    trimmed to the window support as (882, padded_bins, [re, im]) and the
    mel filterbank as (padded_bins, 64); bins 513 and up are zero."""
    basis = _dft_basis(N_FFT, WIN_LENGTH)[_LEFT:_LEFT + WIN_LENGTH]
    pairs = np.zeros((WIN_LENGTH, padded_bins, 2), np.float32)
    pairs[:, :_F, 0] = basis[:, :_F]
    pairs[:, :_F, 1] = basis[:, _F:]
    melfb = np.zeros((padded_bins, N_MELS), np.float32)
    melfb[:_F] = mel_filterbank()
    return pairs, melfb


@functools.cache
def _device_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    pairs, melfb = _kernel_tables(_library().mel_padded_bins())
    return (torch.from_numpy(pairs).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(melfb).to(device))


def mel_frontend(audio: torch.Tensor,
                 feature_len: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 441000) f32 -> (B, 1, 64, 1001) normalized log-mel.

    A CPU tensor takes ``mel_frontend_reference``. A CUDA tensor takes the
    kernel or raises: it must be contiguous float32. ``feature_len`` (B,)
    counts the valid right-aligned frames per sample (default: all 1001).
    ``mel_frontend.launches`` counts kernel launches.
    """
    _check_input(audio)
    if audio.device.type == "cpu":
        return mel_frontend_reference(audio, feature_len)
    if audio.device.type != "cuda":
        raise ValueError(f"mel_frontend: unsupported device {audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"mel_frontend: float32 audio expected, got "
                        f"{audio.dtype}")
    if not audio.is_contiguous():
        raise ValueError("mel_frontend: audio must be contiguous")
    b = audio.shape[0]
    if feature_len is None:
        flen = torch.full((b,), OUT_FRAMES, dtype=torch.int32,
                          device=audio.device)
    else:
        flen = feature_len.to(device=audio.device,
                              dtype=torch.int32).reshape(b).contiguous()
    lib = _library()
    basis, melfb = _device_tables(audio.device)
    out = torch.empty((b, N_MELS, OUT_FRAMES), dtype=torch.float32,
                      device=audio.device)
    if b == 0:
        return out[:, None]
    max_key = torch.empty((b,), dtype=torch.int32, device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    with torch.cuda.device(audio.device):
        err = lib.mel_frontend_forward(
            audio.data_ptr(), basis.data_ptr(), melfb.data_ptr(),
            flen.data_ptr(), out.data_ptr(), max_key.data_ptr(), b, stream)
    check(err, "mel kernel")
    mel_frontend.launches += 1
    return out[:, None]


mel_frontend.launches = 0
