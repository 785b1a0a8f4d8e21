"""Fused log-mel frontend for the fixed 10 s buffer (counterpart of
auformer/ops/audio_pallas.py).

``mel_frontend`` launches the CUDA kernel ``csrc/mel.cu`` for a CUDA
tensor: (B, 441000) f32 raw audio -> (B, 1, 64, 1001) normalized log-mel in
one launch (framing with reflect padding, windowed DFT on bf16 tensor
cores, power, mel projection, feature_len masking, dB, the per-sample 80 dB
floor and the normalization). ``mel_frontend_reference`` is its plain
PyTorch version: the chain of ``ops/audio.py`` with bf16 DFT operands and
f32 accumulation, the Pallas kernel's numerics class.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .audio import (HOP_LENGTH, N_FFT, N_MELS, OUT_FRAMES, WIN_LENGTH,
                    _dft_basis, mel_filterbank, plain_frontend)
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
def mel_library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built csrc/mel.cu (with ``defines``) and its C signatures."""
    lib = library("mel", defines)
    lib.mel_frontend_forward.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.mel_frontend_forward.restype = ctypes.c_int
    for name in ("mel_basis_columns", "mel_hop_stride"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def kernel_tables(columns: int = 1024, hop_stride: int = 456
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's constant operands, in f32: the windowed DFT basis
    trimmed to the window support as (columns, 2 * hop_stride), column 2f
    the real and 2f+1 the imaginary part of bin f; the mel filterbank of
    those bins as (64, columns / 2); and each band's range [first, end) of
    bins with a nonzero weight.

    The kernel keeps a frame as two hop rows of 441 samples, each padded
    to ``hop_stride``: basis row r is window sample r (r < 441) or
    r - (hop_stride - 441) (hop_stride <= r < hop_stride + 441), and zero
    at the pads.

    The bins above columns / 2 (bin 512, Nyquist) are left out; the kernel
    may drop them only because their mel weights are negligible, which is
    checked here.
    """
    bins = columns // 2
    fb = mel_filterbank()
    if np.abs(fb[bins:]).max() > 1e-12 * np.abs(fb).max():
        raise ValueError(f"mel bins from {bins} up carry weight; the kernel "
                         f"cannot leave them out")
    basis = _dft_basis(N_FFT, WIN_LENGTH)[_LEFT:_LEFT + WIN_LENGTH]
    rows = np.concatenate([np.arange(HOP_LENGTH),
                           hop_stride + np.arange(WIN_LENGTH - HOP_LENGTH)])
    pairs = np.zeros((columns, 2 * hop_stride), np.float32)
    pairs[0::2, rows] = basis[:, :bins].T
    pairs[1::2, rows] = basis[:, _F:_F + bins].T
    melfb = np.ascontiguousarray(fb[:bins].T)                  # (64, bins)
    ranges = np.zeros((N_MELS, 2), np.int32)
    for m in range(N_MELS):
        nz = np.flatnonzero(melfb[m])
        if nz.size:
            ranges[m] = nz[0], nz[-1] + 1
    return pairs, melfb, ranges


@functools.cache
def _device_tables(device: torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lib = mel_library()
    pairs, melfb, ranges = kernel_tables(lib.mel_basis_columns(),
                                         lib.mel_hop_stride())
    return (torch.from_numpy(pairs).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(melfb).to(device),
            torch.from_numpy(ranges).to(device))


_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, b: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (device, stream): each sample's dB max key (INT_MIN) and arrival
    count (0). The kernel's last block of a sample resets both, so the
    next call on the stream finds them so; calls on one stream run in
    order."""
    key = (device.index, stream)
    held = _SCRATCH.get(key)
    if held is None or held[0].numel() < b:
        held = (torch.full((b,), -2 ** 31, dtype=torch.int32, device=device),
                torch.zeros((b,), dtype=torch.int32, device=device))
        _SCRATCH[key] = held
    return held


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
    lib = mel_library()
    basis, melfb, ranges = _device_tables(audio.device)
    out = torch.empty((b, N_MELS, OUT_FRAMES), dtype=torch.float32,
                      device=audio.device)
    if b == 0:
        return out[:, None]
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    max_key, count = _scratch(audio.device, stream, b)
    with torch.cuda.device(audio.device):
        err = lib.mel_frontend_forward(
            audio.data_ptr(), basis.data_ptr(), melfb.data_ptr(),
            ranges.data_ptr(), flen.data_ptr(), out.data_ptr(),
            max_key.data_ptr(), count.data_ptr(), b, stream)
    check(err, "mel kernel")
    mel_frontend.launches += 1
    return out[:, None]


mel_frontend.launches = 0
