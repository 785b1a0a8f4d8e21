"""Log-mel spectrogram audio frontend (counterpart of auformer/ops/audio.py).

Reproduces the reference audio feature pipeline — torchaudio 0.6
``MelSpectrogram(44100, n_mels=64, n_fft=1024, win_length=882, hop_length=441,
hann)`` + ``AmplitudeToDB('power', 80)`` + ``Normalize(-14.8, 19.895)``
(reference aff2compdataset.py:47-68, clip_transforms.py:96-108):

    reflect-center pad -> framing -> windowed DFT matmul -> |.|^2
    -> HTK mel filterbank matmul -> power-to-dB with per-sample
    80 dB floor -> affine normalize

A right-aligned fixed 10 s buffer (L = 441000) goes to
``audio_kernel.mel_frontend``, the fused CUDA kernel, whose plain version for
CPU tensors is this module's chain with bf16 DFT operands. Other lengths,
and left-aligned windows (the dense sweep's per-window route, with
``reflect_end_patch``), run the plain chain here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 44100
N_FFT = 1024
WIN_LENGTH = 882
HOP_LENGTH = 441
N_MELS = 64
TOP_DB = 80.0
AMIN = 1e-10
SPEC_MEAN = -14.8
SPEC_STD = 19.895
OUT_FRAMES = 1001


def hann_window_periodic(win_length: int) -> np.ndarray:
    """torch.hann_window(periodic=True): 0.5*(1 - cos(2 pi n / N))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def padded_window(win_length: int = WIN_LENGTH, n_fft: int = N_FFT) -> np.ndarray:
    """Window zero-padded to n_fft, centered (torch.stft behavior)."""
    w = hann_window_periodic(win_length)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[left:left + win_length] = w
    return out


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int = N_FFT // 2 + 1,
                   f_min: float = 0.0,
                   f_max: float | None = None,
                   n_mels: int = N_MELS,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """HTK triangular filterbank, shape (n_freqs, n_mels), norm=None
    (torchaudio 0.6 ``create_fb_matrix``)."""
    if f_max is None:
        f_max = float(sample_rate // 2)
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_min = _hz_to_mel_htk(f_min)
    m_max = _hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                            # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]               # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def num_frames(n_samples: int, hop_length: int = HOP_LENGTH) -> int:
    """Frame count of a center-padded STFT: 1 + n // hop."""
    return 1 + n_samples // hop_length


@functools.lru_cache(maxsize=4)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed DFT basis, shape (n_fft, 2*(n_fft//2+1)), columns
    [cos_0..cos_F | -sin_0..-sin_F]."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = padded_window(win_length, n_fft).astype(np.float64)[:, None]
    cos = np.cos(ang) * w
    sin = -np.sin(ang) * w
    return np.concatenate([cos, sin], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _frontend_tables(device: torch.device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(the windowed DFT basis trimmed to the window support (WIN_LENGTH,
    2F), the mel filterbank (F, N_MELS)), f32 on ``device``, made once per
    device: a step makes no host-to-device copy, so it can be captured in
    a CUDA graph. Read-only."""
    left = (N_FFT - WIN_LENGTH) // 2
    basis = _dft_basis(N_FFT, WIN_LENGTH)[left:left + WIN_LENGTH]
    return (torch.from_numpy(basis).to(device),
            torch.from_numpy(mel_filterbank()).to(device))


def power_spectrogram(audio: torch.Tensor,
                      conv_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., L) float32 -> (..., T, N_FFT//2+1) power spectrogram.

    The JAX package's ``method='matmul'``: frames cut from the reflect-padded
    signal, then ONE dense (B*T, win) x (win, 2F) product with the windowed
    DFT basis trimmed to the window support (882 of 1024 rows are nonzero).
    ``conv_dtype=torch.bfloat16`` rounds both operands to bf16 and keeps the
    f32 product and sum, i.e. a bf16 contraction with f32 accumulation.
    Needs L > N_FFT // 2, as torch's reflect padding (and torchaudio) does.
    """
    pad = N_FFT // 2
    lead = audio.shape[:-1]
    n = audio.shape[-1]
    x = F.pad(audio.reshape(-1, 1, n).float(), (pad, pad), mode="reflect")
    t = num_frames(n)
    left = (N_FFT - WIN_LENGTH) // 2
    frames = x[:, 0, left:].unfold(-1, WIN_LENGTH, HOP_LENGTH)[:, :t]
    basis = _frontend_tables(audio.device)[0]
    if conv_dtype != torch.float32:
        frames = frames.to(conv_dtype).float()
        basis = basis.to(conv_dtype).float()
    spec = torch.matmul(frames, basis)                   # (B', T, 2F)
    n_freqs = N_FFT // 2 + 1
    power = spec[..., :n_freqs] ** 2 + spec[..., n_freqs:] ** 2
    return power.reshape(*lead, t, n_freqs)


def mel_spectrogram(audio: torch.Tensor,
                    conv_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., L) -> (..., n_mels, T) mel power spectrogram (torchaudio layout)."""
    spec = power_spectrogram(audio, conv_dtype=conv_dtype)   # (..., T, F)
    fb = _frontend_tables(spec.device)[1]
    return torch.matmul(spec, fb).transpose(-1, -2)


def amplitude_to_db(x: torch.Tensor) -> torch.Tensor:
    """(..., n_mels, T) power -> dB with a per-sample floor at (max - 80):
    torchaudio 0.6 AmplitudeToDB('power', 80), the max taken over each
    sample's last two axes."""
    db = 10.0 * torch.log10(torch.clamp(x, min=AMIN))
    mx = torch.amax(db, dim=(-2, -1), keepdim=True)
    return torch.maximum(db, mx - TOP_DB)


def normalize_spec(x: torch.Tensor) -> torch.Tensor:
    return (x - SPEC_MEAN) / SPEC_STD


def plain_frontend(audio: torch.Tensor,
                   feature_len: torch.Tensor | None = None,
                   mel_bf16: bool = False,
                   left_aligned: bool = False) -> torch.Tensor:
    """The frontend chain in plain PyTorch: (B, L) -> (B, 1, 64, 1001).

    Right-aligned (the default): frames are right-aligned into 1001
    columns; ``feature_len`` (B,) counts the valid frames per sample, and
    the columns before them are zeroed before the dB step, as the
    reference's left-pad-then-AmpToDB does (aff2compdataset.py:234-241).

    ``left_aligned=True``: each row's valid samples start at position 0, so
    the STFT grid and the start reflect pad anchor at the true signal
    start, as the reference's mel over a short window does. The valid mel
    frames are then the FIRST ``feature_len``; a per-row ``gather`` along T
    moves them to the right edge of the 1001 columns (exact: it copies
    values) before masking and dB.
    """
    mel = mel_spectrogram(
        audio, conv_dtype=torch.bfloat16 if mel_bf16 else torch.float32)
    t = mel.shape[-1]
    if t > OUT_FRAMES:
        mel = mel[..., :OUT_FRAMES] if left_aligned else mel[..., -OUT_FRAMES:]
    elif t < OUT_FRAMES:
        pad = (0, OUT_FRAMES - t) if left_aligned else (OUT_FRAMES - t, 0)
        mel = F.pad(mel, pad)
    if feature_len is not None:
        cols = torch.arange(OUT_FRAMES, device=mel.device)
        first = OUT_FRAMES - feature_len.to(mel.device).reshape(-1, 1, 1)
        if left_aligned:
            src = (cols - first).expand(-1, mel.shape[1], -1)  # (B, M, T)
            shifted = mel.gather(2, src.clamp(0, OUT_FRAMES - 1))
            mel = torch.where(src >= 0, shifted, torch.zeros_like(mel))
        else:
            mel = torch.where(cols >= first, mel, torch.zeros_like(mel))
    return normalize_spec(amplitude_to_db(mel))[:, None]


def audio_frontend(audio: torch.Tensor,
                   feature_len: torch.Tensor | None = None,
                   mel_bf16: bool = False,
                   left_aligned: bool = False) -> torch.Tensor:
    """Full frontend: (B, L) raw audio -> (B, 1, 64, 1001) normalized log-mel.

    ``feature_len`` (B,) int: valid mel frames per sample. A right-aligned
    (B, 441000) buffer takes ``audio_kernel.mel_frontend``: the CUDA kernel
    for a CUDA tensor, its plain version for a CPU tensor. Both have bf16
    DFT operands with f32 accumulation, the Pallas kernel's numerics,
    whatever ``mel_bf16`` says. Other lengths and left-aligned windows run
    ``plain_frontend``, with bf16 DFT operands only when ``mel_bf16``, as
    the JAX package's XLA path does (its Pallas kernel, like the CUDA one,
    knows right-aligned windows only).
    """
    from .audio_kernel import MEL_LEN, mel_frontend
    if (not left_aligned and audio.dim() == 2
            and audio.shape[-1] == MEL_LEN):
        return mel_frontend(audio, feature_len)
    return plain_frontend(audio, feature_len, mel_bf16, left_aligned)


def reflect_end_patch(audio: torch.Tensor,
                      n_valid: torch.Tensor) -> torch.Tensor:
    """Patch torchaudio's center-pad END reflection into left-aligned windows.

    ``audio``: (B, L) float32, each row a window whose ``n_valid[b]`` true
    samples sit at the START of the buffer with zeros after. torchaudio's
    STFT (center=True) reflect-pads the *signal* end: position
    ``n_valid + j`` takes sample ``n_valid - 2 - j`` (no edge repeat). This
    writes those 512 samples right after the last valid one, for every row
    at once, so that ``audio_frontend(left_aligned=True)`` equals the
    reference's per-window mel for every window of at least 513 samples;
    shorter ones (< 12 ms, where torchaudio's own reflect pad raises) stay
    zero after the signal. Samples written past L are cropped, so a full
    window (``n_valid == L``) comes back unchanged.
    """
    b, length = audio.shape
    w = F.pad(audio, (0, N_FFT // 2))
    nv = n_valid.to(device=audio.device, dtype=torch.int64).reshape(b, 1)
    j = torch.arange(N_FFT // 2, device=audio.device)
    dst = nv + j
    src = (nv - 2 - j).clamp(min=0)
    vals = torch.where(nv >= N_FFT // 2 + 1, w.gather(1, src),
                       w.gather(1, dst))
    return w.scatter(1, dst, vals)[:, :length]
