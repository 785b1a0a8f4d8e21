"""Host-side (numpy) exact mel pipeline, WAV reading and the audio window
math (counterpart of auformer/ops/audio_host.py).

The strict-parity path: it mirrors the reference per-sample flow
(aff2compdataset.py:214-247) in float32 numpy, including variable-length
windows, feature left-padding *before* AmplitudeToDB, and the
torchaudio.load(offset, num_frames) sample-window math. The dataset's
``get_audio_feature`` computes it per label frame; the dense sweep plans
every window of a video from the window functions at the end.

Also a dependency-free PCM WAV reader in place of torchaudio's sox backend
(the reference asserts 44.1 kHz PCM wavs, data_split.py:33-34).
"""
from __future__ import annotations

import wave

import numpy as np

from .audio import (AMIN, HOP_LENGTH, N_FFT, N_MELS, SAMPLE_RATE, SPEC_MEAN,
                    SPEC_STD, TOP_DB, WIN_LENGTH, mel_filterbank, num_frames,
                    padded_window)


def load_wav(path: str, offset: int = 0, num_samples: int | None = None
             ) -> tuple[np.ndarray, int]:
    """Read PCM WAV -> (channels, n) float32 in [-1, 1], like torchaudio.load.

    ``offset``/``num_samples`` are in sample frames (torchaudio 0.6
    ``offset=``/``num_frames=`` semantics).
    """
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        total = w.getnframes()
        if offset:
            w.setpos(min(offset, total))
        n = total - min(offset, total)
        if num_samples is not None:
            n = min(n, num_samples)
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    return data.reshape(-1, n_ch).T.copy(), sr


def write_wav(path: str, data: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """(channels, n) float32 [-1,1] -> 16-bit PCM WAV (fixture generation)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None]
    pcm = np.clip(data.T * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(data.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def stft_power(audio: np.ndarray,
               n_fft: int = N_FFT,
               hop_length: int = HOP_LENGTH,
               win_length: int = WIN_LENGTH) -> np.ndarray:
    """(C, L) -> (C, F, T) power spectrogram, torch.stft semantics."""
    window = padded_window(win_length, n_fft)
    pad = n_fft // 2
    x = np.pad(audio, [(0, 0), (pad, pad)], mode="reflect")
    t = num_frames(audio.shape[-1], hop_length)
    idx = np.arange(t)[:, None] * hop_length + np.arange(n_fft)[None, :]
    frames = x[:, idx] * window                          # (C, T, n_fft)
    spec = np.fft.rfft(frames.astype(np.float64), axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    return np.transpose(power, (0, 2, 1))                # (C, F, T)


def mel_spectrogram_host(audio: np.ndarray, n_mels: int = N_MELS,
                         sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """(C, L) -> (C, n_mels, T)."""
    power = stft_power(audio)                            # (C, F, T)
    fb = mel_filterbank(N_FFT // 2 + 1, 0.0, None, n_mels, sample_rate)
    return np.einsum("cft,fm->cmt", power, fb).astype(np.float32)


def amplitude_to_db_host(x: np.ndarray, top_db: float = TOP_DB,
                         amin: float = AMIN) -> np.ndarray:
    db = 10.0 * np.log10(np.maximum(x, amin))
    return np.maximum(db, db.max() - top_db).astype(np.float32)


def reference_audio_features(audio: np.ndarray,
                             sample_len_secs: int = 10,
                             window_stride: float = 10e-3,
                             sample_len_frames: int = 441000,
                             n_mels: int = N_MELS
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Exact reference flow for one loaded window (aff2compdataset.py:227-247).

    audio: (1, L) float32, L <= sample_len_frames.
    Returns (features (1, n_mels, 1001) float32, padded_audio (1, 441000)).
    """
    feats = mel_spectrogram_host(audio, n_mels=n_mels)
    out_frames = int(sample_len_secs / window_stride) + 1
    if audio.shape[1] < sample_len_frames:
        padded = np.zeros((feats.shape[0], feats.shape[1], out_frames), np.float32)
        padded[:, :, -feats.shape[2]:] = feats
        feats = padded
    feats = amplitude_to_db_host(feats)
    feats = ((feats - SPEC_MEAN) / SPEC_STD).astype(np.float32)
    if audio.shape[1] < sample_len_frames:
        pa = np.zeros((1, sample_len_frames), np.float32)
        pa[:, -audio.shape[1]:] = audio
        audio = pa
    return feats, audio.astype(np.float32)


def audio_window_params(timestamp_ms: float,
                        sample_rate: int = SAMPLE_RATE,
                        sample_len_frames: int = 441000,
                        audio_shift_samples: int = 5 * SAMPLE_RATE,
                        window_size: float = 20e-3) -> tuple[int, int]:
    """(offset, num_samples) of the audio window ending at a frame timestamp
    (aff2compdataset.py:218-226)."""
    ts_samples = int((timestamp_ms / 1000.0) * sample_rate)
    n = min(sample_len_frames, max(ts_samples, int(window_size * sample_rate)))
    offset = max(ts_samples - sample_len_frames + audio_shift_samples, 0)
    return offset, n


def audio_window_params_batch(timestamps_ms,
                              sample_rate: int = SAMPLE_RATE,
                              sample_len_frames: int = 441000,
                              audio_shift_samples: int = 5 * SAMPLE_RATE,
                              window_size: float = 20e-3
                              ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`audio_window_params` over an (N,) timestamp array ->
    (offsets, num_samples) int64 arrays, element-wise identical (the same
    float64 arithmetic and truncation)."""
    ts = np.asarray(timestamps_ms, np.float64)
    ts_samples = ((ts / 1000.0) * sample_rate).astype(np.int64)
    n = np.minimum(sample_len_frames,
                   np.maximum(ts_samples, int(window_size * sample_rate)))
    offset = np.maximum(
        ts_samples - sample_len_frames + audio_shift_samples, 0)
    return offset, n
