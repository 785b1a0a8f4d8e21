"""Audio window math on the host (counterpart of the window functions of
auformer/ops/audio_host.py).

The reference loads, for the frame at a timestamp, the audio window that
ends 5 s after it: ``torchaudio.load(offset, num_frames)`` with the offset
and length below (aff2compdataset.py:218-226). The dense sweep plans every
window of a video from these on the host, in numpy.
"""
from __future__ import annotations

import numpy as np

from .audio import SAMPLE_RATE


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
