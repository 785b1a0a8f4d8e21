"""The device-resident wav arena for the device mel frontend (counterpart
of auformer/data/wav_arena.py).

With ``cfg.device_audio`` and no arena, every loader sample ships its raw
(1, 441000) float32 window: 1.76 MB per clip through the host-device link
and a wav file read on the host (``Aff2CompDataset.get_audio_window``).
Overlapping windows of the same video repeat nearly all of those bytes.

The arena removes the repetition at the source: each video's waveform is
uploaded once per run into one packed 1-D float32 tensor on the card, and
a sample carries two int32 scalars: the window's global offset into the
arena and its valid sample count. The train and eval steps gather the
windows and zero their tails (``parallel/step.py::gather_arena_windows``),
which rebuilds the host's left-aligned window buffers bitwise.

Capacity-gated: when the dataset's audio exceeds ``cap_mb``,
``build_wav_arena`` returns None and the caller keeps shipping windows (a
full Aff-Wild2 train set holds ~10 GB of f32 audio, over the default
4096 MB cap).

Offsets are int32, as in the JAX package: an arena of 2**31 samples or more
(a cap above 8192 MB) overflows them, and ``np.int32`` raises.
"""
from __future__ import annotations

import logging
import os
import wave
from dataclasses import dataclass, field

import numpy as np

from ..ops import audio_host


@dataclass
class WavArena:
    """Packed per-video waveforms and their table.

    ``table`` maps video_id -> (base, n_samples); ``zero_ofs`` points at
    ``sample_len`` zeros at the end of the arena: the window of a missing
    wav or an empty read, where the host path substitutes a zero buffer."""
    arena: np.ndarray                      # (L,) float32, packed
    table: dict = field(default_factory=dict)
    zero_ofs: int = 0
    sample_len: int = 441000

    @property
    def nbytes(self) -> int:
        return self.arena.nbytes

    def window(self, video_id: str, timestamp_ms: float,
               sample_rate: int, audio_shift_samples: int
               ) -> tuple[int, int]:
        """(global_ofs, n_valid) of the clip window ending at a frame
        timestamp: the arena's counterpart of
        ``Aff2CompDataset.get_audio_window``. The zero region stands in
        exactly where the host path substitutes a zero buffer (a missing
        wav, an empty read). Every offset lies in ``[0, len(arena) -
        sample_len]``, so a gather needs no clamp."""
        entry = self.table.get(video_id)
        if entry is None:
            return self.zero_ofs, self.sample_len
        base, wav_n = entry
        offset, n = audio_host.audio_window_params(
            timestamp_ms, sample_rate, self.sample_len, audio_shift_samples)
        n_valid = min(n, wav_n - min(offset, wav_n))
        if n_valid <= 0:
            # load_wav returns an empty read: the host substitutes a full
            # zero window with n_valid = sample_len
            return self.zero_ofs, self.sample_len
        ofs = base + offset
        if not 0 <= ofs <= self.arena.shape[0] - self.sample_len:
            raise ValueError(f"arena offset {ofs} of {video_id!r} outside "
                             f"[0, {self.arena.shape[0] - self.sample_len}]")
        return ofs, int(n_valid)


def build_wav_arena(dataset, cap_mb: float = 4096.0,
                    sample_len: int | None = None) -> WavArena | None:
    """Pack every dataset video's waveform (channel 0) into one float32
    array. Returns None, and the caller keeps shipping windows, when the
    total exceeds ``cap_mb`` or no video has a readable wav.

    Layout: [video wavs, back to back | zeros(sample_len)]. No padding
    between videos: the gather zeroes the samples past each window's
    valid count, so a slice that runs into the next video contributes none
    of its samples.
    """
    sample_len = sample_len or dataset.sample_len_frames
    videos = list(dict.fromkeys(os.path.dirname(p)
                                for p in dataset.image_path))
    cap = int(cap_mb * (1 << 20) // 4)
    lengths: dict[str, int] = {}
    for vid in videos:
        try:
            with wave.open(os.path.join(dataset.video_dir, vid + ".wav"),
                           "rb") as w:
                lengths[vid] = w.getnframes()
        except (OSError, EOFError, ValueError):
            continue
    if not lengths:
        return None
    total = sum(lengths.values())
    if total + sample_len > cap:
        logging.info(
            f"wav arena: {total * 4 / 1e6:.0f} MB of audio exceeds the "
            f"{cap_mb:.0f} MB cap — shipping per-clip windows instead")
        return None

    arena = np.zeros(total + sample_len, np.float32)
    table: dict[str, tuple[int, int]] = {}
    base = 0
    for vid in lengths:
        try:
            wav, _sr = audio_host.load_wav(
                os.path.join(dataset.video_dir, vid + ".wav"))
        except (OSError, EOFError, ValueError):
            continue
        w0 = wav[0] if wav.shape[0] else np.zeros(0, np.float32)
        n = w0.shape[0]
        arena[base:base + n] = w0
        table[vid] = (base, n)
        base += n
    logging.info(f"wav arena: {len(table)} videos, "
                 f"{arena.nbytes / 1e6:.0f} MB resident")
    return WavArena(arena=arena[:base + sample_len], table=table,
                    zero_ofs=base, sample_len=sample_len)
