"""Exact shared-spectrogram mel for the dense sweep (counterpart of
auformer/ops/phase_mel.py).

Consecutive sweep windows share all but 1470 of their 441000 samples, and
the reference's window grid makes that redundancy removable exactly:

* A window at timestamp ts starts at ``offset = max(int(ts_s * 44100) -
  220500, 0)`` (aff2compdataset.py:218-226). With 30 fps timestamps the
  offsets step by 1470 = 3*441 + 147 samples, so ``offset mod 441`` (441 =
  the STFT hop) takes a handful of values per video: every window's STFT
  grid is one of a few *phase-shifted global grids*.
* torch.stft's hann window (882 wide, zero-padded to n_fft 1024, left pad
  71) covers exactly ``[(j-1)*441, (j+1)*441)`` around frame j's hop
  point, so only frame 0 and frame T-1 of a window read its reflect
  padding. Every interior frame is the same computation as the global
  frame of its phase at the same sample position.

So: one (T_g, n_mels) POWER mel per phase per video (``phase_mel_table``),
each window's interior frames gathered from its phase's table, its two edge
frames computed with the reference's start/end reflect (``_edge_frames``),
then the left pad, the per-window AmplitudeToDB floor and the normalization
(``phase_window_features``). Windows below 513 samples keep
``plain_frontend``'s left-aligned masked, no-end-reflect behaviour
(torchaudio itself raises there).

Every DFT here is an f32 product (torch's default keeps TF32 off for
matmuls): the JAX module takes no ``mel_bf16`` either. Per-window work is
batched indexing over all windows at once, never a loop over windows.
``phase_plan`` (numpy) returns ``None`` when a video's timestamps need more
than ``max_phases`` grids; callers then take the per-window route
(sweep.py::AvformerSweep.fused_sweep_device_audio).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .audio import (HOP_LENGTH, N_FFT, N_MELS, WIN_LENGTH, _dft_basis,
                    amplitude_to_db, mel_filterbank, normalize_spec)

# ideal 30 fps timestamps produce {0,146,147,293,294,440} (int truncation
# wobbles the 3-phase cycle by -1); 8 covers that with margin
MAX_PHASES = 8
SLEN = 441000                              # samples in a 10 s window
_LEFT = (N_FFT - WIN_LENGTH) // 2          # 71: window support offset
_EDGE_EXT = 3 * HOP_LENGTH + 1             # end-edge mini buffer: 1324
_N_FREQS = N_FFT // 2 + 1


@functools.lru_cache(maxsize=2)
def _basis_trim() -> np.ndarray:
    """Windowed DFT basis trimmed to the 882-sample window support."""
    return _dft_basis(N_FFT, WIN_LENGTH)[_LEFT:_LEFT + WIN_LENGTH]


@functools.lru_cache(maxsize=2)
def _basis_split() -> np.ndarray:
    """(441, 2*1026) block-row basis [B_lo | B_hi]: frame j's spectrum is
    rows[j] @ B_lo + rows[j+1] @ B_hi where rows[k] covers samples
    [(k-1)*441, k*441) of the phase-shifted grid."""
    b = _basis_trim()
    return np.concatenate([b[:HOP_LENGTH], b[HOP_LENGTH:]], axis=1)


def _const(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(table).to(like.device)


def _mel_power(spec: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """(..., 2F) [re | im] spectrum -> (..., n_mels) mel power."""
    power = spec[..., :_N_FREQS] ** 2 + spec[..., _N_FREQS:] ** 2
    return torch.matmul(power, fb)


def phase_mel_table_span(wav_buf: torch.Tensor, phases, pre: int, t_g: int,
                         n_mels: int = N_MELS) -> torch.Tensor:
    """(P, t_g, n_mels) POWER mel of the P phase-shifted global grids over
    a buffer laid out [zeros(pre) | content | zeros(tail)].

    Global frame g of phase p covers buffer samples [pre + p + (g-1)*441,
    pre + p + (g+1)*441). With pre >= 441 and tail >= 1764 no slice leaves
    the buffer; a start that would is clamped, as ``jax.lax.dynamic_slice``
    clamps it. Row 0 of each table reads into the prefix and is never
    indexed by a window (interior indices are >= base + 1 >= 1). Each
    phase's hop rows are a view of the buffer: one (t_g + 1, 441) x
    (441, 2052) product gives both halves of every frame.
    """
    basis = _const(_basis_split(), wav_buf)
    fb = _const(mel_filterbank(_N_FREQS, 0.0, None, n_mels), wav_buf)
    size = (t_g + 1) * HOP_LENGTH
    out = []
    for p in np.asarray(phases, np.int64).tolist():
        start = min(max(pre + p - HOP_LENGTH, 0), wav_buf.shape[-1] - size)
        rows = wav_buf[start:start + size].view(t_g + 1, HOP_LENGTH)
        r = torch.matmul(rows, basis)
        spec = r[:t_g, :2 * _N_FREQS] + r[1:, 2 * _N_FREQS:]   # (t_g, 2F)
        out.append(_mel_power(spec, fb))
    return torch.stack(out)


def phase_mel_table(wav_ext: torch.Tensor, phases,
                    n_mels: int = N_MELS) -> torch.Tensor:
    """(P, T_g, n_mels) POWER mel for the per-video sweep layout
    wav_ext = [zeros(441000) | wav | zeros(441000 + 512)]."""
    t_g = (wav_ext.shape[-1] - 2 * SLEN - 512) // HOP_LENGTH + 2
    return phase_mel_table_span(wav_ext, phases, pre=SLEN, t_g=t_g,
                                n_mels=n_mels)


def _window_slices(buf: torch.Tensor, starts: torch.Tensor,
                   size: int) -> torch.Tensor:
    """(N, size) rows ``buf[s : s + size]``, each start clamped into the
    buffer as ``jax.lax.dynamic_slice`` clamps it."""
    s = starts.clamp(0, buf.shape[-1] - size)
    return buf[s[:, None] + torch.arange(size, device=buf.device)]


def _edge_frames(wav_ext: torch.Tensor, starts: torch.Tensor,
                 n_valid: torch.Tensor,
                 n_mels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-window first/last STFT frames with the reference's window-local
    reflect padding -> two (N, n_mels) POWER mel rows.

    Start frame (j=0) covers window samples [-441, 441): the start reflect
    (p[-k] = s[k]) mirrors the first samples. End frame (j = T_w - 1)
    covers [(T_w-2)*441, T_w*441): positions past n_valid take the end
    reflect p[nv + k] = s[nv - 2 - k] when nv >= 513, and stay zero below
    (``plain_frontend``'s left-aligned semantics). Both frames use the
    trimmed basis of the bulk path.
    """
    hop, ext = HOP_LENGTH, _EDGE_EXT
    dev = wav_ext.device
    s = starts.to(torch.int64)
    nv = n_valid.to(torch.int64)[:, None]
    # start frame: the first 883 window samples, masked to nv
    buf = _window_slices(wav_ext, s, 2 * hop + 1)
    buf = torch.where(torch.arange(2 * hop + 1, device=dev) < nv, buf, 0.0)
    v0 = torch.cat([buf[:, 1:hop + 1].flip(1), buf[:, :hop]], dim=1)
    # end frame: a mini buffer one hop before the frame's support, so that
    # no reflect source precedes it; local valid count nvl
    tw1 = nv // hop                                  # = T_w - 1 (nv > 0)
    o_end = s[:, None] + (tw1 - 2) * hop
    w = _window_slices(wav_ext, o_end[:, 0].clamp(min=0), ext)
    nvl = nv - (tw1 - 2) * hop
    ar = torch.arange(ext, device=dev)
    wm = torch.where(ar < nvl, w, 0.0)
    # JAX reads the end reflect as one clamped slice of
    # [zeros(ext) | reverse(wm) | zeros(ext)] at 2*ext + 1 - 2*nvl; element
    # q of that buffer is wm[2*ext - 1 - q] inside the middle third, else 0
    q = (2 * ext + 1 - 2 * nvl).clamp(0, 2 * ext) + ar
    src = 2 * ext - 1 - q
    refl_rev = torch.where((src >= 0) & (src < ext),
                           wm.gather(1, src.clamp(0, ext - 1)), 0.0)
    refl = torch.where(ar < nvl, wm, refl_rev)
    v1 = torch.where((ar < nvl) | (nv >= 513), refl, 0.0)[:, hop:3 * hop]

    basis = _const(_basis_trim(), wav_ext)
    fb = _const(mel_filterbank(_N_FREQS, 0.0, None, n_mels), wav_ext)
    return (_mel_power(torch.matmul(v0, basis), fb),
            _mel_power(torch.matmul(v1, basis), fb))


def phase_window_features(wav_ext: torch.Tensor, phase_mels: torch.Tensor,
                          starts: torch.Tensor, n_valid: torch.Tensor,
                          base: torch.Tensor, phase_sel: torch.Tensor,
                          out_frames: int = 1001,
                          time_major: bool = False) -> torch.Tensor:
    """Assemble (N, 1, n_mels, out_frames) normalized log-mel features.

    Interior frames gather from ``phase_mels`` (P, T_g, M); edge frames
    compute per window; features are left-padded to ``out_frames``, then
    take the per-window dB floor and the affine normalization.

    ``time_major=True`` returns (N, out_frames, n_mels, 1) instead, the
    layout the row gather produces (``nn/avformer.py::AudioModel`` takes
    it). The dB floor reduces over the same elements in either orientation.
    """
    n_mels = phase_mels.shape[-1]
    t_g = phase_mels.shape[1]
    nv = n_valid.to(torch.int64)[:, None]
    tw = 1 + nv // HOP_LENGTH                          # (N, 1)
    k = torch.arange(out_frames, device=phase_mels.device)[None, :]
    j = k - (out_frames - tw)                          # window frame index
    flat = phase_mels.reshape(-1, n_mels)              # (P*T_g, M)
    gidx = (phase_sel.to(torch.int64)[:, None] * t_g
            + base.to(torch.int64)[:, None] + j)
    out = flat[gidx.clamp(0, flat.shape[0] - 1)]       # (N, T, M)

    e0, e1 = _edge_frames(wav_ext, starts, n_valid, n_mels)
    out = torch.where((j == 0)[..., None], e0[:, None, :], out)
    islast = (j == tw - 1) & (tw > 1)
    out = torch.where(islast[..., None], e1[:, None, :], out)
    valid = (j >= 0) & (j < tw) & (nv > 0)
    out = torch.where(valid[..., None], out, 0.0)
    if time_major:
        return normalize_spec(amplitude_to_db(out))[..., None]
    return normalize_spec(amplitude_to_db(out.transpose(1, 2)))[:, None]


def phase_plan(offsets: np.ndarray, n_valid: np.ndarray,
               max_phases: int = MAX_PHASES
               ) -> "tuple[np.ndarray, np.ndarray, np.ndarray] | None":
    """Host-side plan: (phases[max_phases], base, phase_sel) int32, or
    ``None`` when the video needs more than ``max_phases`` grids (the caller
    takes the per-window route). ``offsets`` are the clamped window offsets
    in unpadded sample coordinates (sweep.py::audio_window_offsets). The
    phases after the distinct ones repeat the first; no window selects
    them."""
    offsets = np.asarray(offsets, np.int64)
    live = np.asarray(n_valid) > 0
    uniq = np.unique((offsets % HOP_LENGTH)[live])
    if uniq.size > max_phases:
        return None
    if uniq.size == 0:
        uniq = np.zeros(1, np.int64)
    phases = np.concatenate(
        [uniq, np.full(max_phases - uniq.size, uniq[0])]).astype(np.int32)
    phase_sel = np.searchsorted(uniq, offsets % HOP_LENGTH).astype(np.int32)
    phase_sel = np.where(live, phase_sel, 0).astype(np.int32)
    base = (offsets // HOP_LENGTH).astype(np.int32)
    return phases, base, phase_sel
