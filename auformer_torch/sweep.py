"""Dense-sweep inference with frame-feature reuse (counterpart of
auformer/sweep.py's ``SweepBase`` and ``AvformerSweep``).

At submission time every frame of every video is scored
(test_aff2.py:93-117). Clip windows overlap heavily: the 16-frame dilated
window of label frame i shares 15 frames with the window of i + dilation,
so the clip-at-a-time forward runs the S-Former trunk ~16 times per frame.
The sweep restructures avformer inference without changing its math:

  1. the frame-level trunk runs ONCE per video frame -> (N, 512) features;
  2. out-of-range frames take the trunk output of a black frame (the clip
     path's zero frames, the same arithmetic). The black frame rides as
     the last row of each bucket's trunk batch, so a bucket runs the trunk
     once: 11 attention launches per bucket (1 spatial, 3 temporal, 2 + 2
     AU_former, 3 fusion), none of the mel kernel;
  3. clip windows become feature gathers feeding the temporal stack
     (T-Former -> AU_former -> fusion head) beside the per-window audio
     stream.

Audio is computed on the device from one upload of the video's wav. The
default route is the exact phase-mel table (ops/phase_mel.py); videos whose
timestamps need more than ``max_phases`` hop-grid phases take the
per-window left-aligned frontend instead (``fused_sweep_device_audio``).
Both are plain PyTorch, as they are plain XLA in the JAX package.

Buckets packed across videos (``fused_sweep_packed``, driven by
packed.py) compute their phase-mel tables from a bucket-local wav buffer.
The shared-audio variant (``sweep_video_shared_audio``: one global mel per
video, windows snapped to the hop grid) is opt-in and approximate.

Every compute method runs eagerly under ``torch.inference_mode()``; the
JAX package's jit and weight-pytree plumbing has no counterpart here. The
data-parallel mesh is not ported (ROADMAP.md, queue A7).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.config import Config
from .infer import resolve_device
from .nn.registry import compute_autocast, compute_dtype, prepare_inference
from .ops import audio_host
from .ops.audio import (HOP_LENGTH, amplitude_to_db, audio_frontend,
                        mel_spectrogram, normalize_spec, reflect_end_patch)
from .ops.phase_mel import (MAX_PHASES, phase_mel_table, phase_mel_table_span,
                            phase_plan, phase_window_features)
from .packed import PACK_PRE, PACK_TAIL
from .ops.preprocess import normalize_clip

#: windows per frontend call on the per-window route: bounds its f32
#: temporaries (window, padded copy, frames, spectrum: ~13 MB a window by
#: their shapes) whatever the bucket size
PER_WINDOW_CHUNK = 256


def default_sweep_bucket(device) -> int:
    """Label frames per bucket: 2048 on CUDA (the JAX package's accelerator
    value), 512 on the CPU."""
    return 2048 if torch.device(device).type == "cuda" else 512


def _fetch_concat(handles, out_dim: int) -> "list[np.ndarray]":
    """Wait for several dispatch handles with ONE ``torch.cat`` and ONE
    device-to-host copy, then split the rows back per handle."""
    futs = [f for _, pending in handles for _, _, f in pending]
    cat = (torch.cat(futs).cpu().numpy() if futs
           else np.zeros((0, out_dim), np.float32))
    outs = []
    o = 0
    for n, pending in handles:
        out = np.zeros((n, out_dim), np.float32)
        for ps, pcur, f in pending:
            out[ps:ps + pcur] = cat[o:o + pcur]
            o += f.shape[0]
        outs.append(out)
    return outs


class SweepBase:
    """Window and bucket machinery shared by frame-feature-cached sweeps.

    A concrete sweep supplies ``frame_features`` and a ``fused_sweep*``
    method; the base provides the reference window math
    (aff2compdataset.py:126-131), bucketed execution with cross-bucket
    history margins, and black-slot padding."""

    cfg: Config
    device: torch.device
    out_dim: int = 12          # logit columns produced per label frame
    needs_audio: bool = True   # whether sweep_video takes audio features

    def _to_device(self, *arrays):
        """numpy payloads -> tensors on the sweep's device. On CUDA they go
        through pinned memory with ``non_blocking`` copies, so the upload
        overlaps the host's next bucket."""
        placed = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            placed.append(t)
        return tuple(placed) if len(placed) > 1 else placed[0]

    def black_feature(self, image_size: int) -> np.ndarray:
        black = np.zeros((1, image_size, image_size, 3), np.uint8)
        return self.frame_features(self._to_device(black)).float().cpu(
            ).numpy()[0]

    def window_indices(self, n_frames_video: int) -> np.ndarray:
        """(N, clip_len) gather indices into [0..N] where N = black slot.

        Row i mirrors the clip window of label frame i
        (aff2compdataset.py:126-131): range(i - L + d, i - L + d(T+1), d),
        out-of-range -> the black slot.
        """
        cfg = self.cfg
        i = np.arange(n_frames_video)[:, None]
        k = np.arange(cfg.n_frames)[None, :]
        idx = i - cfg.label_frame + cfg.dilation * (k + 1)
        oob = (idx < 0) | (idx >= n_frames_video)
        return np.where(oob, n_frames_video, idx)

    #: bucket sizes quantize to this many label frames: few distinct
    #: bucket shapes, and under quantum-1 pad rows per bucket
    bucket_quantum: int = 256

    def _bucket_size(self, n: int, batch: int) -> int:
        """Uniform per-bucket size for an n-clip video: the video splits
        into ceil(n/batch) buckets whose size is ceil-divided n quantized
        up to ``bucket_quantum``, so short videos don't pay full-``batch``
        padding and long videos still cap at ``batch`` rows per bucket."""
        if n <= 0:
            return batch
        q = self.bucket_quantum
        k = -(-n // batch)                  # buckets needed at the cap
        even = -(-n // k)                   # even split across them
        per = -(-even // q) * q             # quantized up
        return min(max(per, q), batch)

    def _buckets(self, n: int, frames_u8: np.ndarray, batch: int):
        """Yield (s, cur, bsize, frames_chunk, rows) per bucket of
        ``bsize`` label frames: frames padded to bsize + label_frame with a
        history margin for cross-bucket windows; window rows remapped to
        chunk-local coordinates with the black slot at bsize + label_frame.
        Each sweep variant supplies only its per-bucket payload, padded
        with ``_pad_rows`` to ``bsize``."""
        lf = self.cfg.label_frame
        idx_full = self.window_indices(n)
        bsize = self._bucket_size(n, batch)
        for s in range(0, n, bsize):
            cur = min(bsize, n - s)
            lo = max(s - lf, 0)
            frames_chunk = frames_u8[lo:s + cur]
            rows = idx_full[s:s + cur].copy()
            black_slot = len(frames_chunk)
            rows = np.where(rows == n, -1, rows) - lo
            rows = np.where((rows < 0) | (rows >= black_slot),
                            black_slot, rows)
            fpad = bsize + lf - len(frames_chunk)
            if fpad:
                frames_chunk = np.concatenate(
                    [frames_chunk,
                     np.zeros((fpad,) + frames_chunk.shape[1:], np.uint8)])
            if cur < bsize:
                rows = np.concatenate(
                    [rows, np.full((bsize - cur, rows.shape[1]),
                                   black_slot)])
            rows = np.where(rows == black_slot, bsize + lf, rows)
            yield s, cur, bsize, frames_chunk, rows

    @staticmethod
    def _pad_rows(arr: np.ndarray, batch: int) -> np.ndarray:
        """Pad a per-bucket payload slice to ``batch`` rows by repeating
        the last row."""
        if arr.shape[0] < batch:
            reps = np.repeat(arr[-1:], batch - arr.shape[0], axis=0)
            arr = np.concatenate([arr, reps])
        return arr

    def dispatch_video(self, frames_u8: np.ndarray, wav=None,
                       timestamps_ms=None, batch: int = 512):
        """Queue one video's dense sweep on the device; returns a handle
        for :meth:`fetch_many`."""
        raise NotImplementedError

    def fetch_many(self, handles) -> "list[np.ndarray]":
        """Wait for several :meth:`dispatch_video` handles with ONE
        concatenated device-to-host copy -> [(N_i, out_dim)]."""
        return _fetch_concat(handles, self.out_dim)


class AvformerSweep(SweepBase):
    """Frame-feature-cached avformer executor (task 'AU', modality 'A;V').

    Takes the port's ``TwoStreamAuralVisualFormer`` with its weights
    loaded, moves it to ``device`` (``cuda`` unless the caller names
    another) for inference, in place (``prepare_inference``), and runs its
    submodules under ``compute_autocast`` (bf16 by ``cfg.compute_dtype``);
    the audio features are computed outside it, in f32."""

    out_dim = 12
    needs_audio = True
    #: phase-shifted hop grids the phase-mel route takes per video; a video
    #: that needs more takes the per-window route (0 forces it)
    max_phases: int = MAX_PHASES

    def __init__(self, cfg: Config, model: torch.nn.Module, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "the data-parallel sweep is not ported to auformer_torch; "
                "ROADMAP.md queue A7 (multi-process) lists it")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = compute_dtype(cfg)
        prepare_inference(cfg, model, self.device)
        video = model.video_model
        self.trunk = video.video_model.s_former
        self.tformer = video.video_model.t_former
        self.v_head = video.au_head
        self.a_net = model.audio_model.audio_model
        self.a_head = model.audio_model.au_head
        self.f_head = model.au_head

    @torch.inference_mode()
    def frame_features(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> (N, 512) S-Former trunk features."""
        x = normalize_clip(frames_u8, dtype=self.dtype)
        with compute_autocast(self.cfg, self.device):
            return self.trunk(x.permute(0, 3, 1, 2))

    @torch.inference_mode()
    def head_forward(self, gathered_feats: torch.Tensor,
                     audio_features: torch.Tensor,
                     time_major: bool = False) -> torch.Tensor:
        """(N, T, 512) gathered frame features + (N, 1, M, T) audio features
        (or (N, T, M, 1) with ``time_major``) -> (N, 12) float32 logits."""
        with compute_autocast(self.cfg, self.device):
            pooled = self.tformer(gathered_feats)
            _, v_tokens = self.v_head(pooled)
            a_feat = self.a_net(audio_features.to(self.dtype),
                                time_major=time_major)
            _, a_tokens = self.a_head(a_feat)
            fused = torch.cat([a_tokens, v_tokens], dim=2)
            return self.f_head(fused).float()

    @torch.inference_mode()
    def fused_sweep(self, frames_u8: torch.Tensor,
                    audio_features: torch.Tensor, idx: torch.Tensor,
                    time_major: bool = False) -> torch.Tensor:
        """One bucket: the trunk once per frame with the black frame
        appended as the last row (the black slot ``idx`` points at), the
        window gather, then the temporal, audio and fusion heads."""
        black = frames_u8.new_zeros((1,) + tuple(frames_u8.shape[1:]))
        feats = self.frame_features(torch.cat([frames_u8, black]))
        return self.head_forward(feats[idx], audio_features, time_major)

    @torch.inference_mode()
    def window_features(self, wav_ext: torch.Tensor, starts: torch.Tensor,
                        n_valid: torch.Tensor) -> torch.Tensor:
        """(N, 1, 64, 1001) features of the per-window route.

        Windows are LEFT-ALIGNED slices of the video's wav (valid samples
        at position 0, so the STFT grid and the start reflect anchor at the
        true signal start, as the reference's mel over a short window
        does), masked past ``n_valid``, with the end reflect written in by
        ``reflect_end_patch``: exact against the reference's per-window
        features for every window of at least 513 samples. Each chunk of
        windows is one batched index of an ``unfold`` view."""
        slen = self.cfg.sample_len_frames
        rows = wav_ext.unfold(0, slen, 1)                # (L - slen + 1, slen)
        cols = torch.arange(slen, device=wav_ext.device)
        out = []
        for c in range(0, starts.shape[0], PER_WINDOW_CHUNK):
            s = starts[c:c + PER_WINDOW_CHUNK].to(torch.int64)
            nv = n_valid[c:c + PER_WINDOW_CHUNK].to(torch.int64)
            win = rows[s.clamp(0, rows.shape[0] - 1)]
            win = reflect_end_patch(
                torch.where(cols < nv[:, None], win, 0.0), nv)
            out.append(audio_frontend(win, 1 + nv // HOP_LENGTH,
                                      mel_bf16=self.cfg.mel_bf16,
                                      left_aligned=True))
        return torch.cat(out)

    @torch.inference_mode()
    def fused_sweep_device_audio(self, frames_u8, wav_ext, starts, n_valid,
                                 idx) -> torch.Tensor:
        """A bucket on the per-window audio route.

        wav_ext: (L + 2*441000 + 512,) f32 = [zeros(441000) | wav |
        zeros]; starts: (N,) 441000 + clamped window offset
        (``audio_window_plan``); n_valid: (N,) true samples per window."""
        feats = self.window_features(wav_ext, starts, n_valid)
        return self.fused_sweep(frames_u8, feats, idx)

    @torch.inference_mode()
    def fused_sweep_phase_audio(self, frames_u8, wav_ext, phase_mels, starts,
                                n_valid, base, phase_sel,
                                idx) -> torch.Tensor:
        """A bucket on the phase-mel audio route: interior STFT frames
        gather from the video's ``phase_mels`` tables, the two reflect edge
        frames compute per window (ops/phase_mel.py), in the time-major
        layout the audio resnet takes."""
        feats = phase_window_features(wav_ext, phase_mels, starts, n_valid,
                                      base, phase_sel,
                                      out_frames=self.cfg.mel_frames,
                                      time_major=True)
        return self.fused_sweep(frames_u8, feats, idx, time_major=True)

    @torch.inference_mode()
    def fused_sweep_packed(self, frames_u8, wav_buf, phases, starts, n_valid,
                           base, phase_sel, idx) -> torch.Tensor:
        """A bucket of clips from several videos (packed.py assembles it):
        the phase-mel tables of ``phases`` (host ints, the distinct live
        phases of the bucket's windows) over the packed wav buffer, the
        windows' features from them, then the sweep.

        wav_buf: [zeros(PACK_PRE) | per-video segments at 441-aligned
        offsets | zeros(PACK_TAIL)]; starts and base are buffer and grid
        coordinates in that layout."""
        t_g = (wav_buf.shape[-1] - PACK_PRE - PACK_TAIL) // HOP_LENGTH + 2
        tables = phase_mel_table_span(wav_buf, phases, pre=PACK_PRE, t_g=t_g,
                                      n_mels=self.cfg.n_mels)
        feats = phase_window_features(wav_buf, tables, starts, n_valid, base,
                                      phase_sel,
                                      out_frames=self.cfg.mel_frames,
                                      time_major=True)
        return self.fused_sweep(frames_u8, feats, idx, time_major=True)

    @torch.inference_mode()
    def fused_sweep_shared_audio(self, frames_u8, mel_shared, mel_cols,
                                 idx) -> torch.Tensor:
        """A bucket with shared-spectrogram audio (opt-in, approximate): each
        window's (n_mels, 1001) map is a column gather of the video's one
        power mel ``mel_shared`` (n_mels, T) at ``mel_cols`` (N, 1001), then
        the per-window dB floor and the normalization."""
        mel_win = mel_shared[:, mel_cols.to(torch.int64)].permute(1, 0, 2)
        feats = normalize_spec(amplitude_to_db(mel_win))[:, None]
        return self.fused_sweep(frames_u8, feats, idx)

    def shared_audio_plan(self, timestamps_ms: np.ndarray,
                          total_samples: int) -> np.ndarray:
        """(N, 1001) int32 columns of a padded global mel laid out as
        [1001 zero columns | the video's mel | 1001 zero columns]; window
        offsets snap to the 441-sample hop grid, up to 5 ms from the
        reference's per-window grid."""
        cfg = self.cfg
        n = len(timestamps_ms)
        t_total = 1 + total_samples // HOP_LENGTH
        cols = np.zeros((n, cfg.mel_frames), np.int32)
        k = np.arange(cfg.mel_frames)
        for i, ts in enumerate(np.asarray(timestamps_ms)):
            offset, nsamp = audio_host.audio_window_params(
                float(ts), cfg.sample_rate, cfg.sample_len_frames,
                cfg.audio_shift_samples)
            nsamp = min(nsamp, max(total_samples - offset, 0))
            g0 = int(round(offset / float(HOP_LENGTH)))
            idx = g0 + 1 + nsamp // HOP_LENGTH + k
            cols[i] = np.clip(idx, 0, t_total + 2 * cfg.mel_frames - 1)
        return cols

    def sweep_video_shared_audio(self, frames_u8: np.ndarray,
                                 wav: np.ndarray,
                                 timestamps_ms: np.ndarray,
                                 batch: int = 512) -> np.ndarray:
        """Dense sweep with the approximate shared-spectrogram audio: ONE
        power mel of the whole wav (L,) on the device, then per-window
        column gathers. frames_u8 (N, H, W, 3) -> (N, 12) logits."""
        n = frames_u8.shape[0]
        wav = np.asarray(wav, np.float32).reshape(-1)
        with torch.inference_mode():
            mel = mel_spectrogram(self._to_device(wav)[None])[0]
            pad = mel.new_zeros((mel.shape[0], self.cfg.mel_frames))
            mel_padded = torch.cat([pad, mel, pad], dim=1)
        cols = self.shared_audio_plan(timestamps_ms, wav.shape[0])
        pending = []
        for s, cur, bsize, frames_chunk, rows in self._buckets(
                n, frames_u8, batch):
            cc = self._pad_rows(cols[s:s + cur], bsize)
            frames_chunk, cc, rows = self._to_device(frames_chunk, cc, rows)
            pending.append((s, cur, self.fused_sweep_shared_audio(
                frames_chunk, mel_padded, cc, rows)))
        return self.fetch_many([(n, pending)])[0]

    @torch.inference_mode()
    def phase_mel_table(self, wav_ext: torch.Tensor,
                        phases) -> torch.Tensor:
        """(P, T_g, n_mels) power mel tables of one video's phases."""
        return phase_mel_table(wav_ext, phases, n_mels=self.cfg.n_mels)

    def audio_window_offsets(self, timestamps_ms: np.ndarray,
                             total_samples: int
                             ) -> tuple[np.ndarray, np.ndarray]:
        """(clamped offsets, n_valid) in unpadded video-wav coordinates:
        the reference's torchaudio.load(offset, num_frames) window
        (aff2compdataset.py:218-226) with the file-length clamp of its
        loader."""
        cfg = self.cfg
        offsets, want = audio_host.audio_window_params_batch(
            timestamps_ms, cfg.sample_rate, cfg.sample_len_frames,
            cfg.audio_shift_samples)
        off_c = np.minimum(offsets, total_samples)
        n_valid = np.maximum(
            np.minimum(want, total_samples - off_c), 0).astype(np.int32)
        return off_c.astype(np.int64), n_valid

    def audio_window_plan(self, timestamps_ms: np.ndarray,
                          total_samples: int
                          ) -> tuple[np.ndarray, np.ndarray]:
        """(starts, n_valid) int32: in the [zeros(441000) | wav | zeros]
        device buffer a window starts at 441000 + its clamped offset."""
        off_c, n_valid = self.audio_window_offsets(timestamps_ms,
                                                   total_samples)
        starts = (self.cfg.sample_len_frames + off_c).astype(np.int32)
        return starts, n_valid

    def dispatch_video_device_audio(self, frames_u8: np.ndarray,
                                    wav: np.ndarray,
                                    timestamps_ms: np.ndarray,
                                    batch: int = 512):
        """Queue a whole video's dense sweep on the device and return a
        handle for :meth:`fetch_video_device_audio` / :meth:`fetch_many`
        without waiting: the host can prepare the next video meanwhile.

        The wav goes up once. The phase-mel route (exact, the default)
        when the video's windows fall on at most ``max_phases`` hop-grid
        phases, as ~30 fps timestamps do; the per-window route otherwise.
        """
        cfg = self.cfg
        n = frames_u8.shape[0]
        slen = cfg.sample_len_frames
        wav = np.asarray(wav, np.float32).reshape(-1)
        # the JAX package rounds the buffer up to whole minutes to bound its
        # compiled shapes; eager PyTorch compiles nothing per shape
        wav_ext = np.zeros(max(wav.shape[0], 1) + 2 * slen + 512, np.float32)
        wav_ext[slen:slen + wav.shape[0]] = wav
        wav_dev = self._to_device(wav_ext)
        starts, n_valid = self.audio_window_plan(timestamps_ms, wav.shape[0])

        pplan = phase_plan(starts.astype(np.int64) - slen, n_valid,
                           self.max_phases)
        phase_mels = None
        if pplan is not None:
            phases, base, phase_sel = pplan
            # the plan pads its phases with copies of the first, which no
            # window selects: the table covers the distinct ones
            phase_mels = self.phase_mel_table(wav_dev, np.unique(phases))

        pending = []  # (s, cur, device logits)
        for s, cur, bsize, frames_chunk, rows in self._buckets(
                n, frames_u8, batch):
            st = self._pad_rows(starts[s:s + cur], bsize)
            nv = self._pad_rows(n_valid[s:s + cur], bsize)
            if phase_mels is not None:
                bs = self._pad_rows(base[s:s + cur], bsize)
                ps = self._pad_rows(phase_sel[s:s + cur], bsize)
                frames_chunk, st, nv, bs, ps, rows = self._to_device(
                    frames_chunk, st, nv, bs, ps, rows)
                fut = self.fused_sweep_phase_audio(
                    frames_chunk, wav_dev, phase_mels, st, nv, bs, ps, rows)
            else:
                frames_chunk, st, nv, rows = self._to_device(
                    frames_chunk, st, nv, rows)
                fut = self.fused_sweep_device_audio(
                    frames_chunk, wav_dev, st, nv, rows)
            pending.append((s, cur, fut))
        return (n, pending)

    def dispatch_video(self, frames_u8: np.ndarray, wav=None,
                       timestamps_ms=None, batch: int = 512):
        """Uniform serving dispatch: the device-audio sweep."""
        return self.dispatch_video_device_audio(
            frames_u8, wav, timestamps_ms, batch=batch)

    @staticmethod
    def fetch_video_device_audio(handle) -> np.ndarray:
        """Wait for a :meth:`dispatch_video_device_audio` handle -> (N, 12)."""
        return _fetch_concat([handle], 12)[0]

    @staticmethod
    def fetch_many_device_audio(handles) -> "list[np.ndarray]":
        """:meth:`fetch_many` for device-audio handles (out_dim 12)."""
        return _fetch_concat(handles, 12)

    def sweep_video_device_audio(self, frames_u8: np.ndarray,
                                 wav: np.ndarray,
                                 timestamps_ms: np.ndarray,
                                 batch: int = 512) -> np.ndarray:
        """frames_u8 (N, H, W, 3) uint8, wav (L,) float32 mono of the whole
        video, timestamps_ms (N,) -> (N, 12) logits."""
        return self.fetch_video_device_audio(
            self.dispatch_video_device_audio(
                frames_u8, wav, timestamps_ms, batch=batch))

    def sweep_video(self, frames_u8: np.ndarray,
                    audio_features: np.ndarray,
                    batch: int = 512) -> np.ndarray:
        """frames_u8 (N, H, W, 3) + host audio features (N, 1, mels, T)
        -> (N, 12). Buckets of up to ``batch`` label frames, each one
        ``fused_sweep``; one fetch at the end."""
        n = frames_u8.shape[0]
        pending = []
        for s, cur, bsize, frames_chunk, rows in self._buckets(
                n, frames_u8, batch):
            af = self._pad_rows(audio_features[s:s + cur], bsize)
            frames_chunk, af, rows = self._to_device(frames_chunk, af, rows)
            pending.append((s, cur, self.fused_sweep(frames_chunk, af, rows)))
        return self.fetch_many([(n, pending)])[0]


def make_sweep(cfg: Config, model: torch.nn.Module, mesh=None,
               device=None) -> SweepBase:
    """The sweep executor for ``cfg.model_name``: avformer only so far."""
    if cfg.model_name == "avformer":
        return AvformerSweep(cfg, model, mesh=mesh, device=device)
    raise NotImplementedError(
        f"no dense-sweep executor for model {cfg.model_name!r} in "
        "auformer_torch yet; ROADMAP.md queue A6 (the rest of the model "
        "zoo, VformerSweep, SingleFrameSweep) lists it")
