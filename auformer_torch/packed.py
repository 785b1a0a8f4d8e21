"""Cross-video packed serving (counterpart of auformer/packed.py).

The per-video route (serve.py::sweep_stream) buckets each video on its own
and takes each decoded video from the decode worker as one pickled reply.
This module runs the same math in buckets of clips drawn from several
consecutive videos:

* frames stream into a shared ring (``FrameArena``): page-locked host
  memory that the decode worker maps and writes once, and from which each
  bucket's frames go to the card as one asynchronous copy of a ring view;
* each bucket is one ``AvformerSweep.fused_sweep_packed`` call: the phase-
  mel tables of the bucket's videos computed from a bucket-local packed
  wav buffer, then the sweep. Per-video audio segments sit at 441-aligned
  offsets of that buffer, so every window reads the samples it reads on
  the per-video route;
* history margins at video joins come from the window rows: rows outside a
  video point at the black slot, as the reference pads short clips
  (aff2compdataset.py:126-131), so no window reads another video's frames;
* the first bucket dispatches once its frames are decoded, not after the
  whole first video.

Where the port departs from the JAX module: eager PyTorch compiles nothing
per shape, so buckets are not padded to a quantum (``_bsize``), the phase
axis is not padded to a power of two and the wav buffer is not rounded to
``WAV_QUANTUM``; ring rows are released strictly FIFO, each release gated
on the CUDA event recorded after the copy that reads them (``ArenaReleases``).
"""
from __future__ import annotations

import collections
import contextlib
import mmap
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from .ops.audio import HOP_LENGTH
from .ops.phase_mel import SLEN

#: packed wav buffer layout: [zeros(PACK_PRE) | content | zeros(PACK_TAIL)].
#: PRE >= 441 so phase-table row 0 and start-edge reads never clamp; TAIL >=
#: window + 512 so the longest window slice from the last valid sample stays
#: in the buffer
PACK_PRE = HOP_LENGTH
PACK_TAIL = SLEN + 512


class ArenaFull(RuntimeError):
    """An allocation would overwrite ring rows that are not yet released."""


class FrameArena:
    """Ring of decoded (h, w, 3) uint8 frames addressed by global frame
    index, in a memfd (shmem, which the size of a ``/dev/shm`` mount does
    not cap; never a file on a regular filesystem, whose writable pages the
    kernel refuses to page-lock for long) that the decode worker maps
    through ``fd``. For a CUDA ``device`` the ring is registered with
    ``cudaHostRegister`` once, so a copy from a ring view runs
    asynchronously; a registration that fails raises.

    Consumption is FIFO (buckets dispatch in global clip order): the live
    region is one contiguous ring interval, freed by ``release_below``."""

    def __init__(self, capacity: int, h: int, w: int, device=None):
        self.cap = capacity
        self.nbytes = capacity * h * w * 3
        self.backing = "memfd"
        self.fd = os.memfd_create("auformer_arena", os.MFD_CLOEXEC)
        try:
            os.ftruncate(self.fd, self.nbytes)
            self._mm = mmap.mmap(self.fd, self.nbytes)
        except OSError:
            os.close(self.fd)
            raise
        self.buf = np.frombuffer(self._mm, np.uint8).reshape(capacity, h, w,
                                                             3)
        self.registered = False
        if device is not None and torch.device(device).type == "cuda":
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostRegister(self.buf.ctypes.data, self.nbytes,
                                          0)
            if err != cudart.cudaError.success:
                self.close()
                raise RuntimeError(
                    f"cudaHostRegister of the {self.nbytes}-byte frame ring "
                    f"({self.backing}) failed: "
                    f"{cudart.cudaGetErrorString(err)}")
            self.registered = True
        self._segs: list[tuple[int, int, int]] = []  # (g_lo, g_hi, base)
        self._cursor = 0
        self._free_g = 0     # frames with g < _free_g are released
        #: host bytes assembled into chunk copies (ring wraps)
        self.copied_bytes = 0

    def close(self) -> None:
        """Unregister and unmap the ring (a view still held elsewhere keeps
        its pages mapped until it goes)."""
        if self.buf is None:
            return
        if self.registered:
            torch.cuda.cudart().cudaHostUnregister(self.buf.ctypes.data)
            self.registered = False
        self.buf = None
        try:
            self._mm.close()
        except BufferError:
            pass    # a chunk view still exports the mapping
        os.close(self.fd)

    def alloc(self, g_lo: int, n: int) -> int:
        """Reserve ring space for global frames [g_lo, g_lo + n); returns
        the ring base the writer must use. Raises ``ArenaFull`` where that
        would overwrite rows that are not yet released."""
        if n > self.cap:
            raise ValueError(f"slice {n} exceeds arena capacity {self.cap}")
        base = 0 if self._cursor + n > self.cap else self._cursor
        for s_lo, s_hi, s_base in self._segs:
            if s_hi <= self._free_g:
                continue
            lo = s_base + max(self._free_g - s_lo, 0)
            hi = s_base + (s_hi - s_lo)
            if lo < hi and lo < base + n and base < hi:
                raise ArenaFull(
                    "FrameArena overflow: undispatched backlog "
                    f"[{self._free_g}, {s_hi}) still occupies the ring")
        self._segs.append((g_lo, g_lo + n, base))
        self._cursor = base + n
        return base

    def release_below(self, g: int) -> None:
        self._free_g = max(self._free_g, g)
        while self._segs and self._segs[0][1] <= self._free_g:
            self._segs.pop(0)

    def chunk(self, g_lo: int, g_hi: int) -> np.ndarray:
        """Frames [g_lo, g_hi) as one contiguous array: a view of the ring
        where the range is ring-contiguous, else an assembled copy (a ring
        wrap; its bytes count in ``copied_bytes``)."""
        view = self._find_view(g_lo, g_hi)
        if view is not None:
            return view
        out = np.empty((g_hi - g_lo,) + self.buf.shape[1:], np.uint8)
        g = g_lo
        for s_lo, s_hi, base in self._segs:
            lo, hi = max(g, s_lo), min(g_hi, s_hi)
            if lo < hi:
                out[lo - g_lo:hi - g_lo] = \
                    self.buf[base + lo - s_lo:base + hi - s_lo]
                g = hi
        if g < g_hi:
            raise KeyError(f"frames [{g}, {g_hi}) not in arena")
        self.copied_bytes += out.nbytes
        return out

    def _find_view(self, g_lo: int, g_hi: int):
        """Contiguous ring view covering [g_lo, g_hi), else None."""
        run_base = run_lo = run_hi = None
        for s_lo, s_hi, base in self._segs:
            if s_hi <= g_lo or s_lo >= g_hi:
                if run_hi is not None and run_hi >= g_hi:
                    break
                continue
            if run_hi is None:
                run_base, run_lo, run_hi = base, s_lo, s_hi
            elif s_lo == run_hi and base == run_base + (run_hi - run_lo):
                run_hi = s_hi
            else:
                return None  # ring discontinuity inside the range
        if run_hi is None or run_lo > g_lo or run_hi < g_hi:
            return None
        o = run_base + (g_lo - run_lo)
        return self.buf[o:o + (g_hi - g_lo)]


class ArenaReleases:
    """FIFO releases of ring rows, each gated on the event recorded after
    the copy that reads them (``query()`` when polling, ``synchronize()``
    where the ring must give space back now). ``None`` stands for a copy
    that completed before it was queued (the CPU's). Watermarks must not
    decrease, so a later release never lands before an earlier one."""

    def __init__(self, arena: FrameArena):
        self.arena = arena
        self._queue: collections.deque = collections.deque()
        self._last = 0       # the latest watermark queued
        self.released = 0    # releases made
        self.blocked = 0     # of them, releases that waited on their event

    def push(self, event, g: int) -> None:
        if g < self._last:
            raise ValueError(f"release watermark {g} below the earlier "
                             f"{self._last}")
        self._last = g
        self._queue.append((event, g))

    def reap(self, block: bool = False) -> bool:
        """Release every queued watermark whose copy has completed, in
        order; with ``block`` wait for the oldest first. Returns whether
        anything was released."""
        released = False
        while self._queue:
            event, g = self._queue[0]
            if event is not None and not event.query():
                if not block:
                    break
                event.synchronize()
                self.blocked += 1
                block = False
            self._queue.popleft()
            self.arena.release_below(g)
            self.released += 1
            released = True
        return released

    def drain(self) -> None:
        """Wait for every queued copy and release its rows."""
        while self._queue:
            self.reap(block=True)


class _VideoPlan:
    """Host-side per-video bookkeeping the assembler consumes."""

    __slots__ = ("video_nr", "video_id", "vid_idx", "n", "frame_base",
                 "off_c", "n_valid", "phase", "wav", "wav_len", "ts",
                 "out", "written", "fallback")

    def __init__(self, video_nr, video_id, vid_idx, frame_base, ts):
        self.video_nr = video_nr
        self.video_id = video_id
        self.vid_idx = vid_idx
        self.n = len(vid_idx)
        self.frame_base = frame_base
        self.ts = ts
        self.wav = None
        self.out = None
        self.written = np.zeros(self.n, bool)
        self.fallback = False


class PackedAssembler:
    """Packs decoded videos into dispatch buckets of up to ``bucket`` clips.

    Feed ``register_video`` (metadata and timestamps up front), ``set_wav``
    (when the decoder delivers audio) and ``frames_ready`` (decode progress
    in global frame coordinates); ``drain`` yields bucket plans and
    ``upload_dispatch`` sends each to the card. A video whose own
    timestamps need more than ``sweep.max_phases`` hop-grid phases takes
    the per-video route alone; a bucket closes early when the next video's
    clips would push the phase union past that."""

    def __init__(self, sweep, arena: FrameArena, bucket: int):
        self.sweep = sweep
        self.arena = arena
        self.bucket = bucket
        self.cfg = sweep.cfg
        self.releases = ArenaReleases(arena)
        self.videos: list[_VideoPlan] = []
        self._g_decoded = 0       # frames [0, g) written to the arena
        self._g_dispatched = 0    # clips [0, g) handed to the card
        self._total = 0
        on_card = sweep.device.type == "cuda"
        #: side stream of the ring-to-card copies
        self.copy_stream = torch.cuda.Stream(sweep.device) if on_card \
            else None

    # ---- registration -----------------------------------------------------
    def register_video(self, video_nr, video_id, vid_idx,
                       timestamps_ms) -> None:
        vp = _VideoPlan(video_nr, video_id, np.asarray(vid_idx),
                        self._total, np.asarray(timestamps_ms))
        self._total += vp.n
        self.videos.append(vp)

    def set_wav(self, video_nr, wav: np.ndarray) -> None:
        vp = self._vp(video_nr)
        vp.wav = np.asarray(wav, np.float32).reshape(-1)
        vp.wav_len = vp.wav.shape[0]
        vp.off_c, vp.n_valid = self.sweep.audio_window_offsets(vp.ts,
                                                               vp.wav_len)
        vp.phase = vp.off_c % HOP_LENGTH
        live = np.unique(vp.phase[vp.n_valid > 0])
        vp.fallback = live.size > self.sweep.max_phases

    def frames_ready(self, g_hi: int) -> None:
        self._g_decoded = max(self._g_decoded, g_hi)

    def _vp(self, video_nr) -> _VideoPlan:
        for vp in self.videos:
            if vp.video_nr == video_nr:
                return vp
        raise KeyError(video_nr)

    # ---- dispatch ---------------------------------------------------------
    def drain(self, flush: bool = False):
        """Yield a host-side plan (numpy payloads and an arena chunk) for
        every bucket that is ready: frames decoded, wavs present. ``flush``
        closes the final partial bucket."""
        while True:
            plan = self._next_bucket(flush)
            if plan is None:
                return
            yield plan

    def upload_dispatch(self, plan: dict):
        """Send a plan to the card and queue its computation -> (handle,
        demux). The plan's ring rows are released after the copy that reads
        them completes: FIFO, each on its own event."""
        release_g = max(plan["e"] - self.cfg.label_frame, 0)
        if plan["kind"] == "fallback":
            vp = plan["vp"]
            handle = self.sweep.dispatch_video(
                plan["frames"], wav=vp.wav, timestamps_ms=vp.ts,
                batch=self.bucket)
            copied = self._record_event(None)
        else:
            handle, copied = self._upload_packed(plan)
        self.releases.push(copied, release_g)
        self.releases.reap()
        return handle, plan["demux"]

    def reap_releases(self, block: bool = False) -> bool:
        return self.releases.reap(block)

    def _record_event(self, stream):
        """A CUDA event recorded on ``stream`` (the current stream when
        None); None on the CPU, where every copy has completed when the
        call that made it returns."""
        if self.copy_stream is None:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def _ready_hi(self) -> int:
        """Global clip frontier that is dispatchable: frames decoded and the
        owning video's wav known (it arrives with the first slice)."""
        hi = self._g_decoded
        for vp in self.videos:
            if vp.frame_base >= hi:
                break
            if vp.wav is None:
                return min(hi, vp.frame_base)
        return hi

    def _next_bucket(self, flush: bool):
        s = self._g_dispatched
        hi = self._ready_hi()
        if hi - s <= 0:
            return None
        vp0 = self._video_at(s)
        if vp0.fallback:
            if hi < vp0.frame_base + vp0.n:
                return None  # wait for the whole video
            return self._dispatch_fallback(vp0)
        # grow [s, e): stop at capacity, at a fallback video, or where the
        # phase union would exceed max_phases
        e = s
        union: set = set()
        while e < hi and e - s < self.bucket:
            vp = self._video_at(e)
            if vp.fallback:
                break
            take_hi = min(vp.frame_base + vp.n, hi, s + self.bucket)
            a, b = e - vp.frame_base, take_hi - vp.frame_base
            ph = set(np.unique(vp.phase[a:b][vp.n_valid[a:b] > 0]).tolist())
            if union and len(union | ph) > self.sweep.max_phases:
                break
            union |= ph
            e = take_hi
        if e == s:
            return None
        full = (e - s) == self.bucket
        at_break = e < hi and (self._video_at(e).fallback or not full)
        if not full and not flush and not at_break:
            return None  # keep filling
        return self._prepare_packed(s, e)

    def _video_at(self, g: int) -> _VideoPlan:
        for vp in self.videos:
            if vp.frame_base <= g < vp.frame_base + vp.n:
                return vp
        raise KeyError(g)

    def _prepare_packed(self, s: int, e: int) -> dict:
        """Host stage of clips [s, e): window rows, the packed wav buffer,
        the phase-table inputs and the arena chunk of frames [s - lf, e)."""
        cfg = self.cfg
        lf = cfg.label_frame
        cur = e - s
        lo = max(s - lf, 0)
        black = e - lo             # the black frame rides after the chunk
        rows = np.full((cur, cfg.n_frames), black, np.int64)
        starts = np.zeros(cur, np.int64)
        n_valid = np.zeros(cur, np.int32)
        base = np.zeros(cur, np.int64)
        phase_vals = np.zeros(cur, np.int64)
        demux = []
        segs = []  # (vp, seg_lo, seg_hi, pos)
        cursor = 0
        k = np.arange(cfg.n_frames)[None, :]
        g = s
        while g < e:
            vp = self._video_at(g)
            b_hi = min(vp.frame_base + vp.n, e)
            a, b = g - vp.frame_base, b_hi - vp.frame_base
            r = slice(g - s, b_hi - s)
            idx = np.arange(a, b)[:, None] - lf + cfg.dilation * (k + 1)
            oob = (idx < 0) | (idx >= vp.n)
            rows[r] = np.where(oob, black, idx + vp.frame_base - lo)

            off = vp.off_c[a:b]
            seg_lo = int((off.min() // HOP_LENGTH) * HOP_LENGTH)
            seg_hi = int(min(off.max() + cfg.sample_len_frames + 512,
                             vp.wav_len))
            segs.append((vp, seg_lo, seg_hi, cursor))
            starts[r] = PACK_PRE + cursor + (off - seg_lo)
            n_valid[r] = vp.n_valid[a:b]
            base[r] = (cursor + off - seg_lo) // HOP_LENGTH
            phase_vals[r] = (off - seg_lo) % HOP_LENGTH
            # +512 zero guard between segments: an edge frame of a window
            # cut by the end of its file reads ~512 samples past its content
            # (FFT support), zeros on the per-video route too
            cursor = -(-(cursor + max(seg_hi - seg_lo, 0) + 512)
                       // HOP_LENGTH) * HOP_LENGTH
            demux.append((vp, g - s, b_hi - s, a))
            g = b_hi

        wav_buf = np.zeros(PACK_PRE + cursor + PACK_TAIL, np.float32)
        for vp, seg_lo, seg_hi, pos in segs:
            if seg_hi > seg_lo:
                wav_buf[PACK_PRE + pos:PACK_PRE + pos + seg_hi - seg_lo] = \
                    vp.wav[seg_lo:seg_hi]
        # tables for the distinct live phases only; a dead window selects
        # table 0 and is masked to zeros
        live = n_valid > 0
        phases = np.unique(phase_vals[live])
        if phases.size == 0:
            phases = np.zeros(1, np.int64)
        psel = np.where(live, np.searchsorted(phases, phase_vals), 0)
        copied = self.arena.copied_bytes
        chunk = self.arena.chunk(lo, e)
        self._g_dispatched = e
        return {"kind": "packed", "e": e, "cur": cur, "chunk": chunk,
                "chunk_copy_bytes": self.arena.copied_bytes - copied,
                "st": starts.astype(np.int32), "nv": n_valid,
                "bs": base.astype(np.int32), "ps": psel.astype(np.int32),
                "rw": rows, "wav_buf": wav_buf, "phases": phases,
                "demux": demux}

    def _upload_packed(self, plan: dict):
        """The chunk goes from its ring view to the card on the side copy
        stream (no staging copy: the ring is page-locked); the compute
        stream waits on the copy's event. -> (handle, the copy's event)."""
        sw = self.sweep
        chunk = torch.from_numpy(plan["chunk"])
        if self.copy_stream is None:
            frames = chunk
        else:
            with torch.cuda.stream(self.copy_stream):
                frames = chunk.to(sw.device, non_blocking=True)
            compute = torch.cuda.current_stream(sw.device)
            copied = self._record_event(self.copy_stream)
            compute.wait_event(copied)
            frames.record_stream(compute)
        wav, st, nv, bs, ps, rw = sw._to_device(
            plan["wav_buf"], plan["st"], plan["nv"], plan["bs"], plan["ps"],
            plan["rw"])
        fut = sw.fused_sweep_packed(frames, wav, plan["phases"], st, nv, bs,
                                    ps, rw)
        cur = plan["cur"]
        return (cur, [(0, cur, fut)]), \
            (None if self.copy_stream is None else copied)

    def _dispatch_fallback(self, vp: _VideoPlan) -> dict:
        """Per-video route plan for a video past ``max_phases``; its
        dispatch (``sweep.dispatch_video``) stages the frames itself."""
        e = vp.frame_base + vp.n
        frames = self.arena.chunk(vp.frame_base, e)
        self._g_dispatched = e
        return {"kind": "fallback", "e": e, "vp": vp, "frames": frames,
                "demux": [(vp, 0, vp.n, 0)]}


def _ring_frames(sweep, bucket: int, plans: list) -> int:
    """Ring capacity: what the stream holds at once (4 buckets + 2 history
    margins: a bucket filling, up to 2 buckets of frames in flight with the
    slice being allocated, up to a slice lost to a wrap), and for a video
    that may take the per-video route (its timestamps alone give more than
    ``max_phases`` phases), the whole video plus 3 buckets and the
    margins."""
    lf = sweep.cfg.label_frame
    need = 4 * bucket + 2 * lf
    for vid_idx, ts in plans:
        off, _ = sweep.audio_window_offsets(ts, np.iinfo(np.int64).max)
        if np.unique(off % HOP_LENGTH).size > sweep.max_phases:
            need = max(need, len(vid_idx) + 3 * bucket + 2 * lf)
    return need


def packed_sweep_stream(cfg, model: torch.nn.Module, dataset=None,
                        bucket: int | None = None,
                        max_clips: int | None = None, sweep=None,
                        decode_worker=None, mesh=None,
                        stats: dict | None = None, device=None
                        ) -> Iterator[tuple[np.ndarray, str, np.ndarray]]:
    """Packed-bucket serving: the contract of ``serve.sweep_stream``
    (yields ``(vid_idx, video_id, (N, 12) logits)`` per video, in video
    order), with buckets packed across videos.

    Decode slices of up to one bucket each, up to 2 buckets of frames in
    flight, go into the ``FrameArena``: through the ring that the
    ``decode_worker`` maps (one is started, and closed at the end, when
    None and the split holds ``serve.WORKER_MIN_CLIPS`` clips), else on a
    thread (``decode_worker=False``). Each slice's buckets dispatch as soon
    as they fill, so the copies and the card's work overlap the decode of
    later slices. Results are fetched in groups of ``FETCH_GROUP_CLIPS``
    clips, as ``sweep_stream`` fetches them. ``max_clips`` keeps the
    leading videos until they hold that many clips.

    ``stats`` (optional dict) accumulates ``decode_seconds`` /
    ``wait_seconds`` (blocked on the next decoded slice) /
    ``sweep_seconds`` / ``clips`` / ``buckets`` / ``rows_dispatched`` /
    ``rows_padded`` (of the per-video route's buckets) /
    ``fallback_videos`` / ``chunk_copy_bytes`` (host bytes assembled into
    chunks, per packed bucket), and holds ``arena`` (backing, frames,
    bytes, registered), ``releases`` (made, blocked), the ``sweep`` and
    the ``decode_worker``.
    """
    from .data.testset import Aff2TestDataset
    from .infer import FETCH_GROUP_CLIPS
    from .serve import (WORKER_MIN_CLIPS, DecodeWorker, _test_videos,
                        decode_video_frames, read_video_wav)
    from .sweep import default_sweep_bucket, make_sweep

    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel sweep is not ported to auformer_torch; "
            "ROADMAP.md queue A7 (multi-process) lists it")
    dataset = Aff2TestDataset(cfg) if dataset is None else dataset
    sweep = sweep or make_sweep(cfg, model, device=device)
    if not hasattr(sweep, "fused_sweep_packed"):
        raise NotImplementedError(
            f"no packed buckets for {type(sweep).__name__}: only the "
            "audio-bearing AvformerSweep packs videos; ROADMAP.md queue A6 "
            "(the rest of the model zoo) lists the other sweeps")
    bucket = bucket or default_sweep_bucket(sweep.device)
    size = cfg.image_size
    test_idx, videos, counts = _test_videos(dataset)
    if max_clips is not None:
        k, acc = 0, 0
        while k < len(videos) and acc < max_clips:
            acc += counts[k]
            k += 1
        videos, counts = videos[:k], counts[:k]
    vid_rows = {v: test_idx[dataset.video_db_nr[test_idx] == v]
                for v in videos}
    ts_all = np.asarray(dataset.time_stamps)

    st = stats if stats is not None else {}
    for key in ("decode_seconds", "wait_seconds", "sweep_seconds"):
        st.setdefault(key, 0.0)
    for key in ("clips", "buckets", "rows_dispatched", "rows_padded",
                "fallback_videos"):
        st.setdefault(key, 0)
    st.setdefault("chunk_copy_bytes", [])
    st["sweep"] = sweep
    on_card = sweep.device.type == "cuda"
    dispatch_stream = torch.cuda.current_stream(sweep.device) if on_card \
        else None

    worker = decode_worker or None  # False = forced thread
    owns_worker = (worker is None and decode_worker is not False and videos
                   and sum(counts) >= WORKER_MIN_CLIPS)
    if owns_worker:
        worker = DecodeWorker(cfg)
    st["decode_worker"] = worker

    arena = FrameArena(
        _ring_frames(sweep, bucket, [(vid_rows[v], ts_all[vid_rows[v]])
                                     for v in videos]),
        size, size, device=sweep.device)
    st["arena"] = {"backing": arena.backing, "frames": arena.cap,
                   "bytes": arena.nbytes, "registered": arena.registered}
    asm = PackedAssembler(sweep, arena, bucket)
    for v in videos:
        vi = vid_rows[v]
        asm.register_video(v, os.path.dirname(dataset.image_path[vi[0]]),
                           vi, ts_all[vi])

    # the slice-decode plan: (video_nr, a, b, g_lo, first slice)
    slices = []
    g = 0
    for v, n in zip(videos, counts):
        slices += [(v, a, min(a + bucket, n), g + a, a == 0)
                   for a in range(0, n, bucket)]
        g += n

    fetch_ex = ThreadPoolExecutor(max_workers=1)
    fetch_futs: list = []
    pending: list = []   # (handle, demux, done event)
    pending_clips = 0
    st_lock = threading.Lock()
    inflight: collections.deque = collections.deque()
    inflight_frames = 0
    si = 0               # the next slice to request
    local_ex = None

    def _drain_async():
        nonlocal pending_clips
        if not pending:
            return
        group = list(pending)
        pending.clear()
        pending_clips = 0

        def work():
            td = time.perf_counter()
            for *_, done in group:
                if done is not None:
                    done.synchronize()
            with (torch.cuda.stream(dispatch_stream) if on_card
                  else contextlib.nullcontext()):
                outs = sweep.fetch_many([h for h, _, _ in group])
            with st_lock:
                st["clips"] += sum(h[0] for h, _, _ in group)
                st["sweep_seconds"] += time.perf_counter() - td
            return list(zip(outs, [d for _, d, _ in group]))

        fetch_futs.append(fetch_ex.submit(work))

    def _demux(out, demux):
        """Write a bucket's rows into its videos; yield each video whose
        every row is written, once each."""
        for vp, r_lo, r_hi, clip_lo in demux:
            if vp.out is None:
                vp.out = np.zeros((vp.n, out.shape[1]), np.float32)
            rows = slice(clip_lo, clip_lo + r_hi - r_lo)
            if vp.written[rows].any():
                raise RuntimeError(f"rows of {vp.video_id} written twice")
            vp.out[rows] = out[r_lo:r_hi]
            vp.written[rows] = True
            if vp.written.all():
                yield vp.vid_idx, vp.video_id, vp.out

    def _completed():
        while fetch_futs and fetch_futs[0].done():
            for out, demux in fetch_futs.pop(0).result():
                yield from _demux(out, demux)

    def _dispatch(plans):
        nonlocal pending_clips
        td = time.perf_counter()
        for plan in plans:
            handle, demux = asm.upload_dispatch(plan)
            done = asm._record_event(None)
            pending.append((handle, demux, done))
            pending_clips += handle[0]
            dispatched = sum(f.shape[0] for _, _, f in handle[1])
            st["buckets"] += len(handle[1])
            st["rows_dispatched"] += dispatched
            st["rows_padded"] += dispatched - handle[0]
            if plan["kind"] == "packed":
                st["chunk_copy_bytes"].append(plan["chunk_copy_bytes"])
            else:
                st["fallback_videos"] += 1
        with st_lock:
            st["sweep_seconds"] += time.perf_counter() - td
        if pending_clips >= FETCH_GROUP_CLIPS:
            _drain_async()

    def _alloc(g_lo: int, n: int) -> int:
        """Ring space for a slice: on arena pressure, wait for the oldest
        copy in flight and release its rows, until the slice fits."""
        asm.reap_releases()
        while True:
            try:
                return arena.alloc(g_lo, n)
            except ArenaFull:
                if not asm.reap_releases(block=True):
                    raise

    def _decode_slice_local(v, a, b, base, first):
        td = time.perf_counter()
        decode_video_frames(dataset, vid_rows[v][a:b], size, size,
                            out=arena.buf[base:base + (b - a)])
        wav = read_video_wav(dataset.audio_dir, asm._vp(v).video_id) \
            if first else None
        return wav, time.perf_counter() - td

    def _request_slices():
        """Keep the decoder busy: request slices while the frames in
        flight stay within 2 buckets (a short tail slice of a video does
        not leave the decoder idle)."""
        nonlocal si, inflight_frames
        while si < len(slices):
            v, a, b, g_lo, first = sl = slices[si]
            if inflight and inflight_frames + (b - a) > 2 * bucket:
                return
            base = _alloc(g_lo, b - a)
            if worker is not None:
                worker.request_slice(v, a, b, base, first)
                inflight.append((sl, None))
            else:
                inflight.append((sl, local_ex.submit(
                    _decode_slice_local, v, a, b, base, first)))
            inflight_frames += b - a
            si += 1

    try:
        if worker is not None:
            worker.attach_arena(arena)
        else:
            local_ex = ThreadPoolExecutor(max_workers=1)
        _request_slices()
        while inflight:
            (v, a, b, g_lo, _), fut = inflight.popleft()
            tw = time.perf_counter()
            wav, dsec = worker.slice_result() if fut is None \
                else fut.result()
            st["wait_seconds"] += time.perf_counter() - tw
            st["decode_seconds"] += dsec
            inflight_frames -= b - a
            if wav is not None:
                asm.set_wav(v, wav)
            asm.frames_ready(g_lo + (b - a))
            # dispatch before the next requests: the ring then holds at most
            # a filling bucket, its history, 2 buckets of frames in flight
            # and what a wrap leaves unused
            _dispatch(list(asm.drain()))
            _request_slices()
            yield from _completed()
        _dispatch(list(asm.drain(flush=True)))
        _drain_async()
        for f in fetch_futs:
            for out, demux in f.result():
                yield from _demux(out, demux)
        fetch_futs.clear()
    finally:
        fetch_ex.shutdown(wait=True)
        if local_ex is not None:
            local_ex.shutdown(wait=True)
        if worker is not None and inflight and not owns_worker:
            # leave the caller's worker with no reply outstanding
            for _ in range(len(inflight)):
                worker.slice_result()
        if owns_worker:
            worker.close()
            st["decode_worker"] = None
        asm.releases.drain()
        st["releases"] = {"made": asm.releases.released,
                          "blocked": asm.releases.blocked}
        arena.close()
