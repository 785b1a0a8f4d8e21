"""Fused decode -> infer serving pipeline (counterpart of auformer/serve.py).

The production-path counterpart of test_aff2: the host (the native reader's
batched JPEG decode + wav reads) streams uint8 frames and audio into the
device forward; predictions demux to per-video rows on the host.

  * ``stream_predictions`` / ``serve_benchmark``: the clip path, loader
    batches through ``make_infer_fn``, the next batch decoding while the
    card runs the last;
  * ``sweep_stream`` / ``sweep_serve_benchmark``: the dense sweep, one
    video at a time, video *i+1* decoding (in a ``DecodeWorker`` process
    past a few thousand clips) while the card sweeps video *i*, results
    fetched in groups on a fetch thread, yielded in video order;
  * ``sweep_serve_benchmark(packed=True)``: the same through
    ``packed.packed_sweep_stream``, buckets packed across videos, the
    worker decoding slices straight into a shared frame ring
    (``DecodeWorker.attach_arena`` / ``request_slice`` / ``slice_result``).

Under a mesh (core/mesh.py) ``sweep_stream`` streams this rank's
videos of the test split (``shard_indices``: video i to rank i mod N);
``infer.run_inference_sweep`` gathers the rows.
"""
from __future__ import annotations

import contextlib
import mmap
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from .core.config import Config
from .core.mesh import check_mesh
from .data.samplers import shard_indices
from .data.testset import Aff2TestDataset, strip_position
from .infer import (FETCH_GROUP_CLIPS, make_infer_fn, model_inputs,
                    testset_loader)
from .ops import audio_host

#: test clips from which ``sweep_stream`` decodes in a worker process (its
#: start-up costs seconds; below this the decode thread wins)
WORKER_MIN_CLIPS = 2000


def decode_video_frames(dataset, vid_idx, h: int, w: int,
                        out: np.ndarray | None = None) -> np.ndarray:
    """(N, h, w, 3) uint8 frames for the given dataset rows, by one batched
    native decode into ``out`` when given (rows of a frame ring); missing or
    undecodable keys stay black, as in the datasets' clips."""
    if dataset.native_image is None:
        raise FileNotFoundError(
            f"no image store under {dataset.cfg.lmdb_label_dir}: the port "
            "reads frames from FrameStores only")
    keys = [dataset._store_key(dataset.image_path[i]) for i in vid_idx]
    frames, _ok = dataset.native_image.decode_batch(keys, h, w, 3, out=out)
    return frames


def read_video_wav(audio_dir: str, video_id: str) -> np.ndarray:
    """Mono float32 wav for a video id (position suffix stripped), zeros(1)
    on any read failure: the zero-audio fallback the reference applies
    (aff2compdataset.py:227-232)."""
    try:
        wav, _sr = audio_host.load_wav(
            os.path.join(audio_dir, strip_position(video_id) + ".wav"))
        return wav[0]
    except (OSError, EOFError, ValueError):
        return np.zeros(1, np.float32)


def stream_predictions(cfg: Config, model: torch.nn.Module,
                       dataset: Aff2TestDataset | None = None, device=None
                       ) -> Iterator[tuple[np.ndarray, np.ndarray, list]]:
    """Yield (indices, (B, 21) logits, video_ids) over the test split in
    batches of ``cfg.batch_size``, the next batch's decode overlapping the
    card's forward of the last."""
    dataset = Aff2TestDataset(cfg) if dataset is None else dataset
    loader = testset_loader(cfg, model, dataset)
    infer = make_infer_fn(cfg, model, device)
    pending = None
    for batch in loader:
        out = infer(model_inputs(batch))  # queued; the next decode overlaps
        if pending is not None:
            pb, po = pending
            yield pb["Index"], po.cpu().numpy(), list(pb["video_id"])
        pending = (batch, out)
    if pending is not None:
        pb, po = pending
        yield pb["Index"], po.cpu().numpy(), list(pb["video_id"])


def serve_benchmark(cfg: Config, model: torch.nn.Module, dataset=None,
                    device=None) -> dict:
    """End-to-end decode -> infer clips/s of the clip path (host pipeline
    included)."""
    n = 0
    t0 = time.perf_counter()
    for idxs, _logits, _vids in stream_predictions(cfg, model, dataset,
                                                   device):
        n += len(idxs)
    dt = time.perf_counter() - t0
    return {"clips": n, "seconds": dt,
            "clips_per_sec": n / dt if dt > 0 else 0.0}


def _load_video(dataset, test_idx, video_nr, image_size: int,
                want_wav: bool = True):
    """(vid_idx, frames, wav, timestamps, decode seconds) of one test
    video; the wav is None, and not read, without ``want_wav`` (a sweep
    that takes no audio)."""
    t0 = time.perf_counter()
    vid_idx = test_idx[dataset.video_db_nr[test_idx] == video_nr]
    video_id = os.path.dirname(dataset.image_path[vid_idx[0]])
    frames = decode_video_frames(dataset, vid_idx, image_size, image_size)
    wav = read_video_wav(dataset.audio_dir, video_id) if want_wav else None
    ts = np.asarray(dataset.time_stamps)[vid_idx]
    return vid_idx, frames, wav, ts, time.perf_counter() - t0


def _decode_worker_main(conn, cfg: Config) -> None:
    """Decode-worker child: serve requests until a ``None`` one; an
    exception goes back as ``("error", traceback)``. The child builds its
    own ``Aff2TestDataset(cfg)``, so the parent's dataset is the one
    ``cfg`` describes. Requests:

      * ``("video", video_nr, want_wav)``: reply (vid_idx, frames, wav or
        None, ts, decode_s), the whole video through the pipe;
      * ``("arena", capacity, h, w)`` followed by the fd of a
        ``packed.FrameArena``'s shared memory: map that ring (replacing any
        earlier one), reply ``"arena_ok"``;
      * ``("slice", video_nr, a, b, base, want_wav)``: decode the video's
        test rows [a, b) straight into ring rows [base, base + b - a),
        reply (wav or None, decode_s); the frames cross the process
        boundary only through the ring.

    A separate PROCESS, not a thread: decode runs on its own interpreter
    lock and scheduler share, whatever the parent's threads do (the
    isolation torch's DataLoader workers give the reference pipeline). The
    child runs no torch computation: with the libjpeg reader it never
    touches the card; the nvJPEG reader opens the card through the CUDA
    runtime of its own, in this process."""
    try:
        ds = Aff2TestDataset(cfg)
        test_idx = np.nonzero(ds.test_ids)[0]
    except Exception:
        conn.send(("error", traceback.format_exc()))
        conn.close()
        return
    conn.send("ready")  # startup handshake: imports + dataset ctor done
    size = cfg.image_size
    ring = ring_map = None
    while True:
        req = conn.recv()
        if req is None:
            conn.close()
            return
        try:
            if isinstance(req, tuple) and req[0] == "arena":
                from multiprocessing import reduction
                _tag, cap, h, w = req
                fd = reduction.recv_handle(conn)
                ring = None
                if ring_map is not None:
                    ring_map.close()
                try:
                    ring_map = mmap.mmap(fd, cap * h * w * 3)
                finally:
                    os.close(fd)
                ring = np.frombuffer(ring_map, np.uint8).reshape(cap, h, w,
                                                                 3)
                conn.send("arena_ok")
            elif isinstance(req, tuple) and req[0] == "slice":
                _tag, video_nr, a, b, base, want_wav = req
                t0 = time.perf_counter()
                vid_idx = test_idx[ds.video_db_nr[test_idx] == video_nr]
                decode_video_frames(ds, vid_idx[a:b], size, size,
                                    out=ring[base:base + (b - a)])
                wav = read_video_wav(ds.audio_dir, os.path.dirname(
                    ds.image_path[vid_idx[0]])) if want_wav else None
                conn.send((wav, time.perf_counter() - t0))
            else:
                _tag, video_nr, want_wav = req
                conn.send(_load_video(ds, test_idx, video_nr, size,
                                      want_wav))
        except Exception:
            conn.send(("error", traceback.format_exc()))


class DecodeWorker:
    """Process-isolated video decoder (see ``_decode_worker_main``),
    started with ``spawn`` (never a fork of a process that holds a CUDA
    context). Raises when the child does not come up: nothing falls back
    to another decode path."""

    #: seconds the child may take to import and build its dataset
    START_TIMEOUT = 180.0

    def __init__(self, cfg: Config):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_decode_worker_main,
                                 args=(child, cfg), daemon=True)
        t0 = time.perf_counter()
        self._proc.start()
        child.close()
        try:
            msg = (self._conn.recv() if self._conn.poll(self.START_TIMEOUT)
                   else ("error",
                         f"no handshake in {self.START_TIMEOUT} s"))
        except EOFError:
            msg = ("error", f"the child exited ({self._proc.exitcode})")
        if msg != "ready":
            self.close()
            raise RuntimeError(f"decode worker failed to start: {msg[1]}")
        #: seconds from spawn to the child's handshake
        self.startup_seconds = time.perf_counter() - t0

    def request(self, video_nr, want_wav: bool = True) -> None:
        self._conn.send(("video", video_nr, bool(want_wav)))

    def result(self):
        """(vid_idx, frames, wav or None, ts, decode_s) of the oldest
        request."""
        msg = self._conn.recv()
        if isinstance(msg, tuple) and msg and isinstance(msg[0], str):
            raise RuntimeError(f"decode worker failed:\n{msg[1]}")
        return msg

    # -- the packed route's slice protocol (packed.py) -----------------------
    def attach_arena(self, arena) -> None:
        """Map ``arena``'s ring in the child (its fd goes over the pipe's
        socket); raises when the child cannot."""
        from multiprocessing import reduction
        self._conn.send(("arena",) + arena.buf.shape[:3])
        reduction.send_handle(self._conn, arena.fd, self._proc.pid)
        reply = self.result()
        if reply != "arena_ok":
            raise RuntimeError(f"decode worker did not map the ring: {reply}")

    def request_slice(self, video_nr, a: int, b: int, base: int,
                      want_wav: bool) -> None:
        self._conn.send(("slice", video_nr, int(a), int(b), int(base),
                         bool(want_wav)))

    def slice_result(self):
        """(wav or None, decode_s) of the oldest slice request."""
        return self.result()

    def close(self) -> None:
        try:
            self._conn.send(None)
            self._proc.join(timeout=5)
        except (OSError, ValueError):
            pass
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)
        self._conn.close()


def _test_videos(dataset, mesh=None, max_clips: int | None = None
                 ) -> tuple[np.ndarray, list, list[int]]:
    """(test rows, video db-nrs in order, test clips per video): with
    ``max_clips`` the leading videos until they hold that many clips;
    under a ``mesh`` this rank's share of them (``shard_indices``)."""
    test_idx = np.nonzero(dataset.test_ids)[0]
    nrs = dataset.video_db_nr[test_idx]
    videos = list(np.unique(nrs))
    counts = [int(np.sum(nrs == v)) for v in videos]
    if max_clips is not None:
        k, acc = 0, 0
        while k < len(videos) and acc < max_clips:
            acc += counts[k]
            k += 1
        videos, counts = videos[:k], counts[:k]
    if mesh is not None:
        videos = shard_indices(videos, mesh.rank, mesh.world)
        counts = shard_indices(counts, mesh.rank, mesh.world)
    return test_idx, videos, counts


def sweep_stream(cfg: Config, model: torch.nn.Module, dataset=None,
                 bucket: int | None = None, sweep=None, decode_worker=None,
                 mesh=None, stats: dict | None = None, device=None
                 ) -> Iterator[tuple[np.ndarray, str, np.ndarray]]:
    """Dense-sweep serving pipeline over the test split: yields
    ``(vid_idx, video_id, (N, out_dim) logits)`` per video, in video order;
    under a ``mesh`` (core/mesh.py) this rank's videos only
    (``shard_indices``: video i to rank i mod N).

    Per video, every test frame is decoded once, the trunk runs once per
    frame, and windows are feature gathers on the device (sweep.py); the
    audio is computed on the device from one wav upload, and a sweep that
    takes no audio (``needs_audio`` False: vformer, the single-frame
    models) reads no wav. Video *i+1*
    decodes while the card sweeps video *i*: in ``decode_worker`` (a
    ``DecodeWorker``; one is started, and closed at the end, when None and
    the split holds ``WORKER_MIN_CLIPS`` clips or more), else on a thread
    (``decode_worker=False`` forces the thread).

    Results are fetched in groups of ``FETCH_GROUP_CLIPS`` clips, each
    group ONE concatenated device-to-host copy (``sweep.fetch_many``) on a
    fetch thread, so the copy overlaps later videos' decode and dispatch.
    A CUDA event is recorded on the dispatching stream after each video;
    the fetch thread waits on the group's events and reads the logits on
    that same stream. Yields arrive in bursts, in video order.

    ``stats`` (optional dict) accumulates ``decode_seconds`` (the decoder's
    own clock) / ``wait_seconds`` (the dispatch loop blocked on the next
    decoded video: decode not hidden, plus the worker's pipe transfer) /
    ``sweep_seconds`` (dispatch plus fetch, host clock) / ``clips`` in
    place and holds the ``sweep`` and ``decode_worker`` in use."""
    from .sweep import default_sweep_bucket, make_sweep

    check_mesh(mesh)
    dataset = Aff2TestDataset(cfg) if dataset is None else dataset
    sweep = sweep or make_sweep(cfg, model, device=device)
    bucket = bucket or default_sweep_bucket(sweep.device)
    size = cfg.image_size
    test_idx, videos, counts = _test_videos(dataset, mesh)

    st = stats if stats is not None else {}
    st.setdefault("decode_seconds", 0.0)
    st.setdefault("wait_seconds", 0.0)
    st.setdefault("sweep_seconds", 0.0)
    st.setdefault("clips", 0)
    st["sweep"] = sweep
    on_card = sweep.device.type == "cuda"
    dispatch_stream = torch.cuda.current_stream(sweep.device) if on_card \
        else None

    want_wav = sweep.needs_audio
    worker = decode_worker or None  # False = forced thread
    owns_worker = (worker is None and decode_worker is not False and videos
                   and sum(counts) >= WORKER_MIN_CLIPS)
    if owns_worker:
        worker = DecodeWorker(cfg)
    st["decode_worker"] = worker

    pending: list = []  # (vid_idx, video_id, handle, event)
    pending_clips = 0
    fetch_ex = ThreadPoolExecutor(max_workers=1)
    fetch_futs: list = []
    st_lock = threading.Lock()

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
                outs = sweep.fetch_many([h for _, _, h, _ in group])
            with st_lock:
                st["clips"] += sum(len(vi) for vi, *_ in group)
                st["sweep_seconds"] += time.perf_counter() - td
            return [(vi, vid, o) for (vi, vid, _, _), o in zip(group, outs)]

        fetch_futs.append(fetch_ex.submit(work))

    def _ready():
        while fetch_futs and fetch_futs[0].done():
            yield from fetch_futs.pop(0).result()

    def _dispatch(vid_idx, frames, wav, ts):
        nonlocal pending_clips
        video_id = os.path.dirname(dataset.image_path[vid_idx[0]])
        td = time.perf_counter()
        handle = sweep.dispatch_video(frames, wav=wav, timestamps_ms=ts,
                                      batch=bucket)
        done = None
        if on_card:
            done = torch.cuda.Event()
            done.record(dispatch_stream)
        with st_lock:
            st["sweep_seconds"] += time.perf_counter() - td
        pending.append((vid_idx, video_id, handle, done))
        pending_clips += len(vid_idx)

    def _decoded_videos():
        """One-ahead decode of every video, in the worker process or on a
        thread: the same overlap either way."""
        if worker is not None:
            worker.request(videos[0], want_wav)
            for i in range(len(videos)):
                tw = time.perf_counter()
                vid_idx, frames, wav, ts, dsec = worker.result()
                st["wait_seconds"] += time.perf_counter() - tw
                st["decode_seconds"] += dsec
                if i + 1 < len(videos):
                    worker.request(videos[i + 1], want_wav)
                yield vid_idx, frames, wav, ts
        else:
            def load(video_nr):
                return _load_video(dataset, test_idx, video_nr, size,
                                   want_wav)

            with ThreadPoolExecutor(max_workers=1) as ex:
                nxt = ex.submit(load, videos[0])
                for i in range(len(videos)):
                    tw = time.perf_counter()
                    vid_idx, frames, wav, ts, dsec = nxt.result()
                    st["wait_seconds"] += time.perf_counter() - tw
                    st["decode_seconds"] += dsec
                    if i + 1 < len(videos):
                        nxt = ex.submit(load, videos[i + 1])
                    yield vid_idx, frames, wav, ts

    try:
        if videos:
            for vid_idx, frames, wav, ts in _decoded_videos():
                _dispatch(vid_idx, frames, wav, ts)
                if pending_clips >= FETCH_GROUP_CLIPS:
                    _drain_async()
                yield from _ready()
        _drain_async()
        for f in fetch_futs:
            yield from f.result()
        fetch_futs.clear()
    finally:
        fetch_ex.shutdown(wait=True)
        if owns_worker:
            # a worker the caller passed in is reused across passes
            # (sweep_serve_benchmark); one made here ends here
            worker.close()
            st["decode_worker"] = None


def sweep_serve_benchmark(cfg: Config, model: torch.nn.Module, dataset=None,
                          bucket: int | None = None, sweep=None,
                          decode_worker=None, packed: bool = False,
                          device=None) -> dict:
    """End-to-end decode -> dense-sweep label frames/s through
    :func:`sweep_stream`, or with ``packed`` through
    ``packed.packed_sweep_stream`` (store reads, JPEG decode and wav reads
    included). Returns clip counts and the rate, the stream's ``stats``,
    plus the ``sweep`` and the ``decode_worker`` for reuse across passes
    (a caller that does not reuse the worker closes it).

    It sweeps zeros of the first video's length (and, for a sweep that
    takes audio, of its wav's) before the clock starts (allocator, cuDNN's
    algorithm choice): steady state is what a sweep of a whole test split
    runs at. The worker's start-up, from
    ``WORKER_MIN_CLIPS`` test clips, is also set-up before the clock;
    per-video decode is always inside it."""
    import wave

    from .packed import packed_sweep_stream
    from .sweep import default_sweep_bucket, make_sweep

    dataset = Aff2TestDataset(cfg) if dataset is None else dataset
    sweep = sweep or make_sweep(cfg, model, device=device)
    bucket = bucket or default_sweep_bucket(sweep.device)
    size = cfg.image_size
    test_idx, videos, counts = _test_videos(dataset)

    if videos and sweep.needs_audio:
        n0 = counts[0]
        vid_idx0 = test_idx[dataset.video_db_nr[test_idx] == videos[0]]
        video_id0 = os.path.dirname(dataset.image_path[vid_idx0[0]])
        try:
            with wave.open(os.path.join(
                    dataset.audio_dir,
                    strip_position(video_id0) + ".wav")) as f:
                wav_len = f.getnframes()
        except (OSError, EOFError):
            wav_len = 1
        sweep.sweep_video_device_audio(
            np.zeros((n0, size, size, 3), np.uint8),
            np.zeros(wav_len, np.float32), np.zeros(n0), batch=bucket)
    elif videos:
        sweep.sweep_video(np.zeros((counts[0], size, size, 3), np.uint8),
                          batch=bucket)

    if decode_worker is None and videos \
            and sum(counts) >= WORKER_MIN_CLIPS:
        decode_worker = DecodeWorker(cfg)

    stats: dict = {}
    stream = packed_sweep_stream if packed else sweep_stream
    t0 = time.perf_counter()
    for _ in stream(cfg, model, dataset=dataset, bucket=bucket, sweep=sweep,
                    decode_worker=decode_worker, stats=stats):
        pass
    dt = time.perf_counter() - t0
    return {"clips": stats["clips"], "seconds": dt,
            "decode_seconds": stats["decode_seconds"],
            "wait_seconds": stats["wait_seconds"],
            "sweep_seconds": stats["sweep_seconds"], "sweep": sweep,
            "decode_worker": stats.get("decode_worker"), "stats": stats,
            "clips_per_sec": stats["clips"] / dt if dt > 0 else 0.0}
