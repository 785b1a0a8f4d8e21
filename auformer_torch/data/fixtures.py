"""Synthetic dataset fixtures (counterpart of auformer/data/fixtures.py): a
miniature Aff-Wild2-shaped dataset that exercises the whole store -> decode
-> clip -> audio -> label path. JPEGs are encoded by the native reader's
encoder (data/native: libjpeg or nvJPEG, quality 90, 4:2:0), not cv2.

Creates under a root directory:
  extracted/<video>/00001.jpg...   stub frame listing (for the split builder)
  <video>meta.json                 num_frames / fps / per-task split
  <video>_video_ts.txt             timestamps_v2 file
  <video>.wav                      44.1 kHz mono PCM tone+noise
  video2orignal.pkl                identity mapping
and under a label dir, the five FrameStores with JPEG frames, masks and
AU/EX/VA labels keyed "video/frame.jpg" (create_lmdb.py:20-24 key schema).

Each frame's source image is ``fixture_frame(seed, video, t, size)``, from
a generator of its own, so a check can rebuild it and measure the JPEG
error of a decoded frame.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..ops.audio_host import write_wav
from .dataset import STORE_AU, STORE_EX, STORE_IMAGES, STORE_MASKS, STORE_VA
from .framestore import FrameStoreWriter
from .native import encode_jpeg


@functools.lru_cache(maxsize=4)
def _grid(size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, y, gradient base) of a size x size frame; read-only."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.stack([0.5 + 0.3 * xx, 0.4 + 0.3 * yy,
                     0.45 + 0.2 * (xx + yy) / 2], -1)
    for a in (xx, yy, base):
        a.setflags(write=False)
    return xx, yy, base


def fixture_frame(seed: int, video: int, t: int, size: int) -> np.ndarray:
    """The (size, size, 3) uint8 source image of frame ``t`` of video
    ``video``: a gradient with a moving blob and a little noise (JPEG-
    compressible, face-sized structure)."""
    rs = np.random.RandomState([seed, video, t])
    xx, yy, base = _grid(size)
    cx, cy = 0.5 + 0.2 * np.sin(t * 0.3), 0.5 + 0.2 * np.cos(t * 0.21)
    blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
    img = base + 0.3 * blob[..., None]
    img += rs.standard_normal((size, size, 3)).astype(np.float32) * 0.02
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def generate_synthetic_dataset(root: str, label_dir: str,
                               n_videos: int = 3,
                               frames_per_video: int | Sequence[int] = 80,
                               image_size: int = 112,
                               fps: float = 30.0,
                               seed: int = 0,
                               with_masks: bool = True,
                               audio_secs: float | None = None,
                               splits: list | None = None,
                               n_threads: int = 4) -> dict:
    """Write the fixture. ``frames_per_video`` is one count for every video
    or one per video; each wav lasts ``audio_secs``, or by default its
    video's length + 0.5 s. Frames are made and encoded on ``n_threads``
    threads."""
    rs = np.random.RandomState(seed)
    counts = ([int(frames_per_video)] * n_videos
              if np.isscalar(frames_per_video) else
              [int(c) for c in frames_per_video])
    if len(counts) != n_videos:
        raise ValueError(f"{len(counts)} frame counts for {n_videos} videos")
    os.makedirs(root, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)

    img_w = FrameStoreWriter(os.path.join(label_dir, STORE_IMAGES))
    mask_w = FrameStoreWriter(os.path.join(label_dir, STORE_MASKS))
    au_w = FrameStoreWriter(os.path.join(label_dir, STORE_AU))
    ex_w = FrameStoreWriter(os.path.join(label_dir, STORE_EX))
    va_w = FrameStoreWriter(os.path.join(label_dir, STORE_VA))

    v2o = {}
    splits = splits or ["train", "train", "val", "test"]

    def encode(vi: int, t: int) -> tuple[bytes, bytes | None]:
        img = fixture_frame(seed, vi, t, image_size)
        mask = (encode_jpeg(((img[:, :, 0] > 100) * 255).astype(np.uint8), 95)
                if with_masks else None)
        return encode_jpeg(img, 90), mask

    def write_video(pool, vi: int, n_frames: int) -> None:
        video_id = f"vid{vi:03d}"
        v2o[video_id] = video_id
        frame_dir = os.path.join(root, "extracted", video_id)
        os.makedirs(frame_dir, exist_ok=True)
        split = splits[vi % len(splits)]
        meta = {"num_frames": n_frames, "fps": fps,
                "AU": split, "EX": split, "VA": split}
        with open(os.path.join(root, video_id + "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(root, video_id + "_video_ts.txt"), "w") as f:
            f.write("# timestamp format v2\n")
            for t in range(n_frames):
                f.write(f"{t * 1000.0 / fps:.6f}\n")

        dur = audio_secs or (n_frames / fps + 0.5)
        n = int(dur * 44100)
        tt = np.arange(n, dtype=np.float32) / 44100.0
        wav = (0.3 * np.sin(2 * np.pi * (200 + 40 * vi) * tt)
               + 0.05 * rs.randn(n).astype(np.float32))
        write_wav(os.path.join(root, video_id + ".wav"), wav[None])

        frames = pool.map(lambda t: encode(vi, t), range(n_frames))
        for t, (jpg, mask) in enumerate(frames):
            fname = f"{t + 1:05d}.jpg"
            key = f"{video_id}/{fname}"
            # stub file for the split builder's directory listing
            open(os.path.join(frame_dir, fname), "wb").close()
            img_w.put(key, jpg)
            if with_masks:
                mask_w.put(key, mask)
            # labels: drop some frames to exercise sentinel paths
            if rs.rand() > 0.15:
                au_w.put(key, rs.randint(0, 2, 12).astype(np.int8).tobytes())
            if rs.rand() > 0.15:
                ex_w.put(key, np.array([rs.randint(0, 7)],
                                       np.int8).tobytes())
            if rs.rand() > 0.15:
                va_w.put(key, rs.uniform(-1, 1, 2).astype(np.float32)
                         .tobytes())

    with ThreadPoolExecutor(max(1, n_threads)) as pool:
        for vi, n_frames in enumerate(counts):
            write_video(pool, vi, n_frames)
    for w in (img_w, mask_w, au_w, ex_w, va_w):
        w.close()
    with open(os.path.join(root, "video2orignal.pkl"), "wb") as f:
        pickle.dump(v2o, f)
    return {"n_videos": n_videos, "frames_per_video": counts}


def ensure_synthetic(cfg) -> None:
    """--data_backend synthetic: materialize a fixture dataset under the
    configured paths when absent, so ``python -m auformer_torch.test_aff2
    --data_backend synthetic`` dry-runs the full pipeline without
    Aff-Wild2. The same shape as the JAX package's: 4 videos of
    max(2 * label frame, 48) frames, the last one the test split."""
    marker = os.path.join(cfg.root, "video2orignal.pkl")
    if os.path.isfile(marker):
        return
    n = max(cfg.label_frame * 2, 48)
    generate_synthetic_dataset(
        cfg.root, cfg.lmdb_label_dir, n_videos=4, frames_per_video=n,
        image_size=cfg.image_size, audio_secs=n / 30.0 + 0.5)


def ensure_fixture(cache_dir: str, params: str, generate) -> None:
    """Generate-or-reuse a synthetic fixture directory guarded by a params
    stamp: when the cached fixture under ``cache_dir`` was built with a
    different ``params`` string, wipe it and call ``generate()`` again."""
    marker = os.path.join(cache_dir, "root", "video2orignal.pkl")
    stamp = os.path.join(cache_dir, "fixture_params.txt")
    stale = os.path.isfile(marker)
    if stale and os.path.isfile(stamp):
        with open(stamp) as f:
            stale = f.read().strip() != params
    if stale:
        shutil.rmtree(cache_dir, ignore_errors=True)
    if not os.path.isfile(marker):
        generate()
        os.makedirs(cache_dir, exist_ok=True)
        with open(stamp, "w") as f:
            f.write(params)
