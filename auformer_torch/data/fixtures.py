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
error of a decoded frame. ``write_png`` writes a PNG on the standard
library's ``zlib``, for PNG-aligned frame trees on hosts without cv2.
``write_orbax_checkpoint`` writes a checkpoint as the JAX package's orbax
save does, for hosts without orbax or the JAX package.
"""
from __future__ import annotations

import functools
import json
import os
import pickle
import shutil
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..ops.audio_host import write_wav
from .dataset import STORE_AU, STORE_EX, STORE_IMAGES, STORE_MASKS, STORE_VA
from .framestore import FrameStoreWriter
from .native import crc32c, encode_jpeg


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


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """PNG's Paeth predictor of int arrays (left, above, upper left)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_rows(pix: np.ndarray, filters: Sequence[int]) -> bytes:
    """(H, W, C) uint8 or uint16 samples -> PNG's filtered scanlines, row y
    with filter type ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth)."""
    h, w, c = pix.shape
    raw = (pix.astype(">u2") if pix.dtype == np.uint16 else pix
           ).reshape(h, -1).view(np.uint8).astype(np.int32)
    bpp = c * pix.itemsize
    out = bytearray()
    prior = np.zeros(raw.shape[1], np.int32)
    for y in range(h):
        x = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        kind = filters[y % len(filters)]
        pred = (0, left, prior, (left + prior) >> 1,
                _paeth(left, prior, upleft))[kind]
        out.append(kind)
        out += ((x - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = x
    return bytes(out)


def write_png(path: str, img: np.ndarray, interlace: bool = False,
              filters: Sequence[int] = (0, 1, 2, 3, 4)) -> None:
    """Write a uint8 or uint16 (H, W) grey, (H, W, 2) grey+alpha, (H, W, 3)
    RGB or (H, W, 4) RGBA image as a PNG, its rows through ``filters`` in
    turn (by default all five filter types; PIL's writer picks Paeth for
    most rows of a smooth image, cv2's Sub for every row),
    Adam7-interlaced when ``interlace``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"a PNG holds uint8 or uint16, not {img.dtype}")
    pix = img[..., None] if img.ndim == 2 else img
    h, w, c = pix.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if interlace:
        data = b"".join(
            _filtered_rows(pix[y0::dy, x0::dx], filters)
            for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                                   (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                                   (0, 1, 1, 2))
            if w > x0 and h > y0)
    else:
        data = _filtered_rows(pix, filters)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h,
                                              8 * pix.itemsize, ctype, 0, 0,
                                              int(interlace)))
                + chunk(b"IDAT", zlib.compress(data, 6))
                + chunk(b"IEND", b""))


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _zstd_raw(data: bytes) -> bytes:
    """``data`` as one zstd frame of raw blocks (single segment, its
    content size in 8 bytes, no checksum)."""
    out = [struct.pack("<IBQ", 0xFD2FB528, 0xE0, len(data))]
    step = 128 * 1024
    for i in range(0, max(len(data), 1), step):
        block = data[i:i + step]
        last = i + step >= len(data)
        out += [(len(block) << 3 | int(last)).to_bytes(3, "little"), block]
    return b"".join(out)


def _ocdbt_encode(magic: int, body: bytes) -> bytes:
    """An OCDBT manifest or node: header, zstd body, CRC-32C."""
    payload = _varints((0, 1)) + _zstd_raw(body)
    head = struct.pack(">I", magic) + struct.pack("<Q",
                                                  4 + 8 + len(payload) + 4)
    data = head + payload
    return data + struct.pack("<I", crc32c(data))


_ZARR_DTYPES = {np.dtype(np.float32): "<f4", np.dtype(np.float64): "<f8",
                np.dtype(np.float16): "<f2", np.dtype(np.int32): "<i4",
                np.dtype(np.int64): "<i8", np.dtype(np.uint8): "|u1",
                np.dtype(np.bool_): "|b1"}


def _zarr_leaf(value) -> tuple[str, tuple, bytes]:
    """(zarr dtype, shape, C-order bytes) of a numpy array, a number or a
    torch tensor (bfloat16 kept as its bits)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            return ("bfloat16", tuple(value.shape),
                    value.view(torch.int16).numpy().tobytes())
        value = value.numpy()
    arr = np.asarray(value)               # tobytes() is C order
    if arr.dtype not in _ZARR_DTYPES:
        raise ValueError(f"no zarr dtype for {arr.dtype}")
    return _ZARR_DTYPES[arr.dtype], arr.shape, arr.tobytes()


def _leaves(tree: Mapping[str, Any], path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def write_orbax_checkpoint(path: str, tree: Mapping[str, Any]) -> int:
    """Write the nested dict ``tree`` at the directory ``path`` as the JAX
    package's ``save_checkpoint`` does through orbax: ``_METADATA``,
    ``_CHECKPOINT_METADATA``, and each leaf as a zarr v2 array of one chunk
    (zstd frames of raw blocks) in an OCDBT database of one version, one
    b+tree leaf and one data file (values over 1024 bytes in it, the leaf
    after them). Returns the bytes written."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(os.path.join(path, "d"))
    values: dict[bytes, bytes] = {}
    tree_meta = {}
    for keys, leaf in _leaves(tree):
        dtype, shape, data = _zarr_leaf(leaf)
        name = ".".join(keys)
        zarray = {"chunks": [max(d, 1) for d in shape],
                  "compressor": {"id": "zstd", "level": 1},
                  "dimension_separator": ".", "dtype": dtype,
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": list(shape), "zarr_format": 2}
        values[f"{name}/.zarray".encode()] = json.dumps(
            zarray, sort_keys=True, separators=(",", ":")).encode()
        if all(shape):                  # an empty array stores no chunk
            chunk = ".".join("0" for _ in shape) or "0"
            values[f"{name}/{chunk}".encode()] = _zstd_raw(data)
        tree_meta[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    data_file = f"d/{os.urandom(16).hex()}"
    keys = sorted(values)
    indirect_bytes = 0
    lengths, kinds, offsets, inline = [], [], [], []
    with open(os.path.join(path, data_file), "wb") as f:
        for k in keys:
            v = values[k]
            lengths.append(len(v))
            if len(v) > 1024:
                kinds.append(1)
                offsets.append(indirect_bytes)
                f.write(v)
                indirect_bytes += len(v)
            else:
                kinds.append(0)
                inline.append(v)
        prefix, prev = [], b""
        for k in keys:
            n = 0
            while n < min(len(k), len(prev)) and k[n] == prev[n]:
                n += 1
            prefix.append(n)
            prev = k
        files = _varints((1, len(data_file), 0)) + data_file.encode()
        leaf = (bytes([0]) + files + _varint(len(keys))
                + _varints(prefix[1:])
                + _varints(len(k) - p for k, p in zip(keys, prefix))
                + b"".join(k[p:] for k, p in zip(keys, prefix))
                + _varints(lengths) + bytes(kinds)
                + _varints([0] * len(offsets)) + _varints(offsets)
                + b"".join(inline))
        node = _ocdbt_encode(0x0CDB20DE, leaf)
        f.write(node)
    config = (os.urandom(16) + _varints((0, 1024, 100_000_000)) + bytes([4])
              + _varint(1) + struct.pack("<i", 0))
    version = (_varints((1, 1)) + bytes([0]) + _varints((0,))
               + _varints((indirect_bytes, len(node), len(keys), len(node),
                           indirect_bytes))
               + struct.pack("<Q", time.time_ns()) + _varint(0))
    manifest = _ocdbt_encode(0x0CDB3A2A, config + files + version)
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(manifest)
    meta = {"tree_metadata": tree_meta, "use_ocdbt": True,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    now = time.time_ns()
    ckpt_meta = {"item_handlers": "orbax.checkpoint._src.handlers."
                 "standard_checkpoint_handler.StandardCheckpointHandler",
                 "metrics": {}, "performance_metrics": {},
                 "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
                 "custom_metadata": {}}
    for name, obj in (("_METADATA", meta),
                      ("_CHECKPOINT_METADATA", ckpt_meta)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f)
    return (indirect_bytes + len(node) + len(manifest)
            + sum(os.path.getsize(os.path.join(path, n))
                  for n in ("_METADATA", "_CHECKPOINT_METADATA")))


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
