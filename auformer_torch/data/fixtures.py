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
save does, for hosts without orbax or the JAX package. ``write_h264``
writes H.264 streams whose decoded YUV is known exactly (I_PCM, P_Skip and
B_Skip macroblocks, deblocking off) in MP4 or AVI, and ``write_mjpeg_avi``
an MJPEG AVI, for hosts without an encoder. ``write_mpegts``,
``write_mpegps`` and ``write_asf`` put given access units into an MPEG
transport stream (PES packets off the unit boundaries, PTS past 2^33, the
M2TS form), a program stream and an ASF file (several payloads to a
packet, no index, the broadcast flag): what libavformat does not write.
"""
from __future__ import annotations

import bisect
import functools
import json
import os
import pickle
import re
import shutil
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction
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


# -- H.264 streams of I_PCM, P_Skip and B_Skip macroblocks --------------------
#
# Every macroblock of an IDR picture is I_PCM (its samples stored raw), a P
# picture is P_Skip but for a band of I_PCM columns, and a B picture is all
# B_Skip (spatial direct: zero motion, the rounded mean of the two nearest
# references). Deblocking is off. So the decoded YUV of every frame is known
# exactly, and every conforming decoder must give it: cv2's ffmpeg and NVDEC
# alike.

class _Bits:
    """An RBSP written MSB first: headers bit by bit, PCM bytes whole."""

    def __init__(self):
        self.chunks: list[bytes] = []
        self.acc, self.n = 0, 0

    def u(self, n: int, v: int) -> None:
        self.acc, self.n = (self.acc << n) | v, self.n + n
        if self.n >= 64:
            self._flush(self.n - self.n % 8)

    def _flush(self, bits: int) -> None:
        keep = self.n - bits
        self.chunks.append((self.acc >> keep).to_bytes(bits // 8, "big"))
        self.acc &= (1 << keep) - 1
        self.n = keep

    def ue(self, v: int) -> None:
        v += 1
        self.u(2 * v.bit_length() - 1, v)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align(self) -> None:
        self.u(-self.n % 8, 0)

    def raw(self, data: bytes) -> None:
        """Bytes at a byte boundary (pcm samples after their alignment)."""
        self._flush(self.n)
        self.chunks.append(data)

    def trailing(self) -> bytes:
        """The RBSP with its stop bit and alignment."""
        self.u(1, 1)
        self.align()
        self._flush(self.n)
        return b"".join(self.chunks)


_EMULATION = re.compile(b"\x00\x00(?=[\x00-\x03])")


def _nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    """A NAL unit: its header byte and the RBSP with emulation prevention."""
    return bytes([ref_idc << 5 | kind]) + _EMULATION.sub(b"\x00\x00\x03",
                                                         rbsp)


def h264_source_yuv(seed: int, t: int, height: int, width: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Y, U, V) uint8 planes of frame ``t`` (4:2:0): smooth gradients, a
    moving disc and a little noise, clipped to 0-255."""
    rs = np.random.RandomState([seed, t, height, width])
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    cx = width * (0.5 + 0.3 * np.sin(0.2 * t))
    cy = height * (0.5 + 0.3 * np.cos(0.13 * t))
    disc = ((xx - cx) ** 2 + (yy - cy) ** 2) < (min(height, width) / 5) ** 2
    y = 16 + 200 * (xx + yy) / (width + height) + 30 * disc
    y += rs.standard_normal(y.shape) * 6
    cy_, cx_ = yy[::2, ::2], xx[::2, ::2]
    u = 128 + 100 * np.sin(cx_ / width * 6.3 + 0.1 * t)
    v = 128 + 100 * np.cos(cy_ / height * 6.3 - 0.1 * t) - 40 * disc[::2, ::2]
    return tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                 for p in (y, u, v))


def h264_gop_order(n_frames: int, gop: int, b_frames: int
                   ) -> list[tuple[int, str]]:
    """(display index, ``"I"``/``"P"``/``"B"``) of each picture in decode
    order: an IDR every ``gop`` frames, then anchors every ``b_frames + 1``
    frames (the GOP's last frame always one), each followed by the B
    pictures before it. GOPs are closed."""
    out = []
    for g0 in range(0, n_frames, gop):
        g1 = min(g0 + gop, n_frames)
        out.append((g0, "I"))
        prev = g0
        anchors = list(range(g0 + b_frames + 1, g1, b_frames + 1))
        if g1 - 1 > g0 and (not anchors or anchors[-1] != g1 - 1):
            anchors.append(g1 - 1)
        for a in anchors:
            out.append((a, "P"))
            out += [(d, "B") for d in range(prev + 1, a)]
            prev = a
    return out


def _h264_sps(width: int, height: int, b_frames: int, chroma: int = 1,
              bypass: bool = False, colour: tuple | None = None,
              depth: int | tuple = 8, chroma_loc: int | None = None
              ) -> bytes:
    """The SPS: Baseline (Main with B slices) for 8-bit 4:2:0, else High
    4:4:4 Predictive with chroma_format_idc ``chroma``,
    qpprime_y_zero_transform_bypass_flag ``bypass`` and the bit depth
    ``depth`` (luma and chroma, or a (luma, chroma) pair); ``colour``
    (matrix, full_range) writes them in the VUI's video_signal_type,
    ``chroma_loc`` the VUI's chroma_sample_loc_type (both fields)."""
    w = _Bits()
    luma_depth, chroma_depth = depth if isinstance(depth, tuple) else (
        depth, depth)
    high = chroma != 1 or bypass or (luma_depth, chroma_depth) != (8, 8)
    w.u(8, 244 if high else 77 if b_frames else 66)   # profile_idc
    w.u(8, 0 if high else 0x40 if b_frames else 0xC0)  # constraint_set flags
    w.u(8, 40)                            # level_idc 4.0
    w.ue(0)                               # seq_parameter_set_id
    if high:
        w.ue(chroma)                      # chroma_format_idc
        if chroma == 3:
            w.u(1, 0)                     # separate_colour_plane_flag
        w.ue(luma_depth - 8)              # bit_depth_luma_minus8
        w.ue(chroma_depth - 8)            # bit_depth_chroma_minus8
        w.u(1, int(bypass))               # qpprime_y_zero_transform_bypass
        w.u(1, 0)                         # seq_scaling_matrix_present_flag
    w.ue(4)                               # log2_max_frame_num_minus4
    w.ue(0)                               # pic_order_cnt_type
    w.ue(4)                               # log2_max_pic_order_cnt_lsb_minus4
    w.ue(2 if b_frames else 1)            # max_num_ref_frames
    w.u(1, 0)                             # gaps_in_frame_num_allowed
    mbw, mbh = -(-width // 16), -(-height // 16)
    w.ue(mbw - 1)
    w.ue(mbh - 1)
    w.u(1, 1)                             # frame_mbs_only_flag
    w.u(1, 1)                             # direct_8x8_inference_flag
    crop = (mbw * 16 - width, mbh * 16 - height)
    unit = (2 if chroma in (1, 2) else 1, 2 if chroma == 1 else 1)  # CropUnit
    w.u(1, int(any(crop)))
    if any(crop):
        for c in (0, crop[0] // unit[0], 0, crop[1] // unit[1]):
            w.ue(c)
    w.u(1, 1)                             # vui_parameters_present_flag
    w.u(2, 0)                             # aspect ratio, overscan
    w.u(1, colour is not None)            # video_signal_type_present_flag
    if colour is not None:
        w.u(3, 5)                         # video_format: unspecified
        w.u(1, int(colour[1]))            # video_full_range_flag
        w.u(1, 1)                         # colour_description_present_flag
        w.u(8, 2)                         # colour_primaries: unspecified
        w.u(8, 2)                         # transfer_characteristics
        w.u(8, int(colour[0]))            # matrix_coefficients
    w.u(1, chroma_loc is not None)        # chroma_loc_info_present_flag
    if chroma_loc is not None:
        w.ue(chroma_loc)
        w.ue(chroma_loc)
    w.u(1, 0)                             # timing
    w.u(3, 0)   # nal hrd, vcl hrd, pic_struct_present
    w.u(1, 1)                             # bitstream_restriction_flag
    w.u(1, 1)                             # motion_vectors_over_pic_boundaries
    w.ue(0)
    w.ue(0)
    w.ue(16)
    w.ue(16)
    w.ue(b_frames)                        # max_num_reorder_frames
    w.ue(2 if b_frames else 1)            # max_dec_frame_buffering
    return _nal(3, 7, w.trailing())


def _h264_pps() -> bytes:
    w = _Bits()
    w.ue(0)                               # pic_parameter_set_id
    w.ue(0)                               # seq_parameter_set_id
    w.u(1, 0)                             # entropy_coding_mode_flag: CAVLC
    w.u(1, 0)                             # bottom_field_pic_order_in_frame
    w.ue(0)                               # num_slice_groups_minus1
    w.ue(0)                               # num_ref_idx_l0_default_minus1
    w.ue(0)                               # num_ref_idx_l1_default_minus1
    w.u(1, 0)                             # weighted_pred_flag
    w.u(2, 0)                             # weighted_bipred_idc
    w.se(0)                               # pic_init_qp_minus26
    w.se(0)                               # pic_init_qs_minus26
    w.se(0)                               # chroma_qp_index_offset
    w.u(1, 1)                             # deblocking_filter_control_present
    w.u(1, 0)                             # constrained_intra_pred_flag
    w.u(1, 0)                             # redundant_pic_cnt_present_flag
    return _nal(3, 8, w.trailing())


# a macroblock's chroma samples (MbHeightC, MbWidthC) by chroma_format_idc
_MB_CHROMA = {0: (0, 0), 1: (8, 8), 2: (16, 8), 3: (16, 16)}


def _mb_pcm(y: np.ndarray, u: np.ndarray, v: np.ndarray, chroma: int = 1
            ) -> np.ndarray:
    """(rows, cols, n) of the planes' type (uint8, or uint16 for samples
    deeper than 8 bits): each macroblock's pcm samples (256 luma, then Cb
    and Cr of chroma_format_idc ``chroma``: 64 each for 4:2:0, 128 for
    4:2:2, 256 for 4:4:4, none for monochrome; each in raster order) of
    planes padded to whole MBs."""
    mbh, mbw = -(-y.shape[0] // 16), -(-y.shape[1] // 16)

    def blocks(p, nh, nw):
        p = np.pad(p, ((0, mbh * nh - p.shape[0]), (0, mbw * nw - p.shape[1])),
                   mode="edge")
        return p.reshape(mbh, nh, mbw, nw).transpose(0, 2, 1, 3).reshape(
            mbh, mbw, nh * nw)

    ch, cw = _MB_CHROMA[chroma]
    planes = [blocks(y, 16, 16)]
    if chroma:
        planes += [blocks(u, ch, cw), blocks(v, ch, cw)]
    return np.concatenate(planes, -1)


def _pcm_bytes(samples: np.ndarray, depth: int) -> bytes:
    """pcm_sample_luma and pcm_sample_chroma: each sample in ``depth``
    bits, MSB first (a whole number of bytes for a macroblock)."""
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    bits = (samples.astype(np.uint16)[:, None] >> np.arange(depth - 1, -1,
                                                            -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()


def _h264_slice(kind: str, frame_num: int, poc: int, idr_id: int,
                pcm: np.ndarray, coded: np.ndarray, qp: int | None = None,
                depth: int = 8) -> bytes:
    """One slice of a whole picture: ``coded`` (rows, cols) bool marks the
    I_PCM macroblocks (all of them in an I slice; samples of ``depth``
    bits), the rest are skipped; at QP 26 without the deblocking filter,
    or with it at slice QP ``qp``."""
    w = _Bits()
    w.ue(0)                                        # first_mb_in_slice
    w.ue({"P": 5, "B": 6, "I": 7}[kind])           # slice_type
    w.ue(0)                                        # pic_parameter_set_id
    w.u(8, frame_num % 256)
    if kind == "I":
        w.ue(idr_id)
    w.u(8, poc % 256)                              # pic_order_cnt_lsb
    if kind == "B":
        w.u(1, 1)                                  # direct_spatial_mv_pred
    if kind != "I":
        w.u(1, 0)                                  # num_ref_idx_override
        w.u(1, 0)                                  # ref_pic_list_mod_l0
    if kind == "B":
        w.u(1, 0)                                  # ref_pic_list_mod_l1
    if kind == "I":
        w.u(2, 0)     # no_output_of_prior_pics, long_term_reference_flag
    elif kind == "P":
        w.u(1, 0)                                  # adaptive_ref_pic_marking
    w.se(0 if qp is None else qp - 26)             # slice_qp_delta
    w.ue(1 if qp is None else 0)                   # disable_deblocking_idc
    if qp is not None:
        w.se(0)                                    # slice_alpha_c0_offset
        w.se(0)                                    # slice_beta_offset
    flat = pcm.reshape(-1, pcm.shape[-1])
    pcm_type = {"I": 25, "P": 30, "B": 48}[kind]
    prev = -1
    for addr in np.flatnonzero(coded.reshape(-1)).tolist():
        if kind != "I":
            w.ue(addr - prev - 1)                  # mb_skip_run
        w.ue(pcm_type)                             # mb_type I_PCM
        w.align()                                  # pcm_alignment_zero_bit
        w.raw(_pcm_bytes(flat[addr], depth))
        prev = addr
    if kind != "I" and prev < coded.size - 1:
        w.ue(coded.size - 1 - prev)                # the trailing skip run
    return w.trailing()


def h264_access_units(width: int, height: int, n_frames: int, gop: int = 30,
                      b_frames: int = 0, band: int = 1, seed: int = 0,
                      source=None, chroma: int = 1, bypass: bool = False,
                      colour: tuple | None = None, qp: int | None = None,
                      depth: int | tuple = 8, chroma_loc: int | None = None):
    """Yield ``(display index, kind, NAL units)`` of each picture in decode
    order (``h264_gop_order``): IDR pictures all I_PCM, P pictures P_Skip
    but ``band`` I_PCM macroblock columns that move two columns a frame, B
    pictures all B_Skip. ``source(t)`` gives frame t's (Y, U, V) planes in
    chroma_format_idc ``chroma`` (default ``h264_source_yuv(seed, t, height,
    width)``, 4:2:0, its chroma repeated for 4:2:2 and 4:4:4, shifted up
    to the luma's ``depth``); ``bypass``, ``colour``, ``qp``, ``depth``
    (the bit depth, or a (luma, chroma) pair; the samples are written at
    the luma's) and ``chroma_loc`` as ``_h264_sps`` and ``_h264_slice``
    take them. The NAL
    units are without start codes, each IDR's led by the SPS and PPS."""
    if (chroma == 1 and (width % 2 or height % 2)) or (chroma == 2
                                                       and width % 2):
        raise ValueError(f"chroma_format_idc {chroma} does not fit "
                         f"{width}x{height}")

    bits = depth[0] if isinstance(depth, tuple) else depth

    def default(t):
        y, u, v = h264_source_yuv(seed, t, height, width)
        if chroma in (2, 3):    # 4:2:0's chroma repeated to fit the format
            u, v = (p.repeat(2, 0)[:height] for p in (u, v))
        if chroma == 3:
            u, v = (p.repeat(2, 1)[:, :width] for p in (u, v))
        if bits > 8:
            y, u, v = (p.astype(np.uint16) << (bits - 8) for p in (y, u, v))
        return y, u, v

    source = source or default
    mbh, mbw = -(-height // 16), -(-width // 16)
    sps = _h264_sps(width, height, b_frames, chroma, bypass, colour, depth,
                    chroma_loc)
    pps = _h264_pps()
    refs = idr = 0
    for t, kind in h264_gop_order(n_frames, gop, b_frames):
        pcm = _mb_pcm(*source(t), chroma=chroma)
        coded = np.ones((mbh, mbw), bool)
        if kind == "I":
            refs, g0 = 0, t
        else:
            coded[:] = False
            if kind == "P":
                coded[:, [(2 * t + j) % mbw for j in range(band)]] = True
        rbsp = _h264_slice(kind, refs, 2 * (t - g0), idr, pcm, coded, qp,
                           bits)
        nal = _nal({"I": 3, "P": 2, "B": 0}[kind], 5 if kind == "I" else 1,
                   rbsp)
        yield t, kind, ([sps, pps, nal] if kind == "I" else [nal])
        if kind == "I":
            idr = (idr + 1) % 16
        if kind != "B":
            refs += 1


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _esds(info: bytes) -> bytes:
    """An ``esds`` box for MPEG-4 part 2 whose DecoderSpecificInfo is
    ``info`` (the VOS, VO and VOL headers)."""
    def desc(tag: int, body: bytes) -> bytes:
        n = len(body)
        return bytes([tag, 0x80 | n >> 21 & 0x7F, 0x80 | n >> 14 & 0x7F,
                      0x80 | n >> 7 & 0x7F, n & 0x7F]) + body
    config = desc(0x04, bytes([0x20, 0x11]) + bytes(3)
                  + struct.pack(">II", 0, 0) + desc(0x05, info))
    return _full_box(b"esds", 0, 0, desc(0x03, struct.pack(">HB", 1, 0)
                                         + config + desc(0x06, b"\x02")))


def _mp4(samples: list[bytes], sync: list[bool], offsets: list[int],
         delta: int, scale: int, width: int, height: int, config: bytes,
         shift: int, kind: bytes = b"avc1") -> bytes:
    """An MP4 of one video track, one sample per chunk, ``moov`` after
    ``mdat``; a ``ctts`` box and an edit list from the first presentation
    time where ``offsets`` (composition offsets in ticks) are not all 0.
    ``kind`` is the sample entry: ``avc1`` with ``config`` as its
    ``avcC``, or ``mp4v`` with ``config`` as its ``esds``
    DecoderSpecificInfo."""
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512),
                b"isomiso2avc1mp41")
    mdat = _box(b"mdat", *samples)
    n, dur = len(samples), len(samples) * delta
    chunk, stco = len(ftyp) + 8, []
    for s in samples:
        stco.append(chunk)
        chunk += len(s)
    runs: list[list[int]] = []
    for o in offsets:
        if runs and runs[-1][1] == o:
            runs[-1][0] += 1
        else:
            runs.append([1, o])
    stbl = [
        _full_box(b"stsd", 0, 0, struct.pack(">I", 1), _box(
            kind, bytes(6), struct.pack(">H", 1), bytes(16),
            struct.pack(">HHIII", width, height, 0x480000, 0x480000, 0),
            struct.pack(">H", 1), bytes(32), struct.pack(">Hh", 24, -1),
            _box(b"avcC", config) if kind == b"avc1" else _esds(config))),
        _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))]
    if any(offsets):
        stbl.append(_full_box(b"ctts", 0, 0, struct.pack(">I", len(runs)),
                              *[struct.pack(">II", c, o) for c, o in runs]))
    stbl += [
        _full_box(b"stss", 0, 0, struct.pack(">I", sum(sync)),
                  *[struct.pack(">I", k + 1) for k, s in enumerate(sync)
                    if s]),
        _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
        _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                  *[struct.pack(">I", len(s)) for s in samples]),
        _full_box(b"stco", 0, 0, struct.pack(f">{n + 1}I", n, *stco))]
    trak = [_full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, dur),
                      bytes(8), struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                      struct.pack(">II", width << 16, height << 16))]
    if shift:
        trak.append(_box(b"edts", _full_box(
            b"elst", 0, 0, struct.pack(">IIihH", 1, dur, shift, 1, 0))))
    trak.append(_box(b"mdia", _full_box(
        b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, scale, dur, 0x55C4, 0)),
        _full_box(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide"), bytes(12),
                  b"VideoHandler\x00"),
        _box(b"minf", _full_box(b"vmhd", 0, 1, bytes(8)),
             _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                     _full_box(b"url ", 0, 1))),
             _box(b"stbl", *stbl))))
    moov = _box(b"moov", _full_box(
        b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, scale, dur, 0x10000,
                                   0x100), bytes(10), _MATRIX, bytes(24),
        struct.pack(">I", 2)), _box(b"trak", *trak))
    return ftyp + mdat + moov


def write_mjpeg_avi(path: str, jpegs: Sequence[bytes], width: int,
                    height: int, fps: float = 30.0) -> None:
    """Write JPEG frames as an MJPEG AVI (``00dc`` chunks, an ``idx1`` with
    every frame a key frame)."""
    delta, scale = _frame_rate(fps)
    with open(path, "wb") as f:
        f.write(_avi(list(jpegs), [True] * len(jpegs), b"MJPG", delta, scale,
                     width, height))


def _avi(frames: list[bytes], sync: list[bool], fourcc: bytes, delta: int,
         scale: int, width: int, height: int) -> bytes:
    """An AVI of one video stream (``00dc`` chunks and an ``idx1`` with
    each key frame's AVIIF_KEYFRAME flag)."""
    n, big = len(frames), max(len(f) for f in frames)
    avih = struct.pack("<14I", round(1e6 * delta / scale), 0, 0, 0x10, n, 0,
                       1, big, width, height, 0, 0, 0, 0)
    strh = (b"vids" + fourcc + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0,
                                           delta, scale, 0, n, big, -1, 0)
            + struct.pack("<4h", 0, 0, width, height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0)

    def chunk(cc: bytes, body: bytes) -> bytes:
        return cc + struct.pack("<I", len(body)) + body + bytes(len(body) & 1)

    def lst(kind: bytes, body: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body

    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, idx, off = [], [], 4
    for f, key in zip(frames, sync):
        idx.append(struct.pack("<4sIII", b"00dc", 0x10 if key else 0, off,
                               len(f)))
        movi.append(chunk(b"00dc", f))
        off += len(movi[-1])
    body = (b"AVI " + hdrl + lst(b"movi", b"".join(movi))
            + chunk(b"idx1", b"".join(idx)))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _frame_rate(fps: float) -> tuple[int, int]:
    """(ticks per frame, ticks per second): 512 ticks a frame at a whole
    rate, else the rate as a fraction (30000/1001)."""
    r = Fraction(fps).limit_denominator(1001)
    return (512, 512 * r.numerator) if r.denominator == 1 else (
        r.denominator, r.numerator)


def write_h264(path: str, width: int, height: int, n_frames: int,
               fps: float = 30.0, gop: int = 30, b_frames: int = 0,
               band: int = 1, seed: int = 0, source=None, **header
               ) -> list[tuple[int, str]]:
    """Write the stream of ``h264_access_units`` to ``path``: an MP4/MOV
    (``avcC`` with the SPS and PPS, 4-byte NAL lengths, ``stts``, ``stss``,
    and ``ctts`` plus an edit list from the first presentation time where
    there are B pictures) or an AVI (``H264`` chunks in Annex B, the SPS
    and PPS ahead of each IDR, ``idx1`` key flags; no B pictures). Returns
    (display index, kind) of each sample in decode order. ``header``:
    ``h264_access_units``' chroma, bypass, colour, qp, depth and
    chroma_loc."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".mp4", ".mov", ".avi"):
        raise ValueError(f"write_h264 writes .mp4, .mov or .avi, not {ext}")
    if ext == ".avi" and b_frames:
        raise ValueError("an AVI carries no presentation times: no B frames")
    delta, scale = _frame_rate(fps)
    order, samples, sync, sps_pps = [], [], [], None
    for t, kind, nals in h264_access_units(width, height, n_frames, gop,
                                           b_frames, band, seed, source,
                                           **header):
        order.append((t, kind))
        sync.append(kind == "I")
        if ext == ".avi":
            samples.append(b"".join(b"\x00\x00\x00\x01" + n for n in nals))
        else:
            if kind == "I" and sps_pps is None:
                sps_pps = nals[:2]
            samples.append(struct.pack(">I", len(nals[-1])) + nals[-1])
    with open(path, "wb") as f:
        if ext == ".avi":
            f.write(_avi(samples, sync, b"H264", delta, scale, width, height))
            return order
        sps, pps = sps_pps
        avcc = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
                + struct.pack(">H", len(sps)) + sps + b"\x01"
                + struct.pack(">H", len(pps)) + pps)
        shift = max(0, max(k - t for k, (t, _) in enumerate(order)))
        offsets = [(t + shift - k) * delta for k, (t, _) in enumerate(order)]
        f.write(_mp4(samples, sync, offsets, delta, scale, width, height,
                     avcc, shift * delta))
    return order



# ---- MPEG-4 part 2 (write_mpeg4) -------------------------------------------
#
# An encoder of the tools the port's decoder reads (data/native/
# mpeg4_decode.cpp) and cv2's writer does not use: B-VOPs, 4MV, AC
# prediction, DQUANT, intra macroblocks in P-VOPs, not-coded macroblocks,
# MPEG quantisation with loaded matrices, video packets with header
# extension, and VOPs with vop_coded 0. It is open loop: each residual is
# taken against the source frame at the whole-pel part of the chosen
# vector, not against the decoded one, so the decoded frames drift from the
# source; what they are is what any conforming decoder makes of the stream
# (cv2 judges it in the tests). The header VLCs (MCBPC, CBPY, MVD, DC size,
# MODB, MB_TYPE) are the standard's; every coefficient is coded with the
# third escape (fixed length), so no TCOEF table is shared with the decoder.

_M4_INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6),
                   (3, 6)]
# P-VOP MCBPC by (type, cbpc): types inter, intra, inter+q, intra+q, 4MV
_M4_INTER_MCBPC = [(1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8),
                   (3, 7), (3, 3), (7, 7), (6, 7), (5, 9), (4, 6), (4, 9),
                   (3, 9), (2, 9), (2, 3), (5, 7), (4, 7), (5, 8)]
_M4_CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
            (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]
_M4_MVD = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
           (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10),
           (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10),
           (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11),
           (4, 11), (3, 11), (2, 11), (3, 12), (2, 12)]
_M4_DC_LUMA = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5),
               (1, 6), (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)]
_M4_DC_CHROMA = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6),
                 (1, 7), (1, 8), (1, 9), (1, 10), (1, 11), (1, 12)]
_M4_Y_DC = [0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24,
            25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46]
_M4_C_DC = [0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15,
            15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25]
_M4_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
_M4_ALT_HORIZONTAL = np.array([
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12, 19, 18, 24,
    25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48,
    49, 42, 43, 36, 37, 38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52,
    53, 54, 55, 60, 61, 62, 63])
# the alternate vertical scan is the horizontal one transposed
_M4_ALT_VERTICAL = (_M4_ALT_HORIZONTAL % 8) * 8 + _M4_ALT_HORIZONTAL // 8
# loaded matrices of the MPEG-quantised fixtures (raster order); the intra
# one is sent with an early 0, so its last 24 zigzag entries repeat
_M4_INTRA_MATRIX = np.minimum(8 + 3 * (np.arange(64) // 8 + np.arange(64)
                                       % 8), 60)
_M4_INTRA_MATRIX[_M4_ZIGZAG[40:]] = _M4_INTRA_MATRIX[_M4_ZIGZAG[39]]
_M4_INTER_MATRIX = 16 + (np.arange(64) * 7) % 13
_M4_DCT = np.array([[np.sqrt((1 if k else 0.5) / 4) * np.cos(
    (2 * n + 1) * k * np.pi / 16) for n in range(8)] for k in range(8)])
_QUANT_TAB = {-1: 0, -2: 1, 1: 2, 2: 3}


class _BitList:
    """Codes MSB first, packed into bytes at the end with numpy."""

    def __init__(self):
        self.codes: list[int] = []
        self.lens: list[int] = []
        self.n = 0

    def put(self, v: int, n: int) -> None:
        if n:
            self.codes.append(v)
            self.lens.append(n)
            self.n += n

    def stuff(self) -> None:
        """Stuffing to the byte boundary: a 0, then 1s (a whole 0x7F byte
        when already aligned)."""
        k = 8 - self.n % 8
        self.put((1 << (k - 1)) - 1, k)

    def tobytes(self) -> bytes:
        lens = np.array(self.lens, np.int64)
        starts = np.repeat(np.cumsum(lens) - lens, lens)
        shift = (np.repeat(lens, lens) - 1 - (np.arange(int(lens.sum()))
                                               - starts)).astype(np.uint64)
        bits = (np.repeat(np.array(self.codes, np.uint64), lens) >> shift) \
            & np.uint64(1)
        return np.packbits(bits.astype(np.uint8)).tobytes()


def _m4_mvd(out: _BitList, diff: int, f_code: int) -> None:
    """A motion vector difference (half-pel) in the f_code range."""
    half = 16 << f_code
    diff = (diff + half) % (2 * half) - half
    if diff == 0:
        out.put(1, 1)
        return
    a, f = abs(diff), f_code - 1
    code, res = ((a - 1) >> f) + 1, (a - 1) & ((1 << f) - 1)
    out.put(*_M4_MVD[code])
    out.put(diff < 0, 1)
    out.put(res, f)


def _m4_headers(width: int, height: int, res: int, low_delay: bool,
                mpeg_quant: bool, resync: bool,
                colour: tuple[int, int] | None = None) -> bytes:
    """VOS, visual object, VO and VOL headers; with ``colour``,
    (matrix_coefficients, video_range), the visual object carries a
    video_signal_type of that range and a colour description of that
    matrix (BT.709 primaries and transfer)."""
    w = _BitList()
    w.put(0x000001B0, 32)
    w.put(0xF5, 8)                          # Advanced Simple profile
    w.put(0x000001B5, 32)
    w.put(0, 1)                             # is_visual_object_identifier
    w.put(1, 4)                             # visual_object_type: video
    w.put(int(colour is not None), 1)       # video_signal_type
    if colour is not None:
        w.put(5, 3)                         # video_format: unspecified
        w.put(colour[1], 1)                 # video_range
        w.put(1, 1)                         # colour_description
        w.put(1, 8)                         # colour_primaries
        w.put(1, 8)                         # transfer_characteristics
        w.put(colour[0], 8)                 # matrix_coefficients
    w.stuff()
    w.put(0x00000100, 32)                   # video_object_start_code
    w.put(0x00000120, 32)                   # video_object_layer_start_code
    w.put(0, 1)                             # random_accessible_vol
    w.put(17, 8)                            # Advanced Simple
    w.put(1, 1)                             # is_object_layer_identifier
    w.put(2, 4)                             # video_object_layer_verid
    w.put(1, 3)                             # priority
    w.put(1, 4)                             # aspect_ratio_info: square
    w.put(1, 1)                             # vol_control_parameters
    w.put(1, 2)                             # chroma_format 4:2:0
    w.put(int(low_delay), 1)
    w.put(0, 1)                             # vbv_parameters
    w.put(0, 2)                             # rectangular
    w.put(1, 1)
    w.put(res, 16)                          # vop_time_increment_resolution
    w.put(1, 1)
    w.put(0, 1)                             # fixed_vop_rate
    w.put(1, 1)
    w.put(width, 13)
    w.put(1, 1)
    w.put(height, 13)
    w.put(1, 1)
    w.put(0, 1)                             # interlaced
    w.put(1, 1)                             # obmc_disable
    w.put(0, 2)                             # sprite_enable
    w.put(0, 1)                             # not_8_bit
    w.put(int(mpeg_quant), 1)
    if mpeg_quant:
        w.put(1, 1)                         # load_intra_quant_mat
        for k in range(40):
            w.put(int(_M4_INTRA_MATRIX[_M4_ZIGZAG[k]]), 8)
        w.put(0, 8)                         # the rest repeat the last
        w.put(1, 1)                         # load_nonintra_quant_mat
        for k in range(64):
            w.put(int(_M4_INTER_MATRIX[_M4_ZIGZAG[k]]), 8)
    w.put(0, 1)                             # quarter_sample
    w.put(1, 1)                             # complexity_estimation_disable
    w.put(int(not resync), 1)               # resync_marker_disable
    w.put(0, 1)                             # data_partitioned
    w.put(0, 1)                             # newpred_enable
    w.put(0, 1)                             # reduced_resolution_vop_enable
    w.put(0, 1)                             # scalability
    w.stuff()
    return w.tobytes()


def _m4_planes(planes, mb_h: int, mb_w: int) -> list[np.ndarray]:
    """Y, U, V padded by edge replication to whole macroblocks, int32."""
    return [np.pad(p, ((0, mb_h * n - p.shape[0]), (0, mb_w * n
                                                    - p.shape[1])),
                   mode="edge").astype(np.int32)
            for p, n in zip(planes, (16, 8, 8))]


def _m4_blocks(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(mb_h, mb_w, 6, 8, 8) blocks of macroblock-aligned planes."""
    mb_h, mb_w = y.shape[0] // 16, y.shape[1] // 16
    luma = y.reshape(mb_h, 2, 8, mb_w, 2, 8).transpose(0, 3, 1, 4, 2, 5)
    luma = luma.reshape(mb_h, mb_w, 4, 8, 8)
    chroma = [c.reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3)[:, :, None]
              for c in (u, v)]
    return np.concatenate([luma] + chroma, 2)


def _m4_predict(ref: list[np.ndarray], disp: np.ndarray) -> list:
    """The planes of ``ref`` displaced by whole pels: ``disp`` (mb_h, mb_w,
    2) luma (dy, dx), edge-clamped (the residual's reference, open loop)."""
    out = []
    for plane, n, d in zip(ref, (16, 8, 8), (disp, disp // 2, disp // 2)):
        h, w = plane.shape
        dy = np.repeat(np.repeat(d[..., 0], n, 0), n, 1)
        dx = np.repeat(np.repeat(d[..., 1], n, 0), n, 1)
        iy = np.clip(np.arange(h)[:, None] + dy, 0, h - 1)
        ix = np.clip(np.arange(w)[None, :] + dx, 0, w - 1)
        out.append(plane[iy, ix])
    return out


class _M4Vop:
    """The prediction state of one VOP as the decoder keeps it: intra DC
    values and AC rows and columns, each macroblock's quantiser, motion
    vectors per 8x8 block, the video packet's first macroblock."""

    def __init__(self, mb_h: int, mb_w: int):
        self.mb_h, self.mb_w = mb_h, mb_w
        self.dc = [np.full((2 * mb_h + 1, 2 * mb_w + 1), 1024, np.int32)] + [
            np.full((mb_h + 1, mb_w + 1), 1024, np.int32) for _ in range(2)]
        # per block: its first column (1-7) then its first row (9-15)
        self.ac = [np.zeros(a.shape + (16,), np.int64) for a in self.dc]
        self.q = np.zeros((mb_h, mb_w), np.int64)
        self.mv = np.zeros((2 * mb_h + 1, 2 * mb_w + 2, 2), np.int32)
        self.rx = self.ry = self.start = 0
        self.first_line = True

    def start_mb(self, x: int, y: int) -> None:
        if self.rx == x and self.ry + 1 == y:
            self.first_line = False

    def resync(self, x: int, y: int) -> None:
        self.rx, self.ry, self.first_line = x, y, True
        self.start = y * self.mb_w + x

    def _pos(self, n: int, x: int, y: int):
        if n < 4:
            return self.dc[0], 2 * y + (n >> 1) + 1, 2 * x + (n & 1) + 1
        return self.dc[n - 3], y + 1, x + 1

    def dc_pred(self, n: int, x: int, y: int, scale: int
                ) -> tuple[int, int]:
        """(the predicted DC level, the direction: 0 left, 1 top)."""
        arr, r, c = self._pos(n, x, y)
        a, b, cc = int(arr[r, c - 1]), int(arr[r - 1, c - 1]), \
            int(arr[r - 1, c])
        if self.first_line and n != 3:
            if n != 2:
                b = cc = 1024
            if n != 1 and x == self.rx:
                b = a = 1024
        if x == self.rx and y == self.ry + 1 and n in (0, 4, 5):
            b = 1024
        top = abs(a - b) < abs(b - cc)
        return ((cc if top else a) + (scale >> 1)) // scale, int(top)

    def ac_pred(self, n: int, x: int, y: int, top: int, q: int
                ) -> np.ndarray:
        """The decoder's AC prediction (raster positions) of block n of
        macroblock (x, y) from its left or top neighbour: 0 outside the
        video packet or for a macroblock that is not intra, rescaled to
        ``q`` from another macroblock's quantiser."""
        arr, r, c = self._pos(n, x, y)
        ac = self.ac[0 if n < 4 else n - 3]
        out = np.zeros(64, np.int64)
        if top:
            src, other = ac[r - 1, c, 9:], (x, y - 1)
            inside = n in (2, 3)
            pos = np.arange(1, 8)
        else:
            src, other = ac[r, c - 1, 1:8], (x - 1, y)
            inside = n in (1, 3)
            pos = np.arange(1, 8) * 8
        if not inside:
            ox, oy = other
            if ox < 0 or oy < 0 or oy * self.mb_w + ox < self.start:
                return out
            oq = int(self.q[oy, ox])
            if oq != q:
                a = src * oq
                src = np.where(a >= 0, (a + (q >> 1)) // q,
                               -((-a + (q >> 1)) // q))
        out[pos] = src
        return out

    def set_ac(self, n: int, x: int, y: int, levels: np.ndarray) -> None:
        arr, r, c = self._pos(n, x, y)
        ac = self.ac[0 if n < 4 else n - 3]
        ac[r, c, 1:8] = levels[np.arange(1, 8) * 8]
        ac[r, c, 9:] = levels[1:8]

    def set_dc(self, n: int, x: int, y: int, value: int) -> None:
        arr, r, c = self._pos(n, x, y)
        arr[r, c] = value

    def not_intra(self, x: int, y: int) -> None:
        self.dc[0][2 * y + 1:2 * y + 3, 2 * x + 1:2 * x + 3] = 1024
        self.dc[1][y + 1, x + 1] = self.dc[2][y + 1, x + 1] = 1024
        self.ac[0][2 * y + 1:2 * y + 3, 2 * x + 1:2 * x + 3] = 0
        self.ac[1][y + 1, x + 1] = self.ac[2][y + 1, x + 1] = 0

    def mv_pred(self, k: int, x: int, y: int) -> tuple[int, int]:
        """ffmpeg's ff_h263_pred_motion for block k of macroblock (x, y)."""
        r, c = 2 * y + (k >> 1) + 1, 2 * x + (k & 1) + 1
        m = self.mv
        A = m[r, c - 1]
        off = (2, 1, 1, -1)[k]
        if self.first_line and k < 3:
            if k == 0:
                if x == self.rx:
                    return 0, 0
                if x + 1 == self.rx:
                    C = m[r - 1, c + off]
                    if x == 0:
                        return int(C[0]), int(C[1])
                    return tuple(int(sorted((A[i], 0, C[i]))[1])
                                 for i in (0, 1))
                return int(A[0]), int(A[1])
            if k == 1:
                if x + 1 == self.rx:
                    C = m[r - 1, c + off]
                    return tuple(int(sorted((A[i], 0, C[i]))[1])
                                 for i in (0, 1))
                return int(A[0]), int(A[1])
            if x == self.rx:
                m[r, c - 1] = 0
        B, C = m[r - 1, c], m[r - 1, c + off]
        return tuple(int(sorted((A[i], B[i], C[i]))[1]) for i in (0, 1))

    def set_mv(self, k: int, x: int, y: int, mv) -> None:
        self.mv[2 * y + (k >> 1) + 1, 2 * x + (k & 1) + 1] = mv


def _m4_levels(coef: np.ndarray, q: np.ndarray, intra: bool, mpeg: bool
               ) -> np.ndarray:
    """Quantised levels (mb_h, mb_w, 6, 64) of every block's DCT
    coefficients (mb_h, mb_w, 6, 8, 8) at each macroblock's quantiser ``q``
    (mb_h, mb_w); an intra block's DC is left at 0 (it is coded apart)."""
    c = coef.reshape(coef.shape[:3] + (64,))
    q = q[:, :, None, None].astype(np.float64)
    if mpeg:
        lv = np.trunc(c * 8 / (q * (_M4_INTRA_MATRIX if intra
                                    else _M4_INTER_MATRIX)))
    elif intra:
        lv = np.trunc(c / (2 * q))
    else:
        lv = np.sign(c) * np.floor(np.maximum(np.abs(c) - q / 2, 0) / (2 * q))
    lv = np.clip(lv, -127, 127).astype(np.int64)
    if intra:
        lv[..., 0] = 0
    return lv


def _m4_block_codes(lv: np.ndarray, intra: np.ndarray):
    """Every block's coefficients by the third escape (ESC, '11', last,
    run, marker, the 12-bit level, marker: 30 bits each) in zigzag order:
    (codes, offsets), block b's codes being codes[offsets[b]:offsets[b +
    1]]. ``lv`` is (blocks, 64) in raster order; an ``intra`` block's
    position 0 (its DC) is not among them."""
    z = lv[:, _M4_ZIGZAG]
    mask = z != 0
    mask[intra, 0] = False
    blk, pos = np.nonzero(mask)
    counts = np.bincount(blk, minlength=len(lv))
    off = np.concatenate(([0], np.cumsum(counts)))
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.concatenate(([0], pos[:-1]))
    prev = np.where(first, np.where(intra[blk], 0, -1), prev)
    last = np.zeros(len(blk), np.int64)
    last[off[1:][counts > 0] - 1] = 1
    codes = (((((0b0000011 << 2 | 3) << 1 | last) << 6 | (pos - prev - 1))
              << 1 | 1) << 12 | (z[blk, pos] & 0xFFF)) << 1 | 1
    return codes.tolist(), off.tolist()


def _m4_intra_dc(st: _M4Vop, n: int, x: int, y: int, dc: float, q: int
                 ) -> tuple[int, int]:
    """An intra block's DC level against its prediction: (the difference
    to code, the prediction's direction); the decoder's DC value is
    stored."""
    scale = _M4_Y_DC[q] if n < 4 else _M4_C_DC[q]
    level = int(np.rint(dc / scale))
    pred, top = st.dc_pred(n, x, y, scale)
    value = level * scale
    st.set_dc(n, x, y, value if not value & ~2047 else
              (0 if value < 0 else 2047))
    return level - pred, top


def _m4_put_dc(out: _BitList, n: int, diff: int) -> None:
    """The DC difference: its size VLC, the bits and, past 8 bits, a
    marker."""
    size = abs(diff).bit_length()
    out.put(*(_M4_DC_LUMA if n < 4 else _M4_DC_CHROMA)[size])
    if size:
        out.put(diff if diff > 0 else diff + (1 << size) - 1, size)
        if size > 8:
            out.put(1, 1)


def _m4_scan_codes(lv: np.ndarray, scan: np.ndarray) -> list[int]:
    """One intra block's AC levels (raster) by the third escape in
    ``scan`` order."""
    z = lv[scan]
    nz = np.flatnonzero(z[1:]) + 1
    runs = np.diff(nz, prepend=0) - 1
    last = (np.arange(len(nz)) == len(nz) - 1).astype(np.int64)
    return ((((((0b0000011 << 2 | 3) << 1 | last) << 6 | runs) << 1 | 1)
             << 12 | (z[nz] & 0xFFF)) << 1 | 1).tolist()


def _m4_choices(kind: str, choice: np.ndarray, qscale: int, skipped):
    """Each macroblock's mode and the quantiser it is coded at: I
    ``("intra", dquant, ac_pred)``; P also ``("skip",)``, ``("four",)``
    (4MV) and ``("inter", dquant)``; B ``("skip",)`` (its co-located
    macroblock was not coded), ``("direct0",)`` (MODB '1') and ``("b",
    mb_type, cbp coded, dbquant)``, mb_type 0 direct, 1 interpolated, 2
    backward, 3 forward."""
    mb_h, mb_w = choice.shape
    modes, qs, q = [], np.empty((mb_h, mb_w), np.int64), qscale
    for y in range(mb_h):
        for x in range(mb_w):
            c = int(choice[y, x])
            dq = 0
            if kind != "B" and c % 10 == 1:
                dq = (-1, -2, 1, 2)[c // 10 % 4]
                if not 2 <= q + dq <= 31:
                    dq = -dq
            if kind == "I" or (kind == "P" and c < 6):
                q += dq
                modes.append(("intra", dq, c % 2))
            elif kind == "P":
                if c >= 85:
                    modes.append(("skip",))
                elif c >= 60 and not dq:
                    modes.append(("four",))
                else:
                    q += dq
                    modes.append(("inter", dq))
            elif skipped[y, x]:
                modes.append(("skip",))
            elif c < 15:
                modes.append(("direct0",))
            else:
                mtype = c % 5 if c % 5 < 4 else 0
                with_cbp = c % 3 != 0
                dbq = ((0, -2, 2)[c // 3 % 3] if with_cbp and mtype
                       and 3 < q < 30 else 0)
                q += dbq
                modes.append(("b", mtype, with_cbp, dbq))
            qs[y, x] = q
    return modes, qs


def mpeg4_access_units(width: int, height: int, n_frames: int,
                       fps: float = 30.0, gop: int = 12, b_frames: int = 0,
                       mpeg_quant: bool = False, not_coded=(),
                       resync: int = 0, qscale: int = 8, seed: int = 0,
                       source=None, colour: tuple[int, int] | None = None):
    """(VOS/VO/VOL headers, [(display index, kind, VOP bytes)] in decode
    order) of an MPEG-4 part 2 stream (module section above): VOPs in
    ``h264_gop_order``, kind ``"I"``, ``"P"``, ``"B"`` or ``"N"`` (a P
    position in ``not_coded``, sent with vop_coded 0). ``resync`` > 0 puts
    a video packet every ``resync`` macroblocks of I- and P-VOPs, every
    other one with a header extension. ``source(t)`` gives frame t's
    (Y, U, V) planes (default ``h264_source_yuv(seed, t, height,
    width)``); ``colour`` writes a video_signal_type (``_m4_headers``)."""
    if width % 2 or height % 2:
        raise ValueError(f"4:2:0 needs an even size, not {width}x{height}")
    source = source or (lambda t: h264_source_yuv(seed, t, height, width))
    res = int(round(fps))
    bits = max(1, (res - 1).bit_length())
    mb_h, mb_w = -(-height // 16), -(-width // 16)
    mb_bits = max(1, (mb_h * mb_w - 1).bit_length())
    order = h264_gop_order(n_frames, gop, b_frames)
    for t in not_coded:
        if (t, "P") not in order:
            raise ValueError(f"frame {t} is not a P-VOP: it cannot be sent "
                             "not coded")
    headers = _m4_headers(width, height, res, not b_frames, mpeg_quant,
                          resync > 0, colour)
    planes = {}

    def plane(t):
        if t not in planes:
            planes[t] = _m4_planes(source(t), mb_h, mb_w)
        return planes[t]

    time_base = last_time_base = 0
    skip_of = {}                       # reference display index -> skips
    past = future = None               # display indices of the references
    out_units = []
    for t, kind in order:
        rs = np.random.RandomState([seed, t, 4])
        w = _BitList()
        w.put(0x000001B6, 32)
        w.put({"I": 0, "P": 1, "B": 2}[kind], 2)
        sec = t // res
        incr = sec - (last_time_base if kind == "B" else time_base)
        if kind != "B":
            last_time_base, time_base = time_base, sec
        w.put((1 << (incr + 1)) - 2, incr + 1)       # modulo_time_base
        w.put(1, 1)
        w.put(t % res, bits)
        w.put(1, 1)
        if t in not_coded:
            w.put(0, 1)                               # vop_coded
            w.stuff()
            out_units.append((t, "N", w.tobytes()))
            continue
        w.put(1, 1)
        if kind == "P":
            w.put(t % 2, 1)                           # vop_rounding_type
        w.put(0, 3)                                   # intra_dc_vlc_thr
        w.put(qscale, 5)
        if kind != "I":
            w.put(2, 3)                               # vop_fcode_forward
        if kind == "B":
            w.put(2, 3)                               # vop_fcode_backward
        # the macroblocks' choices, every block's DCT and levels at once
        choice = rs.randint(0, 100, (mb_h, mb_w))
        mv = rs.randint(-5, 6, (mb_h, mb_w, 4, 2)) + (t % 5 - 2)
        edge = np.zeros((mb_h, mb_w), bool)
        edge[[0, -1], :] = edge[:, [0, -1]] = True
        mv[edge & (choice % 7 == 0)] -= 20           # out past the edge
        disp = mv[:, :, 0] >> 1
        cur = plane(t)
        if kind == "I":
            resid = cur
        elif kind == "P":
            resid = [a - b for a, b in zip(cur, _m4_predict(plane(future),
                                                             disp))]
        else:
            back = choice % 5 == 2
            pf = _m4_predict(plane(past), disp)
            pb = _m4_predict(plane(future), disp)
            resid = [a - np.where(np.repeat(np.repeat(back, n, 0), n, 1),
                                  b2, b1)
                     for a, b1, b2, n in zip(cur, pf, pb, (16, 8, 8))]
        coefs = _M4_DCT @ _m4_blocks(*resid) @ _M4_DCT.T
        icoefs = coefs if kind == "I" else \
            _M4_DCT @ _m4_blocks(*cur) @ _M4_DCT.T
        modes, qs = _m4_choices(kind, choice, qscale,
                                skip_of.get(future))
        intra = np.array([m[0] == "intra" for m in modes]).reshape(mb_h,
                                                                  mb_w)
        lv = np.where(intra[..., None, None],
                      _m4_levels(icoefs, qs, True, mpeg_quant),
                      _m4_levels(coefs, qs, False, mpeg_quant))
        for mb, m in enumerate(modes):
            y, x = divmod(mb, mb_w)
            if m[0] == "b" and not m[2]:
                lv[y, x] = 0                          # MODB '01': no cbp
            elif m[0] == "b" and m[1] and not lv[y, x].any():
                lv[y, x, 0, 0] = 1                    # so DBQUANT is sent
        coded = (lv != 0).any(-1)
        codes, off = _m4_block_codes(lv.reshape(-1, 64),
                                     np.repeat(intra.reshape(-1), 6))

        def block(b: int, out=w) -> None:
            n = off[b + 1] - off[b]
            out.codes.extend(codes[off[b]:off[b + 1]])
            out.lens.extend([30] * n)
            out.n += 30 * n

        st = _M4Vop(mb_h, mb_w)
        skips = np.zeros((mb_h, mb_w), bool)
        last_mv = [[0, 0], [0, 0]]
        q = qscale
        for mb, m in enumerate(modes):
            y, x = divmod(mb, mb_w)
            if mb and resync and kind != "B" and mb % resync == 0:
                w.stuff()
                w.put(1, 17 if kind == "I" else 15 + 2 + 1)
                w.put(mb, mb_bits)
                w.put(q, 5)
                hec = (mb // resync) % 2
                w.put(hec, 1)
                if hec:
                    w.put((1 << (incr + 1)) - 2, incr + 1)
                    w.put(1, 1)
                    w.put(t % res, bits)
                    w.put(1, 1)
                    w.put({"I": 0, "P": 1}[kind], 2)
                    w.put(0, 3)
                    if kind == "P":
                        w.put(2, 3)
                st.resync(x, y)
            st.start_mb(x, y)
            q = int(qs[y, x])
            cb = coded[y, x]
            cbpy = int(cb[0]) << 3 | int(cb[1]) << 2 | int(cb[2]) << 1 \
                | int(cb[3])
            cbpc = int(cb[4]) << 1 | int(cb[5])
            if m[0] == "intra":
                _, dq, ac = m
                st.q[y, x] = q
                dcs = [_m4_intra_dc(st, n, x, y, icoefs[y, x, n, 0, 0], q)
                       for n in range(6)]
                acs = []
                for n in range(6):
                    actual = lv[y, x, n]
                    if ac:
                        top = dcs[n][1]
                        pred = st.ac_pred(n, x, y, top, q)
                        sent = np.clip(actual - pred, -2047, 2047)
                        actual = sent + pred
                        acs.append(_m4_scan_codes(
                            sent, _M4_ALT_HORIZONTAL if top
                            else _M4_ALT_VERTICAL))
                    else:
                        acs.append(codes[off[6 * mb + n]:
                                         off[6 * mb + n + 1]])
                    st.set_ac(n, x, y, actual)
                cb = [bool(a) for a in acs]
                cbpy = cb[0] << 3 | cb[1] << 2 | cb[2] << 1 | cb[3]
                cbpc = cb[4] << 1 | cb[5]
                if kind == "I":
                    w.put(*_M4_INTRA_MCBPC[(4 if dq else 0) + cbpc])
                else:
                    w.put(0, 1)                       # coded
                    w.put(*_M4_INTER_MCBPC[(12 if dq else 4) + cbpc])
                w.put(ac, 1)                          # ac_pred_flag
                w.put(*_M4_CBPY[cbpy])
                if dq:
                    w.put(_QUANT_TAB[dq], 2)
                for n in range(6):
                    _m4_put_dc(w, n, dcs[n][0])
                    w.codes.extend(acs[n])
                    w.lens.extend([30] * len(acs[n]))
                    w.n += 30 * len(acs[n])
                for k in range(4):
                    st.set_mv(k, x, y, (0, 0))
                continue
            st.not_intra(x, y)
            if kind == "P":
                if m[0] == "skip":                    # not coded
                    w.put(1, 1)
                    skips[y, x] = True
                    for k in range(4):
                        st.set_mv(k, x, y, (0, 0))
                    continue
                four = m[0] == "four"
                dq = 0 if four else m[1]
                w.put(0, 1)
                w.put(*_M4_INTER_MCBPC[4 * (4 if four else 2 if dq else 0)
                                       + cbpc])
                w.put(*_M4_CBPY[cbpy ^ 15])
                if dq:
                    w.put(_QUANT_TAB[dq], 2)
                for k in range(4 if four else 1):
                    px, py = st.mv_pred(k, x, y)
                    vx, vy = (int(v) for v in mv[y, x, k])
                    _m4_mvd(w, vx - px, 2)
                    _m4_mvd(w, vy - py, 2)
                    if four:
                        st.set_mv(k, x, y, (vx, vy))
                if not four:
                    for k in range(4):
                        st.set_mv(k, x, y, mv[y, x, 0])
                for b in range(6 * mb, 6 * mb + 6):
                    block(b)
                continue
            # B-VOP
            if x == 0:
                last_mv = [[0, 0], [0, 0]]
            if m[0] == "skip":
                continue                              # no bits
            if m[0] == "direct0":
                w.put(1, 1)                           # MODB: direct, no data
                continue
            _, mtype, with_cbp, dbq = m
            w.put(0, 1)
            w.put(int(not with_cbp), 1)
            w.put(1, mtype + 1)                       # MB_TYPE
            if with_cbp:
                w.put(cbpy << 2 | cbpc, 6)            # CBPB
                if mtype:
                    w.put(2 | (dbq > 0), 2) if dbq else w.put(0, 1)
            if mtype == 0:
                _m4_mvd(w, int(mv[y, x, 1, 0]) % 5 - 2, 1)
                _m4_mvd(w, int(mv[y, x, 1, 1]) % 5 - 2, 1)
            for d in ((0,) if mtype == 3 else (1,) if mtype == 2 else
                      (0, 1) if mtype == 1 else ()):
                vx, vy = (int(v) for v in mv[y, x, 2 + d])
                _m4_mvd(w, vx - last_mv[d][0], 2)
                _m4_mvd(w, vy - last_mv[d][1], 2)
                last_mv[d] = [vx, vy]
            for b in range(6 * mb, 6 * mb + 6):
                block(b)
        w.stuff()
        out_units.append((t, kind, w.tobytes()))
        if kind != "B":
            skip_of[t] = skips
            past, future = future, t
    return headers, out_units


def write_mpeg4(path: str, width: int, height: int, n_frames: int,
                fps: float = 30.0, gop: int = 12, b_frames: int = 0,
                mpeg_quant: bool = False, not_coded=(), resync: int = 0,
                qscale: int = 8, seed: int = 0, source=None,
                colour: tuple[int, int] | None = None
                ) -> list[tuple[int, str]]:
    """Write the stream of ``mpeg4_access_units`` to ``path``: an MP4
    (``mp4v`` with the VOS, VO and VOL headers in its ``esds``, ``stss``,
    and ``ctts`` plus an edit list from the first presentation time where
    there are B-VOPs) or an AVI (``FMP4`` chunks of one VOP each, the
    headers ahead of every I-VOP, ``idx1`` key flags). Returns (display
    index, kind) of each VOP in decode order. ``colour``: a
    video_signal_type in the visual object header (``_m4_headers``)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".mp4", ".mov", ".avi"):
        raise ValueError(f"write_mpeg4 writes .mp4, .mov or .avi, not {ext}")
    headers, units = mpeg4_access_units(
        width, height, n_frames, fps, gop, b_frames, mpeg_quant, not_coded,
        resync, qscale, seed, source, colour)
    delta, scale = _frame_rate(fps)
    order = [(t, kind) for t, kind, _ in units]
    sync = [kind == "I" for _, kind in order]
    with open(path, "wb") as f:
        if ext == ".avi":
            samples = [(headers if kind == "I" else b"") + vop
                       for _, kind, vop in units]
            f.write(_avi(samples, sync, b"FMP4", delta, scale, width,
                         height))
            return order
        shift = max(0, max(k - t for k, (t, _) in enumerate(order)))
        offsets = [(t + shift - k) * delta for k, (t, _) in enumerate(order)]
        f.write(_mp4([vop for _, _, vop in units], sync, offsets, delta,
                     scale, width, height, headers, shift * delta,
                     kind=b"mp4v"))
    return order


# -- Matroska and fragmented MP4 ----------------------------------------------

def _ebml_size(n: int | None) -> bytes:
    """An element size as EBML writes it, in the fewest bytes; None: the
    unknown size (all ones)."""
    if n is None:
        return b"\x01" + b"\xff" * 7
    width = 1
    while n >= (1 << 7 * width) - 1:
        width += 1
    return (n | 1 << 7 * width).to_bytes(width, "big")


def _el(eid: int, *parts: bytes, unknown: bool = False) -> bytes:
    body = b"".join(parts)
    return (eid.to_bytes((eid.bit_length() + 7) // 8, "big")
            + _ebml_size(None if unknown else len(body)) + body)


def _el_uint(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _el_float(eid: int, v: float) -> bytes:
    return _el(eid, struct.pack(">d", v))


def _lace_head(sizes: list[int], lacing: str) -> bytes:
    """A laced block's head: the lace count less one, then the sizes of
    all frames but the last (Xiph: runs of 255; EBML: the first size, then
    signed differences)."""
    head = bytes([len(sizes) - 1])
    if lacing == "xiph":
        for n in sizes[:-1]:
            head += b"\xff" * (n // 255) + bytes([n % 255])
    elif lacing == "ebml":
        head += _ebml_size(sizes[0])
        for a, b in zip(sizes, sizes[1:-1]):
            diff, width = b - a, 1
            while abs(diff) >= (1 << 7 * width - 1) - 1:
                width += 1
            raw = diff + (1 << 7 * width - 1) - 1
            head += (raw | 1 << 7 * width).to_bytes(width, "big")
    return head


def write_matroska(path: str, frames: list[bytes], keys: list[bool],
                   times: list[int], codec_id: str, width: int, height: int,
                   *, codec_private: bytes = b"",
                   timestamp_scale: int = 1000000,
                   default_duration: int | None = None,
                   duration: float | None = None, groups: bool = False,
                   lacing: str | None = None, lace: int = 1,
                   strip: bytes = b"", encoding: str | None = None,
                   live: bool = False, audio: bool = False,
                   cluster: int = 12) -> None:
    """Write a Matroska file of one video track: ``frames`` (as a decoder
    takes them) with their key flags and block ``times`` in
    ``timestamp_scale`` ns ticks, ``cluster`` frames to a ``Cluster``
    (each opened by a ``CRC-32`` element), ``Cues`` for the key frames and
    a ``Void`` after ``Info``. ``groups``: each frame in a ``BlockGroup``
    with its ``BlockDuration`` (the time to the next frame) and, unless a
    key frame, a ``ReferenceBlock``; else ``SimpleBlock``s. ``lacing``
    "xiph", "ebml" or "fixed" puts ``lace`` frames in a block (fixed-size
    lacing pads each frame with zeros to the largest). ``strip``: a prefix
    every frame has, removed and written as a header-stripping
    ``ContentCompression``; ``encoding`` "zlib" compresses each frame,
    "bzlib" and "encrypted" only declare that (for refusals). ``live``:
    the ``Segment`` and ``Cluster``s of unknown size, no ``Duration``, no
    ``Cues``, as a muxer writing to a pipe leaves them. ``audio``: a PCM
    track numbered 1 ahead of the video track (2), one silent block a
    cluster."""
    number = 2 if audio else 1
    scale = timestamp_scale
    encodings = b""
    if strip:
        if not all(f.startswith(strip) for f in frames):
            raise ValueError("a frame without the stripped prefix")
        frames = [f[len(strip):] for f in frames]
        encodings = _el(0x6240, _el_uint(0x5031, 0), _el_uint(0x5032, 1),
                        _el_uint(0x5033, 0), _el(0x5034, _el_uint(0x4254, 3),
                                                 _el(0x4255, strip)))
    elif encoding in ("zlib", "bzlib"):
        if encoding == "zlib":
            frames = [zlib.compress(f) for f in frames]
        encodings = _el(0x6240, _el_uint(0x5031, 0), _el_uint(0x5032, 1),
                        _el_uint(0x5033, 0), _el(0x5034, _el_uint(
                            0x4254, 0 if encoding == "zlib" else 1)))
    elif encoding == "encrypted":
        encodings = _el(0x6240, _el_uint(0x5031, 0), _el_uint(0x5032, 1),
                        _el_uint(0x5033, 1), _el(0x5035, _el_uint(0x47E1, 5),
                                                 _el(0x47E2, bytes(16))))
    video = [_el_uint(0xD7, number), _el_uint(0x73C5, number),
             _el_uint(0x83, 1), _el_uint(0x9C, 1 if lacing else 0),
             _el(0x86, codec_id.encode())]
    if codec_private:
        video.append(_el(0x63A2, codec_private))
    if default_duration:
        video.append(_el_uint(0x23E383, default_duration))
    video.append(_el(0xE0, _el_uint(0xB0, width), _el_uint(0xBA, height)))
    if encodings:
        video.append(_el(0x6D80, encodings))
    tracks = [_el(0xAE, *video)]
    if audio:
        tracks.insert(0, _el(0xAE, _el_uint(0xD7, 1), _el_uint(0x73C5, 1),
                             _el_uint(0x83, 2), _el(0x86, b"A_PCM/INT/LIT"),
                             _el(0xE1, _el_float(0xB5, 8000.0),
                                 _el_uint(0x9F, 1), _el_uint(0x6264, 16))))
    info = [_el_uint(0x2AD7B1, scale), _el(0x4D80, b"auformer_torch"),
            _el(0x5741, b"auformer_torch fixtures")]
    if duration is not None and not live:
        info.append(_el_float(0x4489, float(duration)))
    head = _el(0x1549A966, *info) + _el(0xEC, bytes(16)) + _el(
        0x1654AE6B, *tracks)
    step = lace if lacing else 1
    tick = (default_duration or 0) // scale
    clusters = []
    for c0 in range(0, len(frames), cluster):
        c1 = min(c0 + cluster, len(frames))
        base = times[c0]
        body = [_el(0xE7, base.to_bytes(max(1, (base.bit_length() + 7)
                                              // 8), "big"))]
        if audio:
            span = (times[c1] if c1 < len(times) else times[-1] + tick) - base
            samples = max(1, span * scale * 8000 // 1000000000)
            body.append(_el(0xA3, b"\x81" + struct.pack(">hB", 0, 0x80),
                            bytes(2 * samples)))
        for b0 in range(c0, c1, step):
            b1 = min(b0 + step, c1)
            data = frames[b0:b1]
            flags = 0x80 if keys[b0] and not groups else 0
            block = b"\x80" + bytes([number]) if number > 127 else bytes(
                [0x80 | number])
            lace_bytes = b""
            if lacing:
                if lacing == "fixed":
                    big = max(len(f) for f in data)
                    data = [f + bytes(big - len(f)) for f in data]
                flags |= {"xiph": 2, "fixed": 4, "ebml": 6}[lacing]
                lace_bytes = _lace_head([len(f) for f in data], lacing)
            block += struct.pack(">hB", times[b0] - base, flags) + lace_bytes
            block += b"".join(data)
            if groups:
                parts = [_el(0xA1, block), _el_uint(0x9B, tick * (b1 - b0))]
                if not keys[b0]:
                    ref = times[b0 - 1] - times[b0]
                    parts.append(_el(0xFB, ref.to_bytes(2, "big",
                                                        signed=True)))
                body.append(_el(0xA0, *parts))
            else:
                body.append(_el(0xA3, block))
        payload = b"".join(body)
        crc = _el(0xBF, struct.pack("<I", zlib.crc32(payload)))
        clusters.append(_el(0x1F43B675, crc, payload, unknown=live))
    segment = [head, *clusters]
    if not live:
        # each key frame's cluster, relative to the Segment's data
        points = []
        offsets, pos = [], len(head)
        for c in clusters:
            offsets.append(pos)
            pos += len(c)
        for k in range(0, len(frames), step):
            if keys[k]:
                points.append(_el(0xBB, _el_uint(0xB3, times[k]), _el(
                    0xB7, _el_uint(0xF7, number),
                    _el_uint(0xF1, offsets[k // cluster]))))
        segment.append(_el(0x1C53BB6B, *points))
    ebml = _el(0x1A45DFA3, _el_uint(0x4286, 1), _el_uint(0x42F7, 1),
               _el_uint(0x42F2, 4), _el_uint(0x42F3, 8),
               _el(0x4282, b"matroska"), _el_uint(0x4287, 4),
               _el_uint(0x4285, 2))
    with open(path, "wb") as f:
        f.write(ebml + _el(0x18538067, *segment, unknown=live))


def write_fragmented_mp4(path: str, samples: list[bytes], sync: list[bool],
                         dts: list[int], cts: list[int], scale: int,
                         width: int, height: int, config: bytes,
                         kind: bytes = b"avc1", *, base: str = "moof",
                         truns: int = 2, version: int = 1,
                         sample_flags: bool = True, tfdt: bool = True,
                         edit: int | None = None) -> None:
    """Write a fragmented MP4 of one video track (an empty ``moov`` with a
    ``trex``, then a ``moof`` and an ``mdat`` for each run of samples from
    a sync sample): each ``traf`` holds a ``tfhd`` whose data base is the
    ``moof`` (``base`` "moof": default-base-is-moof) or an explicit file
    offset ("explicit"), a ``tfdt`` unless ``tfdt`` is False (the decode
    times then run on from the fragment before), and its samples in
    ``truns`` ``trun`` boxes (version ``version``: signed composition
    offsets for 1), each with its data offset, the samples' sizes, their
    durations unless all are the ``tfhd``'s default, their flags
    (``sample_flags``) or else a first-sample flag over the ``tfhd``'s
    non-sync default, and their composition offsets where ``cts`` differs
    from ``dts``. ``edit``: an edit list of one media edit from that media
    time. ``kind``/``config`` as ``_mp4``'s."""
    durations = [b - a for a, b in zip(dts, dts[1:])]
    durations.append(durations[-1] if durations else 1)
    default_dur = max(set(durations), key=durations.count)
    offsets = [c - d for c, d in zip(cts, dts)]
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512),
                b"isomiso6iso2avc1mp41")
    stbl = _box(b"stbl", _full_box(b"stsd", 0, 0, struct.pack(">I", 1), _box(
        kind, bytes(6), struct.pack(">H", 1), bytes(16),
        struct.pack(">HHIII", width, height, 0x480000, 0x480000, 0),
        struct.pack(">H", 1), bytes(32), struct.pack(">Hh", 24, -1),
        _box(b"avcC", config) if kind == b"avc1" else _esds(config))),
        _full_box(b"stts", 0, 0, struct.pack(">I", 0)),
        _full_box(b"stsc", 0, 0, struct.pack(">I", 0)),
        _full_box(b"stsz", 0, 0, struct.pack(">II", 0, 0)),
        _full_box(b"stco", 0, 0, struct.pack(">I", 0)))
    trak = [_full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, 0),
                      bytes(8), struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                      struct.pack(">II", width << 16, height << 16))]
    if edit is not None:
        trak.append(_box(b"edts", _full_box(
            b"elst", 0, 0, struct.pack(">IIihH", 1, 0, edit, 1, 0))))
    trak.append(_box(b"mdia", _full_box(
        b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, scale, 0, 0x55C4, 0)),
        _full_box(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide"), bytes(12),
                  b"VideoHandler\x00"),
        _box(b"minf", _full_box(b"vmhd", 0, 1, bytes(8)),
             _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                     _full_box(b"url ", 0, 1))), stbl)))
    moov = _box(b"moov", _full_box(
        b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, scale, 0, 0x10000,
                                   0x100), bytes(10), _MATRIX, bytes(24),
        struct.pack(">I", 2)), _box(b"trak", *trak), _box(
            b"mvex", _full_box(b"trex", 0, 0, struct.pack(
                ">IIIII", 1, 1, default_dur, 0, 0x01010000))))
    out = [ftyp, moov]
    at = len(ftyp) + len(moov)
    starts = [k for k, s in enumerate(sync) if s or k == 0] + [len(samples)]
    for seq, (f0, f1) in enumerate(zip(starts, starts[1:])):
        cut = [f0 + (f1 - f0) * r // truns for r in range(truns)] + [f1]
        runs = [(a, b) for a, b in zip(cut, cut[1:]) if b > a]

        def moof(data_start: int) -> bytes:
            flags = 0x8 | 0x20 | (0x20000 if base == "moof" else 0x1)
            tfhd = struct.pack(">I", 1)
            if base != "moof":
                tfhd += struct.pack(">Q", at)
            tfhd += struct.pack(">II", default_dur, 0x01010000)
            parts = [_full_box(b"tfhd", 0, flags, tfhd)]
            if tfdt:
                parts.append(_full_box(b"tfdt", 1, 0,
                                       struct.pack(">Q", dts[f0])))
            pos = data_start
            for a, b in runs:
                tflags = 0x1 | 0x200 | (0x400 if sample_flags else 0x4)
                if any(durations[k] != default_dur for k in range(a, b)):
                    tflags |= 0x100
                if any(offsets[f0:f1]):
                    tflags |= 0x800
                body = struct.pack(">Ii", b - a, pos)
                if not sample_flags:
                    body += struct.pack(">I", 0x02000000 if sync[a]
                                        else 0x01010000)
                for k in range(a, b):
                    if tflags & 0x100:
                        body += struct.pack(">I", durations[k])
                    body += struct.pack(">I", len(samples[k]))
                    if sample_flags:
                        body += struct.pack(">I", 0x02000000 if sync[k]
                                            else 0x01010000)
                    if tflags & 0x800:
                        body += struct.pack(">i" if version else ">I",
                                            offsets[k])
                parts.append(_full_box(b"trun", version, tflags, body))
                pos += sum(len(samples[k]) for k in range(a, b))
            return _box(b"moof", _full_box(b"mfhd", 0, 0,
                                           struct.pack(">I", seq + 1)),
                        _box(b"traf", *parts))

        size = len(moof(0))
        box = moof(size + 8)          # the data offsets from the moof
        mdat = _box(b"mdat", *samples[f0:f1])
        out += [box, mdat]
        at += len(box) + len(mdat)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# -- ASF ----------------------------------------------------------------------

_ASF_GUIDS = {
    "header": "3026b2758e66cf11a6d900aa0062ce6c",
    "file": "a1dcab8c47a9cf118ee400c00c205365",
    "stream": "9107dcb7b7a9cf118ee600c00c205365",
    "extension": "b503bf5f2ea9cf118ee300c00c205365",
    "reserved1": "11d2d3abbaa9cf118ee600c00c205365",
    "ext_stream": "cba5e61472c632438399a96952065b5a",
    "data": "3626b2758e66cf11a6d900aa0062ce6c",
    "index": "90080033b1e5cf1189f400a0c90349cb",
    "video": "c0ef19bc4d5bcf11a8fd00805f5c442b",
    "no_ec": "0057fb20555bcf11a8fd00805f5c442b",
}


def _asf_object(name: str, body: bytes) -> bytes:
    return (bytes.fromhex(_ASF_GUIDS[name]) + struct.pack("<Q", 24 + len(body))
            + body)


def write_asf(path: str, objects: Sequence[bytes], keys: Sequence[bool],
              times_ms: Sequence[int], fourcc: bytes, width: int,
              height: int, extradata: bytes = b"", packet_size: int = 1024,
              preroll: int = 3100, avg_time: int | None = None,
              broadcast: bool = False, index: bool = True,
              multiple: bool = False) -> None:
    """An ASF file of one video stream (number 1) whose media objects are
    ``objects``, presented at ``times_ms``: packets of ``packet_size``
    bytes with error correction data and one payload each, or with
    ``multiple`` as many payloads as fit (several small objects in a
    packet); an object larger than the room left is split over packets.
    ``avg_time`` (100 ns) writes an Extended Stream Properties Object,
    ``broadcast`` sets the File Properties' broadcast flag (no play
    duration), ``index`` writes a Simple Index Object of 1 s entries."""
    head = 13 + (1 if multiple else 0)     # packet header bytes
    per = 15 + (2 if multiple else 0)      # payload header bytes
    packets: list[list] = [[]]              # [(object, offset, data)]
    room = packet_size - head
    for k, obj in enumerate(objects):
        off = 0
        while off < len(obj):
            if room < per + 1 or (not multiple and packets[-1]):
                packets.append([])
                room = packet_size - head
            n = min(len(obj) - off, room - per)
            packets[-1].append((k, off, obj[off:off + n]))
            room -= per + n
            off += n
    out = []
    for p in packets:
        body = bytearray()
        for k, off, data in p:
            body += bytes([1 | (0x80 if keys[k] else 0), k & 0xFF])
            body += struct.pack("<IB", off, 8)
            body += struct.pack("<II", len(objects[k]), times_ms[k] + preroll)
            if multiple:
                body += struct.pack("<H", len(data))
            body += data
        pad = packet_size - head - len(body)
        send = times_ms[p[0][0]] + preroll if p else 0
        pkt = bytes([0x82, 0, 0, 0x11 if multiple else 0x10, 0x5D])
        pkt += struct.pack("<HIH", pad, send, 0)
        if multiple:
            pkt += bytes([0x80 | len(p)])
        out.append(pkt + bytes(body) + bytes(pad))
    frame = times_ms[1] - times_ms[0] if len(times_ms) > 1 else 40
    play = (max(times_ms) + frame + preroll) * 10000
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height,
                      1, 24, fourcc, width * height * 3, 0, 0, 0, 0)
    bih += extradata
    specific = struct.pack("<IIBH", width, height, 2, len(bih)) + bih
    stream = (bytes.fromhex(_ASF_GUIDS["video"])
              + bytes.fromhex(_ASF_GUIDS["no_ec"])
              + struct.pack("<QIIHI", 0, len(specific), 0, 1, 0) + specific)
    ext = b""
    if avg_time is not None:
        ext = _asf_object("ext_stream", struct.pack(
            "<QQIIIIIIIIHHQHH", 0, 0, 400000, 1000, 0, 0, 0, 0,
            max(len(o) for o in objects), 2, 1, 0, avg_time, 0, 0))
    extension = _asf_object("extension", bytes.fromhex(
        _ASF_GUIDS["reserved1"]) + struct.pack("<HI", 6, len(ext)) + ext)
    data = (bytes.fromhex(_ASF_GUIDS["data"])
            + struct.pack("<Q", 50 + packet_size * len(out)) + bytes(16)
            + struct.pack("<QH", len(out), 0x0101) + b"".join(out))
    tail = b""
    if index:
        starts = {}
        for n, p in enumerate(packets):
            for k, off, _ in p:
                if off == 0:
                    starts.setdefault(k, n)
        # each entry: the packet where the last key object at or before
        # its time begins
        entries, last_key, k = [], 0, 0
        for i in range((play // 10000000) + 1):
            while k < len(objects) and times_ms[k] + preroll <= i * 1000:
                if keys[k]:
                    last_key = starts[k]
                k += 1
            entries.append(struct.pack("<IH", last_key, 1))
        tail = _asf_object("index", bytes(16) + struct.pack(
            "<QII", 10000000, 1, len(entries)) + b"".join(entries))

    def file_props(size: int) -> bytes:
        return _asf_object("file", bytes(16) + struct.pack(
            "<QQQQQQIIII", size, 0, len(out), 0 if broadcast else play,
            0 if broadcast else play - preroll * 10000, preroll,
            1 if broadcast else 2, packet_size, packet_size, 0))

    children = [_asf_object("stream", stream), extension]
    guess = 30 + len(file_props(0)) + sum(len(c) for c in children)
    total = guess + len(data) + len(tail)
    header = (_asf_object("header", struct.pack("<IBB", 3, 1, 2)
                          + file_props(total) + b"".join(children)))
    with open(path, "wb") as f:
        f.write(header + data + tail)


# -- MPEG transport stream ----------------------------------------------------

def _crc32_mpeg(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = (crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def _psi(table_id: int, extension: int, body: bytes) -> bytes:
    """A PSI section with its CRC_32."""
    head = struct.pack(">BHHBBB", table_id, 0xB000 | (len(body) + 9),
                       extension, 0xC1, 0, 0)
    return head + body + struct.pack(">I", _crc32_mpeg(head + body))


def _pes_time(marker: int, t: int) -> bytes:
    t %= 1 << 33
    return bytes([marker << 4 | (t >> 29) & 0x0E | 1, (t >> 22) & 0xFF,
                  (t >> 14) & 0xFE | 1, (t >> 7) & 0xFF, (t << 1) & 0xFE | 1])


def write_mpegts(path: str, units: Sequence[bytes], pts: Sequence[int],
                 dts: Sequence[int | None], stream_type: int = 0x1B,
                 splits: Sequence[int] | None = None, m2ts: bool = False,
                 pcr: bool = True) -> None:
    """A transport stream of one program whose video elementary stream
    (PID 0x100, ``stream_type``) is the concatenated ``units``, each
    presented at ``pts`` and decoded at ``dts`` (None: no DTS), times taken
    modulo 2^33 (a PTS near 2^33 wraps in mid stream). PES packets (of
    PES_packet_length 0, as video's are) start at the byte offsets
    ``splits`` of the elementary stream (default: where each unit starts),
    each with the times of the first unit that begins in it, none where
    none does; so two units can share a PES and a unit can run over two.
    Each PES's last TS packet is filled with adaptation-field stuffing, and
    with ``pcr`` the first packet of a PES whose unit is a key frame in the
    caller's sense (the first unit, and each whose DTS is its PTS' minimum
    so far) carries a PCR. ``m2ts`` writes 192-byte packets with the 4-byte
    TP_extra_header (arrival time stamps) of BDAV/AVCHD ``.m2ts`` files."""
    starts = [0]
    for u in units[:-1]:
        starts.append(starts[-1] + len(u))
    es = b"".join(units)
    cuts = sorted(set(starts if splits is None else splits) | {0})
    packets: list[bytes] = []
    cc = {0: 0, 0x1000: 0, 0x100: 0}

    def ts_packet(pid: int, payload: bytes, start: bool,
                  adaptation: bytes | None = None) -> None:
        room = 184 - (len(adaptation) if adaptation is not None else 0)
        if len(payload) < room:       # stuffing in the adaptation field
            fill = room - len(payload)
            if adaptation is None:
                adaptation = (b"\x00" if fill == 1 else bytes(
                    [fill - 1, 0]) + b"\xff" * (fill - 2))
            else:
                adaptation = (bytes([adaptation[0] + fill]) + adaptation[1:]
                              + b"\xff" * fill)
        afc = 0x30 if adaptation is not None else 0x10
        head = struct.pack(">BHB", 0x47, (0x4000 if start else 0) | pid,
                           afc | cc[pid])
        cc[pid] = (cc[pid] + 1) & 15
        packets.append(head + (adaptation or b"") + payload)

    def tables() -> None:
        pat = _psi(0, 1, struct.pack(">HH", 1, 0xE000 | 0x1000))
        ts_packet(0, b"\x00" + pat, True)
        pmt = _psi(2, 1, struct.pack(">HH", 0xE000 | 0x100, 0xF000)
                   + struct.pack(">BHH", stream_type, 0xE000 | 0x100, 0xF000))
        ts_packet(0x1000, b"\x00" + pmt, True)

    low = None
    for i, c in enumerate(cuts):
        end = cuts[i + 1] if i + 1 < len(cuts) else len(es)
        if end <= c:
            continue
        lo = bisect.bisect_left(starts, c)
        begun = list(range(lo, bisect.bisect_left(starts, end)))
        header = b""
        key = False
        if begun:
            k = begun[0]
            d = dts[k]
            key = k == 0 or (d is not None and (low is None or d <= low)
                             and d == pts[k])
            if d is not None:
                low = d if low is None else min(low, d)
            if d is None:
                header = b"\x80\x80\x05" + _pes_time(2, pts[k])
            else:
                header = (b"\x80\xc0\x0a" + _pes_time(3, pts[k])
                          + _pes_time(1, d))
        else:
            header = b"\x80\x00\x00"
        if i % 8 == 0:
            tables()
        data = b"\x00\x00\x01\xe0\x00\x00" + header + es[c:end]
        first = True
        while data:
            adaptation = None
            if first and pcr and key and begun:
                base = (dts[begun[0]] if dts[begun[0]] is not None
                        else pts[begun[0]]) - 9000
                base %= 1 << 33
                adaptation = bytes([7, 0x10]) + struct.pack(
                    ">IH", base >> 1, (base & 1) << 15 | 0x7E00)
            room = 184 - (len(adaptation) if adaptation else 0)
            ts_packet(0x100, data[:room], first, adaptation)
            data, first = data[room:], False
    with open(path, "wb") as f:
        for n, p in enumerate(packets):
            if m2ts:
                f.write(struct.pack(">I", (n * 1000) & 0x3FFFFFFF))
            f.write(p)


def write_mpegps(path: str, units: Sequence[bytes], pts: Sequence[int],
                 dts: Sequence[int | None]) -> None:
    """An MPEG-2 program stream of one video stream (id 0xE0): a pack
    header (with a system header in the first) and one PES packet a unit,
    with its PTS and DTS (None: none), split into PES packets of at most
    65,000 bytes (the later ones without times)."""
    out = bytearray()
    for k, u in enumerate(units):
        scr = max((dts[k] if dts[k] is not None else pts[k]) - 9000, 0)
        out += b"\x00\x00\x01\xba" + bytes([
            0x44 | (scr >> 27) & 0x38 | (scr >> 28) & 3, (scr >> 20) & 0xFF,
            (scr >> 12) & 0xF8 | 4 | (scr >> 13) & 3, (scr >> 5) & 0xFF,
            (scr << 3) & 0xF8 | 4, 1, 0x01, 0x89, 0xC3, 0xF8])
        if k == 0:
            out += b"\x00\x00\x01\xbb\x00\x0c\x80\x1e\xff\xfe\xe1\x7f" \
                   b"\xe0\xe0\xe8\xc0\xc0\x20"
        for at in range(0, max(len(u), 1), 65000):
            piece = u[at:at + 65000]
            if at:
                header = b"\x80\x00\x00"
            elif dts[k] is None:
                header = b"\x80\x80\x05" + _pes_time(2, pts[k])
            else:
                header = (b"\x80\xc0\x0a" + _pes_time(3, pts[k])
                          + _pes_time(1, dts[k]))
            out += b"\x00\x00\x01\xe0" + struct.pack(
                ">H", len(header) + len(piece)) + header + piece
    out += b"\x00\x00\x01\xb9"
    with open(path, "wb") as f:
        f.write(out)
