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
an MJPEG AVI, for hosts without an encoder.
"""
from __future__ import annotations

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


def _h264_sps(width: int, height: int, b_frames: int) -> bytes:
    w = _Bits()
    w.u(8, 77 if b_frames else 66)       # profile_idc: Main for B slices
    w.u(8, 0x40 if b_frames else 0xC0)    # constraint_set flags
    w.u(8, 40)                            # level_idc 4.0
    w.ue(0)                               # seq_parameter_set_id
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
    w.u(1, int(any(crop)))
    if any(crop):
        for c in (0, crop[0] // 2, 0, crop[1] // 2):
            w.ue(c)
    w.u(1, 1)                             # vui_parameters_present_flag
    w.u(5, 0)   # aspect ratio, overscan, signal type, chroma loc, timing
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


def _mb_pcm(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(rows, cols, 384) uint8: each macroblock's pcm samples (256 luma,
    64 Cb, 64 Cr, each in raster order) of planes padded to whole MBs."""
    mbh, mbw = -(-y.shape[0] // 16), -(-y.shape[1] // 16)

    def blocks(p, n):
        p = np.pad(p, ((0, mbh * n - p.shape[0]), (0, mbw * n - p.shape[1])),
                   mode="edge")
        return p.reshape(mbh, n, mbw, n).transpose(0, 2, 1, 3).reshape(
            mbh, mbw, n * n)

    return np.concatenate([blocks(y, 16), blocks(u, 8), blocks(v, 8)], -1)


def _h264_slice(kind: str, frame_num: int, poc: int, idr_id: int,
                pcm: np.ndarray, coded: np.ndarray) -> bytes:
    """One slice of a whole picture: ``coded`` (rows, cols) bool marks the
    I_PCM macroblocks (all of them in an I slice), the rest are skipped."""
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
    w.se(0)                                        # slice_qp_delta
    w.ue(1)                                        # disable_deblocking_idc
    flat = pcm.reshape(-1, 384)
    pcm_type = {"I": 25, "P": 30, "B": 48}[kind]
    prev = -1
    for addr in np.flatnonzero(coded.reshape(-1)).tolist():
        if kind != "I":
            w.ue(addr - prev - 1)                  # mb_skip_run
        w.ue(pcm_type)                             # mb_type I_PCM
        w.align()                                  # pcm_alignment_zero_bit
        w.raw(flat[addr].tobytes())
        prev = addr
    if kind != "I" and prev < coded.size - 1:
        w.ue(coded.size - 1 - prev)                # the trailing skip run
    return w.trailing()


def h264_access_units(width: int, height: int, n_frames: int, gop: int = 30,
                      b_frames: int = 0, band: int = 1, seed: int = 0,
                      source=None):
    """Yield ``(display index, kind, NAL units)`` of each picture in decode
    order (``h264_gop_order``): IDR pictures all I_PCM, P pictures P_Skip
    but ``band`` I_PCM macroblock columns that move two columns a frame, B
    pictures all B_Skip. ``source(t)`` gives frame t's (Y, U, V) planes
    (default ``h264_source_yuv(seed, t, height, width)``); the NAL units
    are without start codes, each IDR's led by the SPS and PPS."""
    if width % 2 or height % 2:
        raise ValueError(f"4:2:0 needs an even size, not {width}x{height}")
    source = source or (lambda t: h264_source_yuv(seed, t, height, width))
    mbh, mbw = -(-height // 16), -(-width // 16)
    sps, pps = _h264_sps(width, height, b_frames), _h264_pps()
    refs = idr = 0
    for t, kind in h264_gop_order(n_frames, gop, b_frames):
        pcm = _mb_pcm(*source(t))
        coded = np.ones((mbh, mbw), bool)
        if kind == "I":
            refs, g0 = 0, t
        else:
            coded[:] = False
            if kind == "P":
                coded[:, [(2 * t + j) % mbw for j in range(band)]] = True
        rbsp = _h264_slice(kind, refs, 2 * (t - g0), idr, pcm, coded)
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


def _mp4(samples: list[bytes], sync: list[bool], offsets: list[int],
         delta: int, scale: int, width: int, height: int, avcc: bytes,
         shift: int) -> bytes:
    """An MP4 of one video track, one sample per chunk, ``moov`` after
    ``mdat``; a ``ctts`` box and an edit list from the first presentation
    time where ``offsets`` (composition offsets in ticks) are not all 0."""
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
            b"avc1", bytes(6), struct.pack(">H", 1), bytes(16),
            struct.pack(">HHIII", width, height, 0x480000, 0x480000, 0),
            struct.pack(">H", 1), bytes(32), struct.pack(">Hh", 24, -1),
            _box(b"avcC", avcc))),
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
               band: int = 1, seed: int = 0, source=None
               ) -> list[tuple[int, str]]:
    """Write the stream of ``h264_access_units`` to ``path``: an MP4/MOV
    (``avcC`` with the SPS and PPS, 4-byte NAL lengths, ``stts``, ``stss``,
    and ``ctts`` plus an edit list from the first presentation time where
    there are B pictures) or an AVI (``H264`` chunks in Annex B, the SPS
    and PPS ahead of each IDR, ``idx1`` key flags; no B pictures). Returns
    (display index, kind) of each sample in decode order."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".mp4", ".mov", ".avi"):
        raise ValueError(f"write_h264 writes .mp4, .mov or .avi, not {ext}")
    if ext == ".avi" and b_frames:
        raise ValueError("an AVI carries no presentation times: no B frames")
    delta, scale = _frame_rate(fps)
    order, samples, sync, sps_pps = [], [], [], None
    for t, kind, nals in h264_access_units(width, height, n_frames, gop,
                                           b_frames, band, seed, source):
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

