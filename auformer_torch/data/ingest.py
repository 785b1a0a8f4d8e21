"""Offline ingest (counterpart of auformer/data/ingest.py; reference
112_align/create_lmdb.py and data_split.py's mkvtoolnix timestamps).

``create_image_store`` packs per-video cropped-aligned image directories
into one FrameStore under the ``"<video>/<frame>.jpg"`` key schema
(create_lmdb.py:20-24): JPEG bytes as they are, a ``.png`` read by
``data/png.py`` and re-encoded at quality 95 by the native encoder (the
JAX package uses cv2's ``imread`` and ``imencode``) under its ``.png``
key, as the JAX package keys it; the native reader finds such a key under
the split's ``.jpg`` name (ROADMAP.md C11). ``extract_timestamps``
writes the timestamps_v2 side file the split builder reads, and
``probe_video_meta`` the ``meta.json`` cache, both from the container's
index (``data/container.py``, ``data/video.py``: MP4/MOV, fragmented MP4,
AVI, Matroska/WebM, ASF and MPEG program and transport streams) in place
of cv2's decoder; the reference remuxed
every video to Matroska with mkvmerge for its timestamps, the port reads
the Matroska file as it is.
``write_label_store`` packs per-frame AU/EX/VA annotation arrays.
"""
from __future__ import annotations

import os
import pickle
from typing import Mapping

import numpy as np

from . import container
from .framestore import FrameStoreWriter
from .png import read_png
from .split import natsort_key
from .video import Video


def iter_image_files(root_dir: str):
    """Yield (key, path) for every <video>/<frame>.jpg, naturally sorted
    (create_lmdb.py:11-31)."""
    for video in sorted(os.listdir(root_dir), key=natsort_key):
        vdir = os.path.join(root_dir, video)
        if not os.path.isdir(vdir):
            continue
        for fname in sorted(os.listdir(vdir), key=natsort_key):
            if fname.endswith((".jpg", ".jpeg", ".png")):
                yield f"{video}/{fname}", os.path.join(vdir, fname)


def png_as_jpeg(path: str) -> bytes:
    """A PNG re-encoded as JPEG at quality 95, as the JAX package's cv2
    ``imencode`` does it with what ``imread(IMREAD_UNCHANGED)`` gave: the
    alpha channel dropped, grey kept grey. A 16-bit image keeps its high
    byte, where the JAX package saturates every sample above 255 to white
    (ROADMAP.md C10)."""
    from .native import encode_jpeg
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[..., :3]
    return encode_jpeg(img, 95)


def create_image_store(root_dir: str, store_path: str,
                       reencode_png: bool = True) -> list[str]:
    """Pack a cropped-aligned image tree into a FrameStore; returns the key
    list, also pickled to ``<store_path>_keys_cache.p`` as the reference
    does (create_lmdb.py:47). Under ``reencode_png`` a ``.png`` is stored
    as ``png_as_jpeg`` of it, else as its bytes."""
    keys = []
    with FrameStoreWriter(store_path) as w:
        for key, path in iter_image_files(root_dir):
            if path.endswith(".png") and reencode_png:
                data = png_as_jpeg(path)
            else:
                with open(path, "rb") as f:
                    data = f.read()
            w.put(key, data)
            keys.append(key)
    with open(store_path + "_keys_cache.p", "wb") as f:
        pickle.dump(keys, f)
    return keys


def extract_timestamps(video_path: str, out_path: str | None = None) -> str:
    """Write <video>_video_ts.txt in timestamps_v2 format, one line per
    frame in ms (replaces mkvmerge|mkvextract, data_split.py:39-45), from
    the container's index: the values cv2's ``CAP_PROP_POS_MSEC`` gives."""
    out_path = out_path or os.path.splitext(video_path)[0] + "_video_ts.txt"
    stamps = container.probe(video_path)["timestamps_ms"]
    with open(out_path, "w") as f:
        f.write("# timestamp format v2\n")
        for s in stamps:
            f.write(f"{s:.6f}\n")
    return out_path


def write_label_store(store_path: str,
                      labels: Mapping[str, np.ndarray]) -> None:
    """labels: key "<video>/<frame>.jpg" -> int8[12] (AU) / int8[1] (EX) /
    float32[2] (VA), stored raw, as the dataset's frombuffer reads them
    (aff2compdataset.py:264-287)."""
    with FrameStoreWriter(store_path) as w:
        for key, arr in labels.items():
            w.put(key, np.ascontiguousarray(arr).tobytes())


def probe_video_meta(video_path: str) -> dict:
    """Create or load the video's meta.json (data_split.py:26-30)."""
    return Video(video_path, write=True).meta
