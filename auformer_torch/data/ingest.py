"""Offline ingest that needs no video decoder (counterpart of
auformer/data/ingest.py; reference 112_align/create_lmdb.py).

``create_image_store`` packs per-video cropped-aligned jpg directories into
one FrameStore under the ``"<video>/<frame>.jpg"`` key schema
(create_lmdb.py:20-24), the JPEG bytes copied as they are;
``write_label_store`` packs per-frame AU/EX/VA annotation arrays.

Re-encoding a ``.png`` as JPEG, ``extract_timestamps`` and
``probe_video_meta`` need cv2's image and video codecs, which the port does
not have: they raise naming ROADMAP.md queue A9.
"""
from __future__ import annotations

import os
import pickle
from typing import Mapping

import numpy as np

from .framestore import FrameStoreWriter
from .split import natsort_key

_A9 = ("auformer_torch has no image or video codec; ROADMAP.md queue A9 "
       "(offline ingest from videos) lists it")


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


def create_image_store(root_dir: str, store_path: str,
                       reencode_png: bool = True) -> list[str]:
    """Pack a cropped-aligned image tree into a FrameStore, each file's
    bytes as they are; returns the key list, also pickled to
    ``<store_path>_keys_cache.p`` as the reference does
    (create_lmdb.py:47). A ``.png`` under ``reencode_png`` raises: the JAX
    package re-encodes it as JPEG with cv2."""
    keys = []
    with FrameStoreWriter(store_path) as w:
        for key, path in iter_image_files(root_dir):
            if path.endswith(".png") and reencode_png:
                raise NotImplementedError(
                    f"re-encoding {path} as JPEG: {_A9}")
            with open(path, "rb") as f:
                w.put(key, f.read())
            keys.append(key)
    with open(store_path + "_keys_cache.p", "wb") as f:
        pickle.dump(keys, f)
    return keys


def write_label_store(store_path: str,
                      labels: Mapping[str, np.ndarray]) -> None:
    """labels: key "<video>/<frame>.jpg" -> int8[12] (AU) / int8[1] (EX) /
    float32[2] (VA), stored raw, as the dataset's frombuffer reads them
    (aff2compdataset.py:264-287)."""
    with FrameStoreWriter(store_path) as w:
        for key, arr in labels.items():
            w.put(key, np.ascontiguousarray(arr).tobytes())


def extract_timestamps(video_path: str, out_path: str | None = None) -> str:
    """The timestamps_v2 side file of a video: needs a video decoder."""
    raise NotImplementedError(f"timestamps of {video_path}: {_A9}")


def probe_video_meta(video_path: str) -> dict:
    """The ``<video>meta.json`` of a video: needs a video decoder."""
    raise NotImplementedError(f"frame count of {video_path}: {_A9}")
