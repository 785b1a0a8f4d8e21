"""A video file's frame count, rate and size (counterpart of
auformer/data/video.py; reference dataloader/video.py:14-94), read from
the container's index by ``data/container.py`` with no video decoder.

``Video(path).meta`` loads the ``<video.ext>meta.json`` side cache, or the
legacy ``<video>meta.json``, else probes the container and, with
``write``, saves the cache as ``<video>meta.json``, where the JAX package
saves it (tests/test_ingest.py checks that name). The keys and the
``fps or 30.0`` rule are the JAX package's. Decoding pixels
(``read_RGB``, ``frames``) needs an H.264/MPEG-4 decoder, which the port
does not have: it raises naming ROADMAP.md queue A9.
"""
from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from . import container


class Video:
    def __init__(self, path: str, write: bool = True):
        self.path = path
        self.filename = os.path.splitext(os.path.basename(path))[0]
        self.meta = self._load_or_probe_meta(write)

    def _meta_path(self) -> str:
        # the reference's cache name keeps the extension: <video.mp4>meta.json
        return self.path + "meta.json"

    def _load_or_probe_meta(self, write: bool) -> dict:
        legacy = os.path.splitext(self.path)[0] + "meta.json"
        for mp in (self._meta_path(), legacy):
            if os.path.isfile(mp):
                with open(mp) as f:
                    return json.load(f)
        index = container.probe(self.path, timestamps=False)
        meta = {"num_frames": int(index["num_frames"]),
                "fps": float(index["fps"]) or 30.0,
                "width": int(index["width"]),
                "height": int(index["height"])}
        meta["duration"] = (meta["num_frames"] / meta["fps"]
                            if meta["fps"] else 0.0)
        if write:
            with open(legacy, "w") as f:
                json.dump(meta, f)
        return meta

    @property
    def num_frames(self) -> int:
        return self.meta["num_frames"]

    @property
    def fps(self) -> float:
        return self.meta["fps"]

    def count_frames(self) -> int:
        """The video packets of the container's index that hold data (the
        samples an edit list keeps, or the stream's AVI chunks): the count
        a decode loop returns where each packet decodes to one frame. It
        counts packets, not decoded frames."""
        return container.probe(self.path, timestamps=False)["packets"]

    def _no_decoder(self):
        return NotImplementedError(
            f"decoding the frames of {self.path} needs a video decoder, "
            "which auformer_torch does not have: ROADMAP.md queue A9 "
            "(frame decoding) lists it")

    def read_RGB(self, frame_idx: int | None = None) -> np.ndarray | None:
        raise self._no_decoder()

    def frames(self) -> Iterator[np.ndarray]:
        raise self._no_decoder()

    def release(self) -> None:
        """Nothing to release: no decoder is opened."""
