"""Aff2TestDataset (counterpart of auformer/data/testset.py; reference
dataloader/testset.py:14-220).

Differences from the train dataset: reads the cropped-ALIGNED stores
(.croped_aligned_jpeg/.croped_aligned_mask equivalents, testset.py:23-31),
loads the test-split pickle, labels are pure sentinels, each sample carries
its ``video_id`` for the submission writer, and the wav lookup strips the
_left/_right/_main position suffix (testset.py:166). The reference's
``opt['use_mask']`` KeyError (SURVEY.md §2.4-2) is fixed by deriving from
the modality string.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..core.config import Config
from .dataset import Aff2CompDataset
from .framestore import open_store

STORE_ALIGNED_IMAGES = "croped_aligned_jpeg"
STORE_ALIGNED_MASKS = "croped_aligned_mask"


def strip_position(video_id: str) -> str:
    """_left/_right/_main suffix -> base video name (testset.py:166,
    dataloader/utils.py:109-118)."""
    for suf in ("_left", "_right", "_main"):
        if video_id.endswith(suf):
            return video_id[: -len(suf)]
    return video_id


class Aff2TestDataset(Aff2CompDataset):
    def __init__(self, cfg: Config, audio_dir: str | None = None):
        # reuse the parent's audio/clip machinery, then swap stores + split
        super().__init__(cfg)
        self.audio_dir = audio_dir or cfg.root
        label_dir = cfg.lmdb_label_dir
        images = os.path.join(label_dir, STORE_ALIGNED_IMAGES)
        masks = os.path.join(label_dir, STORE_ALIGNED_MASKS)
        aligned_img = open_store(images)
        if aligned_img is not None:
            self.env_image = aligned_img
            self.env_mask = open_store(masks)
            # rebind the native reader to the aligned stores
            self.native_image = self.native_mask = None
            self._open_native(images, masks)
        self.use_mask = "M" in cfg.modality  # §2.4-2 fix

    def _load_split(self) -> None:
        """Prefer split_dict_test_{task}.pkl: a submission box holding only
        aligned stores + the test pickle (the reference testset contract,
        testset.py:64-68) must construct without building/reading the
        train split. Falls back to the parent bootstrap (whose meta.json
        splits also carry test masks: the synthetic-fixture path)."""
        cfg = self.cfg
        test_cache = os.path.join(cfg.cache_dir,
                                  f"split_dict_test_{self.task}.pkl")
        if not os.path.isfile(test_cache):
            super()._load_split()
            return
        with open(test_cache, "rb") as f:
            split = pickle.load(f)
        self.time_stamps = split["timestamp"]
        self.image_path = list(split["image_path"])
        self.video_db_nr = np.asarray(split["video_db_nr"])
        self.test_ids = np.asarray(split["test"])
        self.train_ids = np.zeros_like(self.test_ids)
        self.val_ids = np.zeros_like(self.test_ids)

    def _wav_path(self, video_id: str) -> str:
        """The JAX package strips the position suffix for host features
        only; the port does so for the raw windows of ``device_audio`` too,
        as the reference's wav lookup does (testset.py:166)."""
        return os.path.join(self.audio_dir, strip_position(video_id) + ".wav")

    def __getitem__(self, index: int) -> dict:
        data = super().__getitem__(index)
        data["video_id"] = os.path.dirname(self.image_path[index])
        return data
