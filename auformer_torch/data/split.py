"""Dataset split builder (counterpart of auformer/data/split.py; reference
dataloader/data_split.py:13-123).

Produces, per task in {AU, EX, VA, ALL}, a dict with per-frame arrays::

    train / val / test : 0/1 membership masks
    timestamp          : frame timestamp in ms
    image_path         : "<video_id>/<frame>.jpg" relative paths
    video_db_nr        : per-frame video index (clip-boundary guard,
                         aff2compdataset.py:119,129)

pickled to ``split_dict_{task}.pkl`` — the exact cache schema the reference
dataset consumes (aff2compdataset.py:86-96). The reference derives per-video
split membership from ``<video>meta.json`` side files and extracts per-frame
timestamps with mkvmerge/mkvextract subprocesses; here ingest writes both as
plain files: meta.json carries ``{"num_frames", "fps", "AU"/"EX"/"VA":
"train"|"val"|"test"}`` and ``<video>_video_ts.txt`` is the standard
timestamps_v2 format (header line + one ms value per line). The reference's
recursive self-call / double-hstack defect (data_split.py:113-122, SURVEY.md
§2.4-5) is replaced by a single pass producing the intended flat arrays.
"""
from __future__ import annotations

import json
import os
import pickle
import re
from typing import Iterable

import numpy as np

TASKS = ("AU", "EX", "VA", "ALL")


def natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _wav_sample_rate(path: str) -> int:
    import wave
    with wave.open(path, "rb") as w:
        return w.getframerate()


def read_timestamps(path: str, num_frames: int) -> np.ndarray:
    """timestamps_v2 file -> (num_frames,) ms array; short files repeat the
    last stamp (reference data_split.py:82-88 IndexError fallback)."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals.append(float(line))
    ts = np.asarray(vals, np.float64)
    if len(ts) >= num_frames:
        return ts[:num_frames]
    pad = np.full(num_frames - len(ts), ts[-1] if len(ts) else 0.0)
    return np.concatenate([ts, pad])


def synth_timestamps(num_frames: int, fps: float) -> np.ndarray:
    return np.arange(num_frames, dtype=np.float64) * (1000.0 / fps)


def list_videos(root: str) -> list[str]:
    """Video ids = subdirectories of <root>/extracted, sorted naturally."""
    extracted = os.path.join(root, "extracted")
    if not os.path.isdir(extracted):
        return []
    vids = [d for d in os.listdir(extracted)
            if os.path.isdir(os.path.join(extracted, d))]
    return sorted(vids, key=natsort_key)


def load_video_meta(root: str, video_id: str) -> dict:
    p = os.path.join(root, video_id + "meta.json")
    with open(p) as f:
        return json.load(f)


def list_frames(root: str, video_id: str) -> list[str]:
    d = os.path.join(root, "extracted", video_id)
    return sorted((f for f in os.listdir(d) if f.endswith(".jpg")),
                  key=natsort_key)


def create_dataset_split(root: str, save_dir: str | None = None,
                         videos: Iterable[str] | None = None) -> dict:
    """Build all four split dicts in one pass over the frame inventory."""
    videos = list(videos) if videos is not None else list_videos(root)
    out = {t: {"train": [], "val": [], "test": [], "timestamp": [],
               "image_path": [], "video_db_nr": []} for t in TASKS}
    vid_counter = {t: 0 for t in TASKS}

    for video_id in videos:
        meta = load_video_meta(root, video_id)
        wav = os.path.join(root, video_id + ".wav")
        if os.path.isfile(wav):
            # the audio pipeline is hard-calibrated to 44.1 kHz
            # (reference data_split.py:33-34 asserts the same)
            sr = _wav_sample_rate(wav)
            assert sr == 44100, f"{wav}: expected 44100 Hz, got {sr}"
        frames = list_frames(root, video_id)
        n = len(frames)
        ts_file = os.path.join(root, video_id + "_video_ts.txt")
        if os.path.isfile(ts_file):
            ts = read_timestamps(ts_file, max(n, meta.get("num_frames", n)))
        else:
            ts = synth_timestamps(max(n, meta.get("num_frames", n)),
                                  meta.get("fps", 30.0))
        # frame files are 1-indexed "<k>.jpg"; timestamp by frame number
        frame_ts = []
        for fname in frames:
            idx = int(fname.split(".")[0]) - 1
            frame_ts.append(ts[idx] if idx < len(ts) else ts[-1])

        tasks_present = [t for t in ("AU", "EX", "VA") if t in meta]
        for task in TASKS:
            if task == "ALL":
                splits = sorted({meta[t] for t in tasks_present})
            else:
                splits = [meta[task]] if task in meta else []
            for split in splits:
                out[task]["image_path"].extend(
                    f"{video_id}/{f}" for f in frames)
                out[task]["timestamp"].extend(frame_ts)
                out[task]["train"].extend([1 if split == "train" else 0] * n)
                out[task]["val"].extend([1 if split == "val" else 0] * n)
                out[task]["test"].extend([1 if split == "test" else 0] * n)
                out[task]["video_db_nr"].extend([vid_counter[task]] * n)
                vid_counter[task] += 1

    for task in TASKS:
        d = out[task]
        d["train"] = np.asarray(d["train"], np.int64)
        d["val"] = np.asarray(d["val"], np.int64)
        d["test"] = np.asarray(d["test"], np.int64)
        d["timestamp"] = np.asarray(d["timestamp"], np.float64)
        d["video_db_nr"] = np.asarray(d["video_db_nr"], np.int64)

    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        for task in TASKS:
            with open(os.path.join(save_dir, f"split_dict_{task}.pkl"),
                      "wb") as f:
                pickle.dump(out[task], f)
            # test-split pickle consumed by Aff2TestDataset (the reference
            # ships these as separate caches, testset.py:64)
            with open(os.path.join(save_dir, f"split_dict_test_{task}.pkl"),
                      "wb") as f:
                pickle.dump(out[task], f)
    return out
