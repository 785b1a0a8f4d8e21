"""Aff2CompDataset: the dataset of labelled frames (counterpart of
auformer/data/dataset.py; reference dataloader/aff2compdataset.py:16-292).

Per sample: a 16-frame dilated uint8 face clip ending at the labelled frame,
the AU/EX/VA labels of that frame (sentinels -1/-1/-5.0 when missing), and,
when 'A' is in the modality, the 10 s log-mel window (host features) or the
raw left-aligned window (``cfg.device_audio``).

  * clips stay uint8 (T, H, W, C) on the host; /255 + Kinetics normalize run
    on the device (ops/preprocess.py);
  * frames come from FrameStores (data/framestore.py) with the reference's
    ``video/frame.jpg`` key schema, decoded by the native reader
    (data/native: libjpeg or nvJPEG, whichever the host has). A reader that
    cannot be built makes the constructor raise: no frame is ever decoded
    another way, and none is left black for want of a decoder;
  * audio features are the strict-parity numpy pipeline (ops/audio_host.py);
  * frame-dedup batches (``set_frame_dedup``): samples carry their
    window's store keys, and ``assemble_batch`` turns a batch of them into
    a pool of unique frames plus a (B, T) window map, which the train step
    expands on the card (``parallel/step.py::expand_dedup_batch``);
  * the wav arena (``set_audio_arena``, data/wav_arena.py): device-audio
    samples carry int32 arena offsets instead of raw windows.

Training reads the train and val ids; the dataset never augments (the
train step does, ``--device_augment``), so ``set_aug(False)`` is a no-op.
Host AutoAugment, ``set_aug(True)``, is not ported and raises
``NotImplementedError`` naming ROADMAP.md A10: it is PIL's, which the
card's machine lacks, and a PIL-free version must be bit-exact with it;
train with ``--device_augment`` (ops/augment_device.py) instead.
"""
from __future__ import annotations

import os
import pickle
import threading
from collections import OrderedDict

import numpy as np

from ..core.config import Config
from ..ops import audio_host
from .framestore import open_store
from .native import NativeFrameStore
from .split import create_dataset_split

STORE_IMAGES = "croped_jpeg"
STORE_MASKS = "croped_mask"
STORE_AU = "label_au"
STORE_EX = "label_expr"
STORE_VA = "label_va"

_NOT_PORTED = "{} is not ported to auformer_torch yet (ROADMAP.md {})"


class Aff2CompDataset:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.task = cfg.task
        if self.task not in ("ALL", "EX", "AU", "VA"):
            raise ValueError(f"bad task {self.task!r}")
        self.video_dir = cfg.root
        label_dir = cfg.lmdb_label_dir

        # every store is optional (the reference wraps the env opens in
        # try/except, aff2compdataset.py:25-36); missing label stores
        # degrade to sentinel labels: the test-only-box case
        self.env_image = open_store(os.path.join(label_dir, STORE_IMAGES))
        self.env_mask = open_store(os.path.join(label_dir, STORE_MASKS))
        self.env_au = open_store(os.path.join(label_dir, STORE_AU))
        self.env_ex = open_store(os.path.join(label_dir, STORE_EX))
        self.env_va = open_store(os.path.join(label_dir, STORE_VA))
        self.native_image = self.native_mask = None
        self._open_native(os.path.join(label_dir, STORE_IMAGES),
                          os.path.join(label_dir, STORE_MASKS))

        v2o = os.path.join(cfg.root, "video2orignal.pkl")
        if os.path.isfile(v2o):
            with open(v2o, "rb") as f:
                self.video2orignal = pickle.load(f)
        else:
            self.video2orignal = {}

        self.clip_len = cfg.n_frames
        self.input_size = (cfg.image_size, cfg.image_size)
        self.dilation = cfg.dilation
        self.label_frame = self.clip_len * self.dilation

        self.sample_rate = cfg.sample_rate
        self.sample_len_secs = cfg.audio_len_secs
        self.sample_len_frames = cfg.sample_len_frames
        self.audio_shift_samples = cfg.audio_shift_samples
        self.n_mels = cfg.n_mels
        self.audio_on_device = bool(cfg.device_audio)
        # set_audio_arena: device-audio samples then carry int32 (offset,
        # n_valid) into the wav arena instead of the raw window
        self.wav_arena = None

        self._load_split()

        self.use_mask = "M" in cfg.modality
        self.use_audio = "A" in cfg.modality.split(";")
        self.modes = ["clip", "audio_features"]
        # set_frame_dedup: samples carry clip_keys, and DataLoader calls
        # assemble_batch once per batch
        self.frame_dedup = False

        # decoded-frame LRU: overlapping dilated windows re-read each frame
        # up to clip_len times during sequential sweeps; caching decoded
        # frames bounds JPEG decode to ~1x per frame
        self._decode_cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._cache_lock = threading.Lock()
        self.decode_cache_size = 4096

    def _open_native(self, images: str, masks: str) -> None:
        """Bind the native reader to the image (and mask) stores that
        exist. Raises, with the compiler's output, when the reader cannot
        be built."""
        if self.env_image is not None:
            self.native_image = NativeFrameStore(
                images, n_threads=self.cfg.host_threads)
        if self.env_mask is not None:
            self.native_mask = NativeFrameStore(
                masks, n_threads=self.cfg.host_threads)

    def _load_split(self) -> None:
        """Load (or build) the split arrays. Aff2TestDataset overrides this
        to read the test pickle directly, so a test-only box never triggers
        the train-split bootstrap (reference testset.py:64-68 contract)."""
        cfg = self.cfg
        cache = os.path.join(cfg.cache_dir, f"split_dict_{self.task}.pkl")
        if not os.path.isfile(cache):
            split = create_dataset_split(cfg.root, save_dir=cfg.cache_dir)
            split = split[self.task]
        else:
            with open(cache, "rb") as f:
                split = pickle.load(f)
        self.time_stamps = split["timestamp"]
        self.image_path = list(split["image_path"])
        self.train_ids = np.asarray(split["train"])
        self.val_ids = np.asarray(split["val"])
        self.test_ids = np.asarray(split.get("test",
                                             np.zeros_like(self.train_ids)))
        self.video_db_nr = np.asarray(split["video_db_nr"])

    # -- reference setters (aff2compdataset.py:104-112) ----------------------
    def set_modes(self, modes):
        self.modes = list(modes)

    def set_aug(self, aug: bool):
        """Host AutoAugment: the dataset never augments, so ``False`` is
        the only setting and changes nothing."""
        if aug:
            raise NotImplementedError(
                _NOT_PORTED.format("host (PIL) augmentation", "queue A10")
                + "; train with --device_augment")

    def set_frame_dedup(self, on: bool):
        """Unique-frame batches: samples carry ``clip_keys`` and the
        loader assembles ``frames`` (U_pad, H, W, C) + ``clip_idx`` (B, T)
        per batch (``assemble_batch``); the train step expands the windows
        with one gather. Overlapping dilated windows then cost one decode
        and one frame of host-to-device copy each instead of clip_len of
        both. Host augmentation is per sample, so callers gate this on
        ``cfg.device_augment``."""
        self.frame_dedup = bool(on)

    def set_audio_arena(self, arena) -> None:
        """Switch device-audio samples to arena offsets
        (data/wav_arena.py): int32 ``audio_ofs`` / ``audio_len`` instead of
        the raw (1, sample_len) float32 window, so no wav read per sample
        and 1.76 MB less host-to-device copy per clip. None reverts to
        shipping windows."""
        self.wav_arena = arena

    # -- store access ---------------------------------------------------------
    def _store_key(self, video_frame: str) -> str:
        video_name = os.path.dirname(video_frame)
        frame_name = os.path.basename(video_frame)
        video_name = self.video2orignal.get(video_name, video_name)
        return video_name + "/" + frame_name

    def get_label(self, video_frame: str, task: str) -> np.ndarray:
        """Sentinels on miss: AU -1x12 int8, EX -1x1 int8, VA -5.0x2 f32
        (aff2compdataset.py:249-289)."""
        key = self._store_key(video_frame)
        if task == "au":
            buf = self.env_au.get(key) if self.env_au is not None else None
            return (np.frombuffer(buf, np.int8).copy() if buf is not None
                    else -1 * np.ones(12, np.int8))
        if task == "ex":
            buf = self.env_ex.get(key) if self.env_ex is not None else None
            return (np.frombuffer(buf, np.int8).copy() if buf is not None
                    else -1 * np.ones(1, np.int8))
        if task == "va":
            buf = self.env_va.get(key) if self.env_va is not None else None
            return (np.frombuffer(buf, np.float32).copy() if buf is not None
                    else -5.0 * np.ones(2, np.float32))
        raise ValueError(task)

    # -- clip assembly (aff2compdataset.py:114-175) ---------------------------
    def _clip_keys(self, index: int) -> list[str | None]:
        """Store keys of the dilated window ending at ``index``; None where
        the frame stays black (out of range / different video)."""
        video_db_nr = self.video_db_nr[index]
        lo = index - self.label_frame + self.dilation
        hi = index - self.label_frame + self.dilation * (self.clip_len + 1)
        keys: list[str | None] = []
        for all_i in range(lo, hi, self.dilation):
            if (all_i < 0 or all_i >= len(self)
                    or self.video_db_nr[all_i] != video_db_nr):
                keys.append(None)
            else:
                keys.append(self._store_key(self.image_path[all_i]))
        return keys

    def _cache_get(self, key: str) -> np.ndarray | None:
        with self._cache_lock:
            c = self._decode_cache
            frame = c.get(key)
            if frame is not None:
                c.move_to_end(key)
            return frame

    def _cache_put(self, key: str, frame: np.ndarray) -> None:
        with self._cache_lock:
            c = self._decode_cache
            c[key] = frame
            if len(c) > self.decode_cache_size:
                c.popitem(last=False)

    def _decode_into(self, reader, keys, prefix: str, channels: int):
        """The decoded frame of each key, None where it stays black: LRU
        hits (keys namespaced by ``prefix``), and one batched native
        decode of the misses, which are cached; a key missing from the
        store stays black (the reader reports ok=False)."""
        h, w = self.input_size
        got = [None if k is None else self._cache_get(prefix + k)
               for k in keys]
        miss = [i for i, (k, f) in enumerate(zip(keys, got))
                if k is not None and f is None]
        if miss:
            frames, ok = reader.decode_batch([keys[i] for i in miss], h, w,
                                             channels)
            for j, i in enumerate(miss):
                if ok[j]:
                    self._cache_put(prefix + keys[i], frames[j])
                    got[i] = frames[j]
        return got

    def _fill(self, out: np.ndarray, keys: list[str | None]) -> None:
        """Decode the frames of ``keys`` into the rows of ``out`` (the
        mask into channel 3 under ``V;M``); a None key leaves its row
        black."""
        if self.native_image is None:
            raise FileNotFoundError(
                f"no image store under {self.cfg.lmdb_label_dir}: the port "
                "reads frames from FrameStores only")
        for i, frame in enumerate(
                self._decode_into(self.native_image, keys, "", 3)):
            if frame is not None:
                out[i, :, :, 0:3] = frame
        if self.use_mask and self.native_mask is not None:
            # masks ride the same LRU as the RGB frames ("m:" keys), so
            # overlapping windows reuse decoded masks
            for i, mask in enumerate(
                    self._decode_into(self.native_mask, keys, "m:", 1)):
                if mask is not None:
                    out[i, :, :, 3] = mask[:, :, 0]

    def get_clip(self, index: int) -> np.ndarray:
        h, w = self.input_size
        clip = np.zeros((self.clip_len, h, w, 4 if self.use_mask else 3),
                        np.uint8)
        self._fill(clip, self._clip_keys(index))
        return clip

    # -- frame-dedup batch assembly -------------------------------------------
    def assemble_batch(self, samples: list[dict]) -> dict:
        """The collate of frame-dedup batches: the B*T window keys become
        a pool of unique frames, and the batch carries

          frames   (U_pad, H, W, C) uint8; slot 0 stays black (the frame of
                   an out-of-range or other-video window position); U_pad
                   rounds up to 64, as in the JAX package, whose expander
                   compiles one program per size
          clip_idx (B, T) int32: window -> pool slot; 0 where the dense
                   clip's frame is black

        ``frames[clip_idx]`` equals the dense ``get_clip`` per sample,
        bitwise. Decoding goes through the LRU, with one native batched
        decode of the misses."""
        from .samplers import collate
        h, w = self.input_size
        key_slot: dict[str, int] = {}
        clip_idx = np.zeros((len(samples), self.clip_len), np.int32)
        for b, s in enumerate(samples):
            for t, k in enumerate(s.pop("clip_keys")):
                if k is not None:
                    # slot 0 stays black
                    clip_idx[b, t] = key_slot.setdefault(k, len(key_slot) + 1)
        u_pad = max(64, -(-(len(key_slot) + 1) // 64) * 64)
        frames = np.zeros((u_pad, h, w, 4 if self.use_mask else 3),
                          np.uint8)
        self._fill(frames[1:], list(key_slot))
        out = collate(samples)
        out["frames"] = frames
        out["clip_idx"] = clip_idx
        return out

    # -- audio (aff2compdataset.py:214-247) -----------------------------------
    def _wav_path(self, video_id: str) -> str:
        return os.path.join(self.video_dir, video_id + ".wav")

    def _load_window(self, video_id: str, index: int) -> np.ndarray:
        """The (1, n) window of the label frame's audio, zeros(1, 441000)
        on any read failure or an empty window (the reference's zero-audio
        fallback, aff2compdataset.py:227-232)."""
        offset, n = audio_host.audio_window_params(
            self.time_stamps[index], self.sample_rate, self.sample_len_frames,
            self.audio_shift_samples)
        try:
            audio, _sr = audio_host.load_wav(self._wav_path(video_id),
                                             offset=offset, num_samples=n)
            if audio.shape[0] > 1:
                audio = audio[:1]
        except (OSError, EOFError, ValueError):
            audio = np.zeros((1, self.sample_len_frames), np.float32)
        if audio.shape[1] == 0:
            audio = np.zeros((1, self.sample_len_frames), np.float32)
        return audio

    def get_audio_feature(self, video_id: str, index: int):
        """(features (1, 64, 1001), right-aligned audio (1, 441000)) by the
        strict-parity host pipeline."""
        return audio_host.reference_audio_features(
            self._load_window(video_id, index), self.sample_len_secs,
            self.cfg.window_stride, self.sample_len_frames, self.n_mels)

    def get_audio_window(self, video_id: str, index: int
                         ) -> tuple[np.ndarray, int]:
        """Raw audio window for the device mel frontend
        (``cfg.device_audio``): (1, sample_len_frames) float32 with the
        true samples LEFT-aligned (zeros after) plus the valid sample
        count; ``make_infer_fn`` rebuilds the reference's right-aligned
        feature layout on the device (``reflect_end_patch`` + the
        left-aligned ``audio_frontend``)."""
        audio = self._load_window(video_id, index)
        n_valid = audio.shape[1]
        buf = np.zeros((1, self.sample_len_frames), np.float32)
        buf[:, :n_valid] = audio
        return buf, n_valid

    def __getitem__(self, index: int) -> dict:
        data = {"Index": index}
        video_id = os.path.dirname(self.image_path[index])
        current = self.image_path[index]
        if self.frame_dedup:
            data["clip_keys"] = self._clip_keys(index)
        else:
            data["clip"] = self.get_clip(index)  # uint8 (T,H,W,C)
        data["AU"] = self.get_label(current, "au")
        data["EX"] = self.get_label(current, "ex")
        data["VA"] = self.get_label(current, "va")

        if self.use_audio and "audio_features" in self.modes:
            if self.audio_on_device and self.wav_arena is not None:
                ofs, n_valid = self.wav_arena.window(
                    video_id, self.time_stamps[index], self.sample_rate,
                    self.audio_shift_samples)
                data["audio_ofs"] = np.int32(ofs)
                data["audio_len"] = np.int32(n_valid)
            elif self.audio_on_device:
                audio, n_valid = self.get_audio_window(video_id, index)
                data["audio"] = audio
                data["audio_len"] = np.int32(n_valid)
            else:
                feats, audio = self.get_audio_feature(video_id, index)
                data["audio_features"] = feats
                data["audio"] = audio
        return data

    def __len__(self):
        return len(self.image_path)
