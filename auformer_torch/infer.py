"""Inference entry points + submission writers (counterpart of
auformer/infer.py; reference test_aff2.py:46-119).

``run_inference``: batches of uint8 clips and audio go through one forward
each and the per-video demux happens on the host from the returned (B, 21)
blocks. ``run_inference_sweep``: the dense sweep (sweep.py) labels every
frame of whole videos. Both take either arrays the caller decoded or an
``Aff2TestDataset`` (built from ``cfg`` when given neither), and both write
the reference's output files. The entry points run on the card: with no
``device`` they take ``cuda`` and raise when there is none; the CPU runs
the plain versions of the kernels only when asked for with
``device="cpu"``.
"""
from __future__ import annotations

import os
import pickle
from typing import Iterable, Mapping

import numpy as np
import torch

from .core.config import Config
from .data import DataLoader, SubsetSequentialSampler
from .data.testset import Aff2TestDataset
from .nn.registry import compute_autocast, compute_dtype, prepare_inference
from .ops.audio import HOP_LENGTH, audio_frontend, reflect_end_patch
from .ops.preprocess import normalize_clip

AU_HEADER = "AU1,AU2,AU4,AU6,AU7,AU10,AU12,AU15,AU23,AU24,AU25,AU26"
VA_HEADER = "valence,arousal"
EX_HEADER = "Neutral,Anger,Disgust,Fear,Happiness,Sadness,Surprise"


def au_to_str(arr) -> str:
    return ",".join(f"{int(v):d}" for v in arr)


def ex_to_str(v) -> str:
    return f"{int(v):d}"


def va_to_str(v, a) -> str:
    return f"{v:.3f},{a:.3f}"


#: submission dir per task: 'au' matches the reference writer
#: (test_aff2.py:84), 'expr' the dir its postprocess consumes for
#: expressions (postprocess/postprocess.py:51)
_TASK_DIR = {"AU": "au", "EX": "expr", "VA": "va"}


class SubmissionWriter:
    """Per-video txt writers with task headers (test_aff2.py:87-115)."""

    def __init__(self, result_path: str, task: str = "AU"):
        self.dir = os.path.join(result_path, _TASK_DIR[task])
        os.makedirs(self.dir, exist_ok=True)
        self.task = task
        self.header = {"AU": AU_HEADER, "VA": VA_HEADER,
                       "EX": EX_HEADER}[task]
        self._current = None
        self._f = None

    def write(self, video_id: str, line: str) -> None:
        if video_id != self._current:
            if self._f is not None:
                self._f.close()
            self._current = video_id
            self._f = open(os.path.join(self.dir, video_id + ".txt"), "w")
            self._f.write(self.header + "\n")
        self._f.write(line + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class TaskWriters:
    """Every submission writer one inference run can feed: AU rows always
    (reference behavior); EX rows (argmax over logits[:, 12:19]) and VA rows
    (tanh(logits[:, 19:21]), 3 decimals) when ``task`` requests them and the
    model emits the columns."""

    def __init__(self, result_path: str, task: str, width: int):
        self.au = SubmissionWriter(result_path, "AU")
        self.ex = SubmissionWriter(result_path, "EX") \
            if task in ("EX", "ALL") and width >= 19 else None
        self.va = SubmissionWriter(result_path, "VA") \
            if task in ("VA", "ALL") and width >= 21 else None

    def write_rows(self, video_ids, logits: np.ndarray) -> None:
        """Append an (N, width) logits block; ``video_ids`` is one id for
        the whole block or a per-row sequence."""
        if isinstance(video_ids, str):
            video_ids = [video_ids] * len(logits)
        round_au = np.round(
            1.0 / (1.0 + np.exp(-logits[:, :12]))).astype(int)
        ex_pred = np.argmax(logits[:, 12:19], axis=1) \
            if self.ex is not None else None
        va_pred = np.tanh(logits[:, 19:21]) if self.va is not None else None
        for i, vid in enumerate(video_ids):
            vid = str(vid)
            self.au.write(vid, au_to_str(round_au[i]))
            if self.ex is not None:
                self.ex.write(vid, ex_to_str(ex_pred[i]))
            if self.va is not None:
                self.va.write(vid, va_to_str(*va_pred[i]))

    def close(self) -> None:
        for w in (self.au, self.ex, self.va):
            if w is not None:
                w.close()


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names another device; raises when the
    device is CUDA and no GPU is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: auformer_torch runs on the GPU; "
                           "pass device='cpu' to run the plain paths on the "
                           "CPU")
    return device


def make_infer_fn(cfg: Config, model: torch.nn.Module, device=None):
    """Move ``model`` to the device for inference (in place,
    ``prepare_inference``: f32 parameters, under bf16 its convolution and
    Linear weights rounded once), in eval mode, and return ``infer(batch)
    -> (B, 21) float32`` on the device. The model runs under
    ``compute_autocast`` (bf16 by ``cfg.compute_dtype``, as the train step
    does); the audio features are computed outside it, in f32 (the mel
    kernel's DFT in bf16 under ``cfg.mel_bf16``).

    ``batch``: ``clip`` (B, T, H, W, C) uint8, plus one of: precomputed
    ``audio_features`` (B, 1, 64, 1001); under ``cfg.device_audio``, the
    loader's LEFT-aligned raw windows ``audio`` (B, 1, L) or (B, L) with
    ``audio_len`` (B,) valid samples, whose features the device computes
    (``reflect_end_patch`` + the left-aligned frontend, as the JAX
    package's ``prep_batch`` does); or ``audio`` (B, L) float32 raw
    right-aligned audio with optional ``feature_len`` (B,) valid mel
    frames. Arrays may be numpy or tensors.
    """
    device = resolve_device(device)
    dtype = compute_dtype(cfg)
    prepare_inference(cfg, model, device)

    def put(value) -> torch.Tensor:
        return torch.as_tensor(value).to(device)

    @torch.inference_mode()
    def infer(batch: Mapping) -> torch.Tensor:
        if "audio_features" in batch:
            feats = put(batch["audio_features"])
        elif cfg.device_audio and "audio_len" in batch:
            n_valid = put(batch["audio_len"]).reshape(-1).to(torch.int64)
            raw = put(batch["audio"]).float().reshape(n_valid.shape[0], -1)
            feats = audio_frontend(reflect_end_patch(raw, n_valid),
                                   1 + n_valid // HOP_LENGTH,
                                   mel_bf16=cfg.mel_bf16, left_aligned=True)
        else:
            flen = batch.get("feature_len")
            feats = audio_frontend(
                put(batch["audio"]).float().contiguous(),
                None if flen is None else put(flen),
                mel_bf16=cfg.mel_bf16)
        # f32 normalisation, as JAX's prep_batch; the first convolution
        # rounds the clip to the compute dtype
        x = {"clip": normalize_clip(put(batch["clip"])),
             "audio_features": feats.to(dtype)}
        with compute_autocast(cfg, device):
            return model(x).float()

    return infer


def _write_pickle(result_path: str, rows: dict,
                  n_rows: int | None = None) -> np.ndarray:
    """The (n_rows, 21) prediction matrix of ``rows`` (dataset row ->
    logits; n_rows defaults to max row + 1), written to ``inference.pkl``
    as the reference does."""
    if n_rows is None:
        n_rows = max(rows, default=-1) + 1
    output = np.zeros((n_rows, 21), np.float32)
    for idx, row in rows.items():
        output[idx, :len(row)] = row
    os.makedirs(result_path, exist_ok=True)
    with open(os.path.join(result_path, "inference.pkl"), "wb") as f:
        pickle.dump({"predictions": output}, f)
    return output


def _testset(cfg: Config, dataset):
    """The caller's test dataset, else one built from ``cfg``, with the
    synthetic fixtures materialized first under ``--data_backend
    synthetic`` (as the JAX package's entry points do)."""
    if dataset is not None:
        return dataset
    if cfg.data_backend == "synthetic":
        from .data.fixtures import ensure_synthetic
        ensure_synthetic(cfg)
    return Aff2TestDataset(cfg)


def model_inputs(batch: Mapping) -> dict:
    """The entries of a batch that the forward reads (``make_infer_fn``):
    the clip with the host features, or the clip with raw audio and its
    lengths."""
    keys = (("clip", "audio_features") if "audio_features" in batch else
            ("clip", "audio", "feature_len", "audio_len"))
    return {k: np.asarray(batch[k]) for k in keys if k in batch}


def testset_loader(cfg: Config, model: torch.nn.Module,
                   dataset) -> DataLoader:
    """The test split of ``dataset`` in order, in batches of
    ``cfg.batch_size`` from the threaded loader, with the model's inputs
    switched on."""
    dataset.set_modes(list(model.modes))
    ids = np.nonzero(dataset.test_ids)[0]
    return DataLoader(dataset, max(cfg.batch_size, 1),
                      SubsetSequentialSampler(ids),
                      num_threads=cfg.host_threads, drop_last=False,
                      prefetch_batches=cfg.prefetch_depth)


def run_inference(cfg: Config, model: torch.nn.Module,
                  batches: Iterable[Mapping] | None = None,
                  result_path: str = "results", device=None,
                  dataset: Aff2TestDataset | None = None) -> np.ndarray:
    """Run every batch dict (model inputs as in ``make_infer_fn`` plus
    ``Index`` (B,) dataset rows and ``video_id`` (B,) strings), write
    per-video AU txts + ``inference.pkl``, and return the prediction
    matrix: (max Index + 1, 21) for ``batches``; (len(dataset), 21) when
    ``batches`` is None and the batches come from the test split of
    ``dataset`` (or of the ``Aff2TestDataset`` of ``cfg``) through the
    threaded ``DataLoader``. A batch shorter than the batch size
    (``cfg.batch_size``) is padded with copies of its last row, as the JAX
    package pads to its static shape."""
    infer = make_infer_fn(cfg, model, device)
    batch_size = max(cfg.batch_size, 1)
    n_rows = None
    if batches is None:
        dataset = _testset(cfg, dataset)
        n_rows = len(dataset)
        batches = testset_loader(cfg, model, dataset)
    writers = TaskWriters(result_path, cfg.task, width=21)
    rows: dict[int, np.ndarray] = {}
    try:
        for batch in batches:
            x = model_inputs(batch)
            n = len(batch["Index"])
            if n < batch_size:
                pad = batch_size - n
                x = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                     for k, v in x.items()}
            result = infer(x)[:n].cpu().numpy()
            for i, idx in enumerate(np.asarray(batch["Index"])):
                rows[int(idx)] = result[i]
            writers.write_rows([str(v) for v in batch["video_id"]], result)
    finally:
        writers.close()

    return _write_pickle(result_path, rows, n_rows)


#: clips per grouped fetch of ``run_inference_sweep``'s default branch
FETCH_GROUP_CLIPS = 16384


def host_feature_videos(dataset, image_size: int):
    """The test videos of ``dataset`` as strict-parity sweep items: frames
    by the native reader, per-window host features (``get_audio_feature``,
    the reference-exact numpy pipeline)."""
    from .serve import decode_video_frames

    test_idx = np.nonzero(dataset.test_ids)[0]
    for video_nr in np.unique(dataset.video_db_nr[test_idx]):
        vid_idx = test_idx[dataset.video_db_nr[test_idx] == video_nr]
        video_id = os.path.dirname(dataset.image_path[vid_idx[0]])
        feats = np.stack([dataset.get_audio_feature(video_id, int(i))[0]
                          for i in vid_idx]).astype(np.float32)
        yield dict(video_id=video_id, Index=vid_idx, audio_features=feats,
                   frames=decode_video_frames(dataset, vid_idx, image_size,
                                              image_size))


def run_inference_sweep(cfg: Config, model: torch.nn.Module,
                        videos: Iterable[Mapping] | None = None,
                        result_path: str = "results",
                        bucket: int | None = None,
                        device=None,
                        dataset: Aff2TestDataset | None = None
                        ) -> np.ndarray:
    """Dense-sweep inference over whole videos (sweep.py): the trunk once
    per frame and every label frame's window scored through the temporal,
    audio and fusion heads, with the same logits as ``run_inference``.

    Each item of ``videos`` is one video: ``video_id`` (str), ``Index``
    (N,) dataset rows, ``frames`` (N, H, W, 3) uint8, ``wav`` (L,) float32
    mono and ``timestamps_ms`` (N,). With ``cfg.strict_parity`` the item
    carries ``audio_features`` (N, 1, 64, 1001) host features instead of
    ``wav`` and ``timestamps_ms``, and ``sweep_video`` runs on them.
    Otherwise each video is dispatched (``dispatch_video``: audio computed
    on the device from one wav upload) and the logits come back with one
    grouped ``fetch_many`` per ``FETCH_GROUP_CLIPS`` clips.

    With ``videos`` None the test split of ``dataset`` (or of the
    ``Aff2TestDataset`` of ``cfg``) is swept: through
    ``serve.sweep_stream`` (one-ahead decode, in a worker process from
    ``serve.WORKER_MIN_CLIPS`` test clips), or under ``cfg.strict_parity``
    through ``host_feature_videos``.

    Writes per-video AU txts + ``inference.pkl`` and returns the
    prediction matrix, the AU columns filled: (max Index + 1, 21) for
    ``videos``, (len(dataset), 21) for a dataset.
    """
    from .sweep import default_sweep_bucket, make_sweep

    device = resolve_device(device)
    sweep = make_sweep(cfg, model, device=device)
    bucket = bucket or default_sweep_bucket(device)
    n_rows = None
    stream = None
    if videos is None:
        dataset = _testset(cfg, dataset)
        n_rows = len(dataset)
        if cfg.strict_parity:
            videos = host_feature_videos(dataset, cfg.image_size)
        else:
            from .serve import sweep_stream
            stream = sweep_stream(cfg, model, dataset=dataset, bucket=bucket,
                                  sweep=sweep)
    writers = TaskWriters(result_path, cfg.task, width=sweep.out_dim)
    rows: dict[int, np.ndarray] = {}

    def emit(video_id: str, index, logits: np.ndarray) -> None:
        for idx, row in zip(np.asarray(index), logits):
            rows[int(idx)] = row
        writers.write_rows(str(video_id), logits)

    pending: list = []

    def drain() -> None:
        outs = sweep.fetch_many([handle for _, handle in pending])
        for (video, _), logits in zip(pending, outs):
            emit(video["video_id"], video["Index"], logits)
        pending.clear()

    try:
        if stream is not None:
            for vid_idx, video_id, logits in stream:
                emit(video_id, vid_idx, logits)
        else:
            for video in videos:
                if cfg.strict_parity:
                    emit(video["video_id"], video["Index"], sweep.sweep_video(
                        np.asarray(video["frames"]),
                        np.asarray(video["audio_features"], np.float32),
                        batch=bucket))
                    continue
                pending.append((video, sweep.dispatch_video(
                    np.asarray(video["frames"]), wav=video["wav"],
                    timestamps_ms=video["timestamps_ms"], batch=bucket)))
                if sum(h[0] for _, h in pending) >= FETCH_GROUP_CLIPS:
                    drain()
            drain()
    finally:
        if stream is not None:
            stream.close()      # ends the fetch thread and the worker
        writers.close()
    return _write_pickle(result_path, rows, n_rows)
