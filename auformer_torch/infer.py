"""Clip-batch inference + submission writers (counterpart of
auformer/infer.py; reference test_aff2.py:46-119).

Batches of uint8 clips and raw audio go through one forward each and the
per-video demux happens on the host from the returned (B, 21) blocks, with
the reference's output files. The entry points run on the card: with no
``device`` they take ``cuda`` and raise when there is none; the CPU runs the
plain versions of the kernels only when asked for with ``device="cpu"``.
"""
from __future__ import annotations

import os
import pickle
from typing import Iterable, Mapping

import numpy as np
import torch

from .core.config import Config
from .nn.registry import compute_dtype
from .ops.audio import audio_frontend
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


def _resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names another device; raises when the
    device is CUDA and no GPU is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: auformer_torch runs on the GPU; "
                           "pass device='cpu' to run the plain paths on the "
                           "CPU")
    return device


def make_infer_fn(cfg: Config, model: torch.nn.Module, device=None):
    """Move ``model`` to the device in ``cfg.compute_dtype`` (in place), in
    eval mode, and return ``infer(batch) -> (B, 21) float32`` on the device.

    ``batch``: ``clip`` (B, T, H, W, C) uint8, plus either ``audio``
    (B, L) float32 raw right-aligned audio with optional ``feature_len``
    (B,) valid mel frames, or precomputed ``audio_features`` (B, 1, 64, 1001).
    Arrays may be numpy or tensors.
    """
    device = _resolve_device(device)
    dtype = compute_dtype(cfg)
    model.to(device=device, dtype=dtype).eval()

    def put(value) -> torch.Tensor:
        return torch.as_tensor(value).to(device)

    @torch.inference_mode()
    def infer(batch: Mapping) -> torch.Tensor:
        if "audio_features" in batch:
            feats = put(batch["audio_features"])
        else:
            flen = batch.get("feature_len")
            feats = audio_frontend(
                put(batch["audio"]).float().contiguous(),
                None if flen is None else put(flen),
                mel_bf16=cfg.mel_bf16)
        x = {"clip": normalize_clip(put(batch["clip"]), dtype=dtype),
             "audio_features": feats.to(dtype)}
        return model(x).float()

    return infer


def run_inference(cfg: Config, model: torch.nn.Module,
                  batches: Iterable[Mapping], result_path: str = "results",
                  device=None) -> np.ndarray:
    """Run every batch dict (model inputs as in ``make_infer_fn`` plus
    ``Index`` (B,) dataset rows and ``video_id`` (B,) strings), write
    per-video AU txts + ``inference.pkl``, and return the
    (max Index + 1, 21) prediction matrix. A batch shorter than
    ``cfg.batch_size`` is padded with copies of its last row, as the JAX
    package pads to its static shape."""
    infer = make_infer_fn(cfg, model, device)
    batch_size = max(cfg.batch_size, 1)
    writers = TaskWriters(result_path, cfg.task, width=21)
    rows: dict[int, np.ndarray] = {}
    try:
        for batch in batches:
            keys = [k for k in ("clip", "audio", "feature_len",
                                "audio_features") if k in batch]
            x = {k: np.asarray(batch[k]) for k in keys}
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

    output = np.zeros((max(rows, default=-1) + 1, 21), np.float32)
    for idx, row in rows.items():
        output[idx] = row
    os.makedirs(result_path, exist_ok=True)
    with open(os.path.join(result_path, "inference.pkl"), "wb") as f:
        pickle.dump({"predictions": output}, f)
    return output
