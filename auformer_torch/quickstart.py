"""Quickstart: train + evaluate + infer on a synthetic dataset, on the GPU
(counterpart of examples/quickstart.py).

    python -m auformer_torch.quickstart                  # on the GPU
    python -m auformer_torch.quickstart --cpu            # the plain paths
    python -m auformer_torch.quickstart --workdir DIR    # keep the files

Mirrors the real workflow at toy scale, step for step as the JAX script:
synthetic Aff-Wild2-shaped fixtures (four videos of 40 frames, 64x64:
train, train, val, test) -> vformer AU training for 2 epochs -> test-split
inference with per-video submission files (``results/au/<video>.txt``
and ``results/inference.pkl`` under the work directory).

The ``Config`` is the JAX script's, ``use_pallas=False`` included; the
port reads ``use_pallas`` nowhere (core/config.py): CUDA tensors always
take the hand-written kernels, so on the card both training and
inference run the attention kernel (csrc/attention.cu), where the JAX
script on the CPU runs no Pallas kernel. Without ``--cpu`` the device is
``cuda``, and without a GPU the run raises (``infer.resolve_device``); it
never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from . import train_lib
from .core.config import Config
from .data.fixtures import generate_synthetic_dataset
from .infer import resolve_device, run_inference


def make_dataset(work: str) -> None:
    """Write the synthetic dataset under ``work/root`` and ``work/labels``."""
    generate_synthetic_dataset(os.path.join(work, "root"),
                               os.path.join(work, "labels"), n_videos=4,
                               frames_per_video=40, image_size=64,
                               audio_secs=2.0)


def quickstart_config(work: str) -> Config:
    """examples/quickstart.py's configuration, on the paths under ``work``."""
    return Config(root=os.path.join(work, "root"),
                  lmdb_label_dir=os.path.join(work, "labels"),
                  cache_dir=os.path.join(work, "cache"),
                  exp_dir=os.path.join(work, "exp"),
                  model_name="vformer", modality="V", task="AU",
                  n_frames=4, dilation=2, image_size=64, batch_size=8,
                  downsample_rate=1, epochs=2, eval_batch_mult=1,
                  compute_dtype="float32", use_pallas=False)


def train(cfg: Config, device) -> tuple:
    """Train for ``cfg.epochs``, print the history; (state, history)."""
    state, history = train_lib.train(cfg, device=device)
    print("training history:")
    for h in history:
        print(f"  epoch {h['epoch']}: loss {h['loss']:.4f} "
              f"AU score {h['scores']['AU']['score']:.4f}")
    return state, history


def infer(cfg: Config, model, work: str, device) -> np.ndarray:
    """Test-split inference into ``work/results``; the (N, 21) matrix."""
    results = os.path.join(work, "results")
    out = run_inference(cfg, model, result_path=results, device=device)
    print(f"inference: {out.shape} predictions; submission files under "
          f"{os.path.join(results, 'au')}")
    return out


def run(work: str, device) -> tuple[list, np.ndarray]:
    """The dataset, 2 epochs and inference under ``work``; (history,
    predictions). The trained weights are ``exp/pretrain/latest.pth``."""
    make_dataset(work)
    cfg = quickstart_config(work)
    state, history = train(cfg, device)
    return history, infer(cfg, state.model, work, device)


def main(argv: list[str] | None = None) -> tuple[list, np.ndarray, str]:
    """Parse ``argv`` (default: the command line) and run; (history,
    predictions, work directory)."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--workdir", default=None)
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    work = args.workdir or tempfile.mkdtemp(prefix="auformer_quickstart_")
    print(f"workdir: {work}")
    history, predictions = run(work, device)
    return history, predictions, work


if __name__ == "__main__":
    main()
