#!/usr/bin/env python3
"""Train avformer on the training feed with one checkout of the PyTorch
port on one CUDA GPU: clips/s per epoch.

    python3 scripts/train_feed_rate.py [--root CHECKOUT] [--epochs 2]
        [--steps_per_dispatch K] [--split DIR]

Imports ``auformer_torch`` from ``--root`` (default: this checkout), so an
older commit unpacked into a git-ignored directory can be measured in the
same call as this one (run them in turns: old, new, new, old). The split
is chip_smoke.py's train split (videos of 1,500, 1,500, 600 and 100
frames, 112x112 JPEG; 23 steps of 64 clips per epoch), written by
``--root``'s fixtures into ``--split`` when it holds none and reused
after. The run is ``python -m auformer_torch.train`` (its ``main``) with
chip_smoke's train flags (B=64, bf16, --device_augment, downsample 2) and
the feed's (--frame_dedup --device_audio --locality_run 64), for
``--epochs`` epochs, with ``--steps_per_dispatch K`` when given (leave it
out for a checkout that predates the flag). Prints one JSON line: per
epoch clips/s, StepTimer data and step ms and loss; peak memory; the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose auformer_torch is measured")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--steps_per_dispatch", type=int, default=None)
    ap.add_argument("--split", default=str(HERE / ".cache" / "feed_split"),
                    help="directory of the train split (written once)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_feed_rate: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from auformer_torch import train
    from auformer_torch.data.fixtures import generate_synthetic_dataset

    split = Path(args.split)
    if not (split / "labels").is_dir():
        generate_synthetic_dataset(
            str(split / "root"), str(split / "labels"),
            n_videos=len(smoke.TRAIN_FRAMES),
            frames_per_video=smoke.TRAIN_FRAMES, image_size=smoke.IMAGE,
            seed=smoke.SEED, with_masks=False,
            splits=["train", "train", "val", "test"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags = ["--epochs", str(args.epochs), "--frame_dedup", "--device_audio",
             "--locality_run", str(smoke.FEED_RUN)]
    if args.steps_per_dispatch is not None:
        flags += ["--steps_per_dispatch", str(args.steps_per_dispatch)]
    exp = f"exp_{os.getpid()}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, history = train.main(smoke.train_argv(split, exp, *flags))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    shutil.rmtree(split / exp, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": args.root, "steps_per_dispatch": args.steps_per_dispatch,
        "nvidia_smi": smi, "seconds": seconds,
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "epochs": [{"clips_per_s": h["steps"] * smoke.TRAIN_BATCH
                    / h["seconds"], "steps": h["steps"],
                    "step_timer_ms": {"data": h["data_ms"],
                                      "step": h["step_ms"]},
                    "loss": h["loss"]} for h in history]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
