#!/usr/bin/env python3
"""avformer's training epoch with the AutoAugment on the card against the
loader's host AutoAugment, in one fresh process on one GPU:

    python3 scripts/host_aug_order.py

On chip_smoke.py's train split (written here under .cache/host_aug_order
and removed at the end), one epoch of ``train.main --device_audio
--locality_run 64 --host_threads 4`` (B=64, bf16, full width) in the order
(d) ``--device_augment``, (h) host augmentation, (h) again, (d) again, then
8 steps of (h) augmenting in the loader's threads instead of the worker
pool, and chip_smoke's CPU numbers (``host_augment_cpu``). One line per
run: clips/s, StepTimer data and step ms, epoch seconds. The first run
pays the process's warm-up, whichever it is.
"""
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from auformer_torch.data.fixtures import (  # noqa: E402
    generate_synthetic_dataset)

if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("host_aug_order: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    work = cs.ROOT / ".cache" / "host_aug_order"
    shutil.rmtree(work, ignore_errors=True)
    generate_synthetic_dataset(
        str(work / "root"), str(work / "labels"),
        n_videos=len(cs.TRAIN_FRAMES), frames_per_video=cs.TRAIN_FRAMES,
        image_size=cs.IMAGE, seed=cs.SEED, with_masks=False,
        splits=["train", "train", "val", "test"])
    flags = ("--device_audio", "--locality_run", str(cs.FEED_RUN),
             "--host_threads", "4")
    for name, device_augment in (("d1", True), ("h1", False), ("h2", False),
                                 ("d2", True)):
        r, _, _ = cs.feed_run(torch, work, "exp_" + name, *flags,
                              device_augment=device_augment)
        print("RUN", name, r["clips_per_s"], r["step_timer_ms"],
              r["epoch_s"], flush=True)
    print("RUN in_thread", cs.in_thread_run(torch, work, flags), flush=True)
    print("RUN cpu", cs.host_augment_cpu(work), flush=True)
    shutil.rmtree(work, ignore_errors=True)
