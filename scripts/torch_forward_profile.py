#!/usr/bin/env python3
"""Profile full-width avformer forwards of one checkout of the PyTorch port
on one CUDA GPU.

    python3 scripts/torch_forward_profile.py [--root CHECKOUT] [--iters 20]

Imports ``auformer_torch`` from ``--root`` (default: this checkout), so an
older commit unpacked into a git-ignored directory can be measured in the
same call as this one (run them in turns: old, new, new, old). The model,
weights and batch are chip_smoke.py's slice: avformer at B=8, 112x112,
T=16, random reference-layout weights from seed 0. Prints one JSON line
with, for bf16 and fp32: clips/s and wall ms per forward (host clock around
synchronized forwards), device ms and device kernels per forward
(torch.profiler over 3 forwards).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose auformer_torch is measured")
    ap.add_argument("--iters", type=int, default=20,
                    help="forwards per clips/s reading")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_forward_profile: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from auformer_torch.core.config import Config
    from auformer_torch.core.weights import load_weights
    from auformer_torch.infer import make_infer_fn
    from auformer_torch.nn import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = smoke.make_batch(np.random.RandomState(smoke.SEED), smoke.BATCH)
    on_card = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    result = {"root": args.root, "nvidia_smi": smi}
    for dtype in ("bfloat16", "float32"):
        cfg = Config(compute_dtype=dtype, image_size=smoke.IMAGE,
                     n_frames=smoke.FRAMES, batch_size=smoke.BATCH)
        model = build_model(cfg)
        load_weights(model, smoke.random_reference_state_dict(model,
                                                              smoke.SEED))
        infer = make_infer_fn(cfg, model)
        rate = smoke.clips_per_s(torch, infer, on_card, args.iters)
        prof = smoke.profile_forward(torch, infer, on_card)
        result[dtype] = {
            "clips_per_s": rate,
            "wall_ms_per_forward": 1e3 * smoke.BATCH / rate,
            "device_ms_per_forward": prof["device_ms_per_forward"],
            "device_kernels_per_forward": prof["device_kernels_per_forward"],
            "top": prof["top"][:6]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
