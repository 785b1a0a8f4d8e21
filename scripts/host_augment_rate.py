#!/usr/bin/env python3
"""Time the port's host AutoAugment against the JAX package's (PIL) on the
same clips, in one thread, on the CPU:

    JAX_PLATFORMS=cpu python scripts/host_augment_rate.py [--repeats 7]

Each repeat augments one batch of 64 clips of 16 uniform-noise 112x112
frames with ``auformer_torch.data.transforms.train_augment`` and with
``auformer.data.transforms.train_augment`` (needs PIL), in turns, with the
same ``random.Random`` seeds on both sides; it prints the ms per batch of
each repeat, their minimum and median, and whether every clip is
byte-equal. With ``--c9`` it also prints how far the JAX package's device
shear and autocontrast (``auformer/ops/augment_device.py``) lie from PIL's
on the same noise frames (ROADMAP C9): the share of differing pixels and
the largest difference, at every magnitude of the table and both signs.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--clips", type=int, default=64)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--c9", action="store_true")
    args = ap.parse_args()

    from auformer.data import transforms as pil
    from auformer_torch.data import transforms as port

    clips = [np.random.RandomState(i).randint(
        0, 256, (args.frames, args.size, args.size, 3)).astype(np.uint8)
        for i in range(args.clips)]
    ms: dict[str, list[float]] = {"port": [], "pil": []}
    equal = True
    for rep in range(args.repeats):
        out = {}
        for name, augment in (("pil", pil.train_augment),
                              ("port", port.train_augment)):
            batch = [c.copy() for c in clips]
            t0 = time.perf_counter()
            out[name] = [augment(c, random.Random((rep << 32) ^ i))
                         for i, c in enumerate(batch)]
            ms[name].append((time.perf_counter() - t0) * 1e3)
        equal &= all(np.array_equal(a, b)
                     for a, b in zip(out["port"], out["pil"]))
    print(json.dumps({
        "clips": args.clips, "frames": args.frames, "size": args.size,
        "ms_per_batch": ms,
        "min_ms": {k: min(v) for k, v in ms.items()},
        "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
        "byte_equal": bool(equal)}))
    if args.c9:
        noise = clips[0][:12]
        print(json.dumps(jax_device_against_pil(noise, noise % 106)))
    return 0 if equal else 1


def jax_device_against_pil(noise: np.ndarray, narrow: np.ndarray) -> dict:
    """The JAX package's device shear (on the ``noise`` frames) and
    autocontrast (on the ``narrow``-range frames, which it stretches)
    against PIL's host op: per op, the least and most shares of differing
    pixel values over the table's magnitudes and signs, and the largest
    difference in levels."""
    import jax.numpy as jnp
    from PIL import Image

    from auformer.data import transforms as pil
    from auformer.ops import augment_device as jax_device

    def pil_op(frames, op, magnitude, sign):
        rng = random.Random(0)
        rng.choice = lambda seq: sign
        return np.stack([np.asarray(pil._apply_op(Image.fromarray(f), op,
                                                  magnitude, rng))
                         for f in frames])

    out = {}
    for op in ("shearX", "shearY", "autocontrast"):
        shares, worst = [], 0
        for magnitude in pil._RANGES[op][1:] if op != "autocontrast" \
                else [0]:
            for sign in ((-1, 1) if op != "autocontrast" else (1,)):
                frames = narrow if op == "autocontrast" else noise
                want = pil_op(frames, op, magnitude, sign)
                got = np.asarray(jax_device.OP_FNS[op](
                    jnp.asarray(frames), magnitude * sign))
                d = np.abs(got.astype(int) - want)
                shares.append(float((d > 0).mean()))
                worst = max(worst, int(d.max()))
        out[op] = {"share_min": min(shares), "share_max": max(shares),
                   "max_levels": worst}
    return out


if __name__ == "__main__":
    sys.exit(main())
