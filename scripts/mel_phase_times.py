#!/usr/bin/env python3
"""Where the time of one log-mel kernel call goes, on one CUDA GPU.

    python3 scripts/mel_phase_times.py [--batch 8]

Builds auformer_torch/csrc/mel.cu a second time with -DMEL_PHASE_TIMES
(through ops/build.py, hashed like the regular build), which makes thread
0 of every CTA stamp the GPU's global timer (ns) as it reaches each phase,
runs it on random audio (all frames valid) after a
warm-up, checks its output against the regular kernel, and prints one JSON
line: the call's event time, and the median over CTAs of each phase's
length (frames assembled, DFT and mel sums, the cluster's partial-sum swap,
dB and arrival), plus how long after the last arrival the floor pass ends.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("frames", "dft_and_mel", "swap", "db_and_arrival")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mel_phase_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from auformer_torch.ops import audio_kernel, build

    lib = audio_kernel.mel_library(("MEL_PHASE_TIMES",))
    lib.mel_phase_times.argtypes = [ctypes.c_void_p]
    lib.mel_phase_times.restype = ctypes.c_int

    dev = torch.device("cuda")
    b = args.batch
    basis, melfb, ranges = audio_kernel._device_tables(dev)
    audio = torch.from_numpy((np.random.RandomState(0).randn(b, 441000) * 0.1
                              ).astype(np.float32)).to(dev)
    flen = torch.full((b,), 1001, dtype=torch.int32, device=dev)
    out = torch.empty((b, 64, 1001), device=dev)
    max_key = torch.full((b,), -2 ** 31, dtype=torch.int32, device=dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        build.check(lib.mel_frontend_forward(
            audio.data_ptr(), basis.data_ptr(), melfb.data_ptr(),
            ranges.data_ptr(), flen.data_ptr(), out.data_ptr(),
            max_key.data_ptr(), count.data_ptr(), b, stream), "mel kernel")

    for _ in range(5):
        call()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(20):
        call()
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / 20
    call()
    torch.cuda.synchronize()
    ctas = 16 * b
    stamps = np.zeros((16 * 64, 6), np.uint64)
    build.check(lib.mel_phase_times(stamps.ctypes.data_as(ctypes.c_void_p)),
                "reading the phase stamps")
    stamps = stamps[:ctas].astype(np.int64)
    t0 = stamps[:, 0].min()
    lengths = {name: float(np.median(stamps[:, i + 1] - stamps[:, i]) / 1e3)
               for i, name in enumerate(PHASES)}
    floor_end = stamps[:, 5][stamps[:, 5] > t0]
    err = (out - audio_kernel.mel_frontend(audio)[:, 0]).abs().max().item()
    print(json.dumps({
        "batch": b, "event_ms": event_ms, "median_us": lengths,
        "last_arrival_us": float((stamps[:, 4].max() - t0) / 1e3),
        "floor_end_us": float((floor_end.max() - t0) / 1e3),
        "max_abs_diff_vs_kernel": err,
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
