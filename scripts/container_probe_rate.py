"""Time ``container.probe`` on an hour-long Matroska file and an hour-long
fragmented MP4, each of 108,000 tiny frames (30 fps), written by the
tests' writers (auformer_torch.data.fixtures) in a temporary directory.

The frames are 16-byte stand-ins tagged MJPEG (never decoded), so that
``probe`` reads every block or sample and lists every timestamp without a
decoder. The Matroska file has a cluster a second, SimpleBlocks and a key
frame every 30; the fragmented MP4 a fragment of 30 samples a second, each
with its own ``moof``. Prints one JSON line: the files' sizes, the write
seconds and, for each file, the best and all of ``--passes`` probes'
seconds, with the machine's card and power limit where ``nvidia-smi``
answers. Runs on any host (no GPU needed):

    python3 scripts/container_probe_rate.py [--passes 3]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

FRAMES = 108000          # an hour at 30 fps


def card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from auformer_torch.data import container
    from auformer_torch.data.fixtures import (write_fragmented_mp4,
                                              write_matroska)
    frames = [bytes([0xFF, 0xD8]) + k.to_bytes(4, "big") + bytes(10)
              for k in range(FRAMES)]
    keys = [k % 30 == 0 for k in range(FRAMES)]
    out = {"frames": FRAMES, "card": card(), "files": {}}
    with tempfile.TemporaryDirectory() as tmp:
        mkv, mp4 = os.path.join(tmp, "hour.mkv"), os.path.join(tmp,
                                                               "hour.mp4")
        t0 = time.perf_counter()
        write_matroska(mkv, frames, keys,
                       [k * 1000 // 30 for k in range(FRAMES)], "V_MJPEG",
                       64, 64, default_duration=33333333,
                       duration=FRAMES * 1000 / 30, cluster=30)
        dts = [512 * k for k in range(FRAMES)]
        write_fragmented_mp4(mp4, frames, keys, dts, dts, 15360, 64, 64,
                             b"", kind=b"jpeg", truns=1)
        out["write_s"] = time.perf_counter() - t0
        for name, path in (("matroska", mkv), ("fragmented_mp4", mp4)):
            seconds = []
            for _ in range(args.passes):
                t0 = time.perf_counter()
                index = container.probe(path)
                seconds.append(time.perf_counter() - t0)
            if index["packets"] != FRAMES or len(
                    index["timestamps_ms"]) != FRAMES:
                raise SystemExit(f"{name}: {index['packets']} packets")
            out["files"][name] = {"bytes": os.path.getsize(path),
                                  "probe_s": min(seconds),
                                  "probe_s_all": seconds,
                                  "num_frames": index["num_frames"],
                                  "fps": index["fps"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
