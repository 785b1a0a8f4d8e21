"""Seconds of chip_smoke.py's dataset phase (the test split written by the
port's fixtures, test_aff2 over it, the dataset-fed checks, and the packed
part) at two sizes of its split, in turns on one card: a 4,000-label-frame
split (videos of 2,100, 1,200 and 700 frames) and chip_smoke's own
``DATASET_FRAMES``. Every check of the phase runs at both sizes. Run from
the root of a checkout on a machine with a CUDA card:

    python3 scripts/dataset_split_times.py [--rounds 1]

Each round runs the larger split, the smaller, the smaller again and the
larger again; each run prints chip_smoke's own ``dataset`` and ``packed``
lines, and the script ends with one JSON line: the card's name and power
limit, and each split's phase seconds (dataset with its packed part, and
the fixture write alone) in the order run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LARGER = (2100, 1200, 700)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dataset_split_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    chip_smoke.phase_build()
    smaller = chip_smoke.DATASET_FRAMES
    runs = []
    for _ in range(args.rounds):
        for frames in (LARGER, smaller, smaller, LARGER):
            chip_smoke.DATASET_FRAMES = frames
            lines = []
            emit = chip_smoke.emit

            def keep(phase, **fields):
                lines.append((phase, fields))
                emit(phase, **fields)
            chip_smoke.emit = keep
            t0 = time.perf_counter()
            try:
                _, _, split = chip_smoke.phase_dataset(torch, dev)
            finally:
                chip_smoke.emit = emit
            seconds = time.perf_counter() - t0
            fields = dict(lines)
            runs.append({"videos": list(frames), "s": seconds,
                         "dataset_s": fields["dataset"]["phase_s"],
                         "packed_s": fields["packed"]["phase_s"],
                         "fixture_s": fields["dataset"]["fixture_s"]})
            chip_smoke.shutil.rmtree(split["work"], ignore_errors=True)
    print(json.dumps({"card": chip_smoke.nvidia_smi(), "runs": runs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
