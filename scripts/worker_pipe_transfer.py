#!/usr/bin/env python3
"""Time the decode worker's reply path: a video's uint8 frames crossing a
``multiprocessing`` pipe from a spawned child to its parent, as
``auformer_torch.serve.DecodeWorker`` sends them (one pickled
``Connection.send`` of the whole reply), against the same bytes sent as
raw chunks (``send_bytes`` / ``recv_bytes_into`` a preallocated array).

    python3 scripts/worker_pipe_transfer.py [--frames 700 1200 2100]

Needs no GPU. Prints one JSON line per video size and route: MB, the best
and all walls over the repeats, MB/s.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import time

import numpy as np

IMAGE = 112
CHUNK = 4 << 20      # bytes per raw message


def _child(conn, sizes) -> None:
    frames = {n: np.random.RandomState(n).randint(
        0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8) for n in sizes}
    conn.send("ready")
    while True:
        req = conn.recv()
        if req is None:
            return
        route, n = req
        a = frames[n]
        if route == "pickle":
            conn.send((np.arange(n), a, 0.0))
        else:
            conn.send(a.shape)
            view = memoryview(a.reshape(-1))
            for off in range(0, a.nbytes, CHUNK):
                conn.send_bytes(view[off:off + CHUNK])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, nargs="+",
                    default=[700, 1200, 2100])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    ctx = mp.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=_child, args=(child, args.frames), daemon=True)
    proc.start()
    child.close()
    assert conn.recv() == "ready"
    print(json.dumps({"cpus": os.cpu_count(), "chunk_bytes": CHUNK}),
          flush=True)
    try:
        for n in args.frames:
            for route in ("pickle", "chunks"):
                walls = []
                for _ in range(args.repeats):
                    t0 = time.perf_counter()
                    conn.send((route, n))
                    if route == "pickle":
                        frames = conn.recv()[1]
                    else:
                        frames = np.empty(conn.recv(), np.uint8)
                        view = memoryview(frames.reshape(-1))
                        for off in range(0, frames.nbytes, CHUNK):
                            conn.recv_bytes_into(view[off:off + CHUNK])
                    walls.append(time.perf_counter() - t0)
                mb = frames.nbytes / 1e6
                print(json.dumps({"frames": n, "route": route, "mb": mb,
                                  "best_s": min(walls), "walls": walls,
                                  "mb_per_s": mb / min(walls)}), flush=True)
    finally:
        conn.send(None)
        proc.join(timeout=10)
        if proc.is_alive():
            proc.terminate()


if __name__ == "__main__":
    main()
