"""Time the port's host H.264 decoder of one or more checkouts of the repo
against each other, interleaved in one process on one host.

Each root's decoder (``data/native/h264_decode.cpp``) is built with the
C++ compiler by that root's own ``auformer_torch.data.native.build`` in a
process of its own, then every library is loaded here and driven through
its C interface (``h264_open``, ``h264_send``, ``h264_size``,
``h264_chroma``, ``h264_depth`` where the library has it, ``h264_receive``,
``h264_flush``) on the access units of each stream of tests/data/videos_h264,
read into memory first: the planes of the stream's chroma format, 16-bit
for a stream deeper than 8 bits (ipb_high10_1280x720.mp4, which a root
from before bit depths above 8 refuses: time it on the roots that decode
it). One pass decodes a whole
stream; each round times one pass of every root on every stream, the
roots' order rotated from round to round, so that a drift in the host's
speed falls on every root alike. The first round only warms up. Every
root's planes must be the first root's, bit for bit.

    python scripts/h264_decode_rate.py --roots ../parent . --rounds 12
    python scripts/h264_decode_rate.py --streams ipb_high10_1280x720.mp4

Prints one JSON line per root and stream (milliseconds a frame of every
timed pass on the wall clock and in the thread's CPU time, which leaves
out the time the host's scheduler gave to other work; their minimum and
median) and a last line with the medians.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STREAMS = ("ipb_cabac_1280x720.mp4", "ipb_1280x720.mp4")


def build(root: Path) -> str:
    """The path of ``root``'s decoder library, built by its own code."""
    out = subprocess.run(
        [sys.executable, "-c", "from auformer_torch.data import native; "
         "print(native.build('h264'))"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root)), check=True,
        capture_output=True, text=True)
    return out.stdout.strip().splitlines()[-1]


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.h264_open.argtypes, lib.h264_open.restype = [], ptr
    lib.h264_close.argtypes, lib.h264_close.restype = [ptr], None
    lib.h264_send.argtypes = [ptr, ctypes.c_char_p, ctypes.c_long, ll, ip,
                              ctypes.c_char_p, i]
    lib.h264_flush.argtypes = [ptr, ip, ctypes.c_char_p, i]
    lib.h264_size.argtypes = [ptr, ip, ip, ip, ip]
    lib.h264_chroma.argtypes, lib.h264_chroma.restype = [ptr], i
    if hasattr(lib, "h264_depth"):
        lib.h264_depth.argtypes, lib.h264_depth.restype = [ptr], i
    lib.h264_receive.argtypes = [ptr, ptr, i, ptr, ptr, i,
                                 ctypes.POINTER(ll)]
    return lib


def decode(lib: ctypes.CDLL, units: list[tuple[int, bytes]],
           digest: bool) -> tuple[int, str | None]:
    """One pass over a stream: (the frames out, the SHA-256 of their planes
    where ``digest``)."""
    h = lib.h264_open()
    err = ctypes.create_string_buffer(512)
    ready, tag = ctypes.c_int(), ctypes.c_longlong()
    w, ht, m, r = (ctypes.c_int() for _ in range(4))
    sha = hashlib.sha256() if digest else None
    frames = 0

    def take() -> None:
        nonlocal frames
        for _ in range(ready.value):
            lib.h264_size(h, ctypes.byref(w), ctypes.byref(ht),
                          ctypes.byref(m), ctypes.byref(r))
            chroma = lib.h264_chroma(h)
            deep = hasattr(lib, "h264_depth") and lib.h264_depth(h) > 8
            dtype = np.uint16 if deep else np.uint8
            cw = w.value if chroma == 3 else (w.value + 1) // 2
            ch = ht.value if chroma > 1 else (ht.value + 1) // 2
            y = np.empty((ht.value, w.value), dtype)
            u, v = (np.empty((ch, cw), dtype) for _ in range(2))
            lib.h264_receive(h, y.ctypes.data, y.shape[1], u.ctypes.data,
                             v.ctypes.data, cw, ctypes.byref(tag))
            frames += 1
            if sha:
                for p in (y, u, v):
                    sha.update(p.tobytes())

    try:
        for k, unit in units:
            if lib.h264_send(h, unit, len(unit), k, ctypes.byref(ready), err,
                             512):
                raise RuntimeError(err.value.decode())
            take()
        if lib.h264_flush(h, ctypes.byref(ready), err, 512):
            raise RuntimeError(err.value.decode())
        take()
    finally:
        lib.h264_close(h)
    return frames, sha.hexdigest() if sha else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--streams", nargs="+", default=list(STREAMS))
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from auformer_torch.data import container

    roots = list(dict.fromkeys(str(Path(r).resolve()) for r in args.roots))
    libs = {r: load(build(Path(r))) for r in roots}
    units = {s: list(container.access_units(
        str(ROOT / "tests" / "data" / "videos_h264" / s), kept_only=False))
        for s in args.streams}
    ms = {r: {s: [] for s in args.streams} for r in roots}
    cpu = {r: {s: [] for s in args.streams} for r in roots}
    for rnd in range(args.rounds + 1):
        order = roots[rnd % len(roots):] + roots[:rnd % len(roots)]
        for s in args.streams:
            digests = {}
            for r in order:
                t0, c0 = time.perf_counter(), time.thread_time()
                n, digests[r] = decode(libs[r], units[s], rnd == 0)
                if rnd:
                    ms[r][s].append(1000 * (time.perf_counter() - t0) / n)
                    cpu[r][s].append(1000 * (time.thread_time() - c0) / n)
            if rnd == 0 and len(set(digests.values())) != 1:
                raise SystemExit(f"{s}: the roots' planes differ: {digests}")
    medians = {}
    for r in roots:
        for s in args.streams:
            run, busy = ms[r][s], cpu[r][s]
            medians.setdefault(r, {})[s] = [statistics.median(run),
                                            statistics.median(busy)]
            print(json.dumps({"root": r, "stream": s, "ms_per_frame": run,
                              "min": min(run),
                              "median": statistics.median(run),
                              "cpu_ms_per_frame": busy, "cpu_min": min(busy),
                              "cpu_median": statistics.median(busy)}),
                  flush=True)
    print(json.dumps({"median_ms_per_frame_wall_cpu": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
