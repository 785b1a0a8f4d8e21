"""Time ``container.probe`` on an hour-long Matroska file and an hour-long
fragmented MP4, each of 108,000 tiny frames (30 fps), and ``container.meta``
(what ``Video.meta`` reads) and ``container.packet_index`` (the full index
of access units) on an hour-long MPEG transport stream, program stream and
ASF file, written by the tests' writers (auformer_torch.data.fixtures) in
a temporary directory.

The Matroska and MP4 frames are 16-byte stand-ins tagged MJPEG (never
decoded), so that ``probe`` reads every block or sample and lists every
timestamp without a decoder. The Matroska file has a cluster a second,
SimpleBlocks and a key frame every 30; the fragmented MP4 a fragment of 30
samples a second, each with its own ``moof``. The transport and program
streams hold the first GOP of tests/data/videos_h264/ipb_main_176x144.mp4
and then one-slice H.264 units of a few bytes, a PES each (30 fps); the ASF
file the objects of tests/data/videos_container/xvid_176_asf.wmv's first
GOP and then 20-byte ones, several to a packet (25 fps). Prints one JSON
line: the files' sizes, the write seconds and, for each file, the best and
all of ``--passes`` timings, with the machine's card and power limit where
``nvidia-smi`` answers. Runs on any host (no GPU needed), from the root of
the repository:

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


def streams(tmp: str) -> list[tuple[str, str, int]]:
    """Write the hour-long transport stream, program stream and ASF file
    (module docstring) into ``tmp``: [(name, path, frames)]."""
    from auformer_torch.data import asf, container
    from auformer_torch.data.fixtures import (write_asf, write_mpegps,
                                              write_mpegts)
    from auformer_torch.data.mpegstream import read_es
    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data")
    ipb = os.path.join(data, "videos_h264", "ipb_main_176x144.mp4")
    units = [u for _, u in container.access_units(ipb)][:12]
    tiny = b"\x00\x00\x00\x01\x09\xf0\x00\x00\x01\x01\x9a\x00\x10"
    units += [tiny] * (FRAMES - len(units))
    pts = [9000 + 3000 * k for k in range(FRAMES)]
    out = []
    for name, write in (("mpeg_ts", write_mpegts),
                        ("mpeg_ps", write_mpegps)):
        path = os.path.join(tmp, f"hour.{name}")
        write(path, units, pts, [None] * FRAMES)
        out.append((name, path, FRAMES))
    wmv = os.path.join(data, "videos_container", "xvid_176_asf.wmv")
    with open(wmv, "rb") as f:
        h = asf.read(f, wmv)
        objects = [read_es(f, h["chunks"], o.start, o.start + o.size)
                   for o in h["objects"][:12]]
    n = FRAMES * 25 // 30
    objects += [objects[-1][:20]] * (n - len(objects))
    path = os.path.join(tmp, "hour.wmv")
    write_asf(path, objects, [k % 12 == 0 and k < 12 for k in range(n)],
              [40 * k for k in range(n)], b"M4S2", 176, 144,
              extradata=h["extradata"], multiple=True)
    out.append(("asf", path, n))
    return out


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
        for name, path, frames in streams(tmp):
            timed = {}
            for what, call in (("meta", container.meta),
                               ("packet_index", container.packet_index)):
                seconds = []
                for _ in range(args.passes):
                    t0 = time.perf_counter()
                    got = call(path)
                    seconds.append(time.perf_counter() - t0)
                timed[what] = (got, seconds)
            meta, index = timed["meta"][0], timed["packet_index"][0]
            if meta["num_frames"] != frames or len(
                    index["packets"]) != frames:
                raise SystemExit(f"{name}: {meta['num_frames']} frames, "
                                 f"{len(index['packets'])} packets")
            out["files"][name] = {
                "bytes": os.path.getsize(path), "num_frames": frames,
                "fps": meta["fps"], "meta_s": min(timed["meta"][1]),
                "meta_s_all": timed["meta"][1],
                "packet_index_s": min(timed["packet_index"][1]),
                "packet_index_s_all": timed["packet_index"][1]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
