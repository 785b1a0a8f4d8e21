"""Write the small video fixtures of tests/data/videos/ and what the JAX
package reads from them (expected.json).

Needs cv2 with its FFMPEG backend and the JAX package (auformer.data.video
and auformer.data.ingest read each file through cv2). Run from the root
of the repository:

    python scripts/make_video_fixtures.py [--out tests/data/videos]

Files:
  mp4v_30.mp4, mp4v_25.mp4   MPEG-4 part 2 in MP4, 12 frames of 32x32
  mjpg_30.avi                MJPEG in AVI
  xvid_25.avi                MPEG-4 part 2 (XVID) in AVI
  elst_shift.mp4             mp4v_30.mp4 with its edit list starting one
                             frame in (media_time 512), so cv2 returns 11
  elst_window.mp4            an empty edit, then a 100 ms edit from frame 5
  vfr.mp4                    mp4v_30.mp4 whose last frame lasts twice as
                             long (two stts runs): the average frame rate
  avi_start.avi              mjpg_30.avi with dwStart 3 and dwRate/dwScale
                             30000/1001
  avix.avi                   mjpg_30.avi as OpenDML writes a large file:
                             frames 6-11 in a second RIFF 'AVIX' part
  rec.avi                    mjpg_30.avi with frames 0-3 in a 'rec ' list
  drop.avi                   mjpg_30.avi with frame 5 an empty chunk (a
                             dropped frame: cv2 returns 11, the clock
                             goes on)
  ctts_reorder.mp4           mp4v_30.mp4 with the composition offsets of
                             one B-frame between references (presentation
                             order 0 2 1 4 3 ... 11, offsets 1 2 0 2 0 ...
                             1 frames) and its edit list starting at the
                             first presentation time, as x264's MP4s
                             carry: the port reads its meta and count,
                             and refuses its timestamps
  ctts_cut.mp4               the same offsets with an edit from the second
                             presentation time (media_time 1024, 367 ms):
                             the window keeps a sample by its presentation
                             time (11 frames), not its decode time (10)
and, for the checks that the port refuses what it cannot read:
  ctts.mp4                   mp4v_30.mp4 with a ctts box (composition
                             offsets)
  fragmented.mp4             mp4v_30.mp4 with a trailing moof box
  matroska.mkv               an EBML header (Matroska/WebM)

expected.json: for each file of the first list, the JAX package's
``Video(path, write=False).meta``, ``count_frames()`` and the text that
``extract_timestamps`` writes.
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import tempfile

import numpy as np

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts"}


def parse_boxes(b: bytes) -> list:
    """[[type, body or children], ...] of an ISO BMFF buffer."""
    out, off = [], 0
    while off < len(b):
        size, kind = struct.unpack(">I4s", b[off:off + 8])
        body = b[off + 8:off + size]
        out.append([kind, parse_boxes(body) if kind in CONTAINERS else body])
        off += size
    return out


def build_boxes(tree: list) -> bytes:
    out = b""
    for kind, body in tree:
        payload = build_boxes(body) if isinstance(body, list) else body
        out += struct.pack(">I4s", 8 + len(payload), kind) + payload
    return out


def find_box(tree: list, path: list) -> list:
    for node in tree:
        if node[0] == path[0]:
            return node if len(path) == 1 else find_box(node[1], path[1:])
    raise KeyError(path)


def edit_mp4(src: str, dst: str, edit) -> None:
    """Write ``src`` with ``edit(tree)`` applied to its boxes. cv2 writes
    ``moov`` after ``mdat``, so a larger ``moov`` moves no chunk offset."""
    with open(src, "rb") as f:
        tree = parse_boxes(f.read())
    assert [k for k, _ in tree].index(b"moov") > \
        [k for k, _ in tree].index(b"mdat")
    edit(tree)
    with open(dst, "wb") as f:
        f.write(build_boxes(tree))


def elst(entries) -> bytes:
    """A version-0 elst of (segment duration, media time) entries, rate 1."""
    return struct.pack(">II", 0, len(entries)) + b"".join(
        struct.pack(">IihH", d, m, 1, 0) for d, m in entries)


STBL = [b"moov", b"trak", b"mdia", b"minf", b"stbl"]


def riff(kind: bytes, body: bytes, fourcc: bytes = b"RIFF") -> bytes:
    return fourcc + struct.pack("<I", 4 + len(body)) + kind + body


def avi_parts(data: bytes) -> tuple[bytes, list[bytes]]:
    """(the chunks of the RIFF before its movi list, each movi chunk) of a
    cv2-written AVI."""
    off, head, movi = 12, b"", None
    while off < len(data):
        fourcc, size = struct.unpack("<4sI", data[off:off + 8])
        if fourcc == b"LIST" and data[off + 8:off + 12] == b"movi":
            movi = (off + 12, off + 8 + size)
            break
        head += data[off:off + 8 + size + (size & 1)]
        off += 8 + size + (size & 1)
    chunks, off = [], movi[0]
    while off < movi[1]:
        size, = struct.unpack("<I", data[off + 4:off + 8])
        chunks.append(data[off:off + 8 + size + (size & 1)])
        off += 8 + size + (size & 1)
    return head, chunks


def frame(t: int, size: int = 32) -> np.ndarray:
    """A smooth BGR frame with a moving square: compresses to a few
    hundred bytes."""
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.stack([xx * 255 // size, yy * 255 // size,
                    np.full_like(xx, 128)], -1).astype(np.uint8)
    x0 = (3 * t) % (size - 8)
    img[8:16, x0:x0 + 8] = 255
    return img


def write_video(cv2, path: str, fourcc: str, fps: float, n: int = 12):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps,
                        (32, 32))
    if not w.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} to {path}")
    for t in range(n):
        w.write(frame(t))
    w.release()


def main(argv=None) -> None:
    import cv2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from auformer.data.ingest import extract_timestamps
    from auformer.data.video import Video

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tests", "data", "videos"))
    args = ap.parse_args(argv)
    out = args.out
    os.makedirs(out, exist_ok=True)
    p = lambda name: os.path.join(out, name)  # noqa: E731

    write_video(cv2, p("mp4v_30.mp4"), "mp4v", 30)
    write_video(cv2, p("mp4v_25.mp4"), "mp4v", 25)
    write_video(cv2, p("mjpg_30.avi"), "MJPG", 30)
    write_video(cv2, p("xvid_25.avi"), "XVID", 25)

    def set_elst(entries):
        def edit(tree):
            find_box(tree, [b"moov", b"trak", b"edts", b"elst"])[1] = \
                elst(entries)
        return edit

    def vfr(tree):
        stts = find_box(tree, STBL + [b"stts"])
        stts[1] = struct.pack(">IIIIII", 0, 2, 11, 512, 1, 1024)
        # the edit list of cv2's file would cut the longer last frame
        find_box(tree, [b"moov", b"trak", b"edts", b"elst"])[1] = elst(
            [(434, 0)])

    def ctts(tree):
        stbl = find_box(tree, STBL)
        stbl[1].append([b"ctts", struct.pack(">IIIi", 0, 1, 12, 0)])

    def ctts_reorder(edit):
        def reorder(tree):
            order = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 11]
            offsets = [(p + 1 - k) * 512 for k, p in enumerate(order)]
            stbl = find_box(tree, STBL)
            stbl[1].append([b"ctts", struct.pack(">II", 0, len(offsets))
                            + b"".join(struct.pack(">Ii", 1, o)
                                       for o in offsets)])
            find_box(tree, [b"moov", b"trak", b"edts", b"elst"])[1] = \
                elst([edit])
        return reorder

    edit_mp4(p("mp4v_30.mp4"), p("elst_shift.mp4"), set_elst([(367, 512)]))
    edit_mp4(p("mp4v_30.mp4"), p("elst_window.mp4"),
             set_elst([(100, -1), (100, 2560)]))
    edit_mp4(p("mp4v_30.mp4"), p("vfr.mp4"), vfr)
    edit_mp4(p("mp4v_30.mp4"), p("ctts.mp4"), ctts)
    edit_mp4(p("mp4v_30.mp4"), p("ctts_reorder.mp4"),
             ctts_reorder((400, 512)))
    edit_mp4(p("mp4v_30.mp4"), p("ctts_cut.mp4"), ctts_reorder((367, 1024)))
    with open(p("mp4v_30.mp4"), "rb") as f:
        data = f.read()
    with open(p("fragmented.mp4"), "wb") as f:
        f.write(data + struct.pack(">I4s", 24, b"moof")
                + struct.pack(">I4sII", 16, b"mfhd", 0, 1))
    with open(p("matroska.mkv"), "wb") as f:
        f.write(b"\x1a\x45\xdf\xa3" + bytes(28))
    with open(p("mjpg_30.avi"), "rb") as f:
        avi = bytearray(f.read())
    strh = avi.find(b"strh") + 8
    avi[strh + 20:strh + 32] = struct.pack("<III", 1001, 30000, 3)
    with open(p("avi_start.avi"), "wb") as f:
        f.write(avi)
    with open(p("mjpg_30.avi"), "rb") as f:
        head, chunks = avi_parts(f.read())
    movi = lambda cs: riff(b"movi", b"".join(cs), b"LIST")  # noqa: E731
    with open(p("avix.avi"), "wb") as f:
        f.write(riff(b"AVI ", head + movi(chunks[:6]))
                + riff(b"AVIX", movi(chunks[6:])))
    with open(p("rec.avi"), "wb") as f:
        rec = riff(b"rec ", b"".join(chunks[:4]), b"LIST")
        f.write(riff(b"AVI ", head + movi([rec] + chunks[4:])))
    dropped = list(chunks)
    dropped[5] = chunks[5][:4] + struct.pack("<I", 0)
    with open(p("drop.avi"), "wb") as f:
        f.write(riff(b"AVI ", head + movi(dropped)))

    expected = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("mp4v_30.mp4", "mp4v_25.mp4", "mjpg_30.avi",
                     "xvid_25.avi", "elst_shift.mp4", "elst_window.mp4",
                     "vfr.mp4", "avi_start.avi", "avix.avi", "rec.avi",
                     "drop.avi", "ctts_reorder.mp4", "ctts_cut.mp4"):
            v = Video(p(name), write=False)
            ts = extract_timestamps(p(name), os.path.join(tmp, "ts.txt"))
            with open(ts) as f:
                text = f.read()
            expected[name] = {"meta": v.meta, "count_frames":
                              v.count_frames(), "timestamps": text}
            v.release()
    with open(p("expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    for name in sorted(os.listdir(out)):
        print(f"{name}: {os.path.getsize(p(name))} bytes")


if __name__ == "__main__":
    main()
