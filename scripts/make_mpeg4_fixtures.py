"""Write the MPEG-4 part 2 fixtures of tests/data/videos_mpeg4/ and what the
JAX package reads from them (expected.json).

Needs cv2 with its FFMPEG backend (its writer makes the first three files
with ffmpeg's mpeg4 encoder, its reader is the JAX package's decoder) and
the JAX package. Run from the root of the repository:

    JAX_PLATFORMS=cpu python scripts/make_mpeg4_fixtures.py \
        [--out tests/data/videos_mpeg4]

Files:
  xvid_176.avi     cv2's XVID writer, 176x144, 36 frames at 25 fps, GOP 12
                   (I- and P-VOPs: motion vectors, half-pel, rounding
                   flips), of fixture_frame content panning and moving
  mp4v_176.mp4     the same through cv2's mp4v writer (esds VOL)
  mp4v_120x90.mp4  cv2's mp4v writer at a size that is not whole macro-
                   blocks, 24 frames: the decoder's edge, and a display
                   width swscale's SIMD loop passes in whole steps
  ipb_112x96.mp4   write_mpeg4, two B-VOPs between references, in MP4 with
                   ctts and an edit list: direct (with 4MV co-located
                   macroblocks), interpolated, backward and forward
                   macroblocks, DBQUANT, skipped ones
  ipb_112x96.avi   the same tools in AVI, one VOP a chunk (FMP4)
  mpegq_112x96.mp4 write_mpeg4 with MPEG quantisation and loaded matrices,
                   video packets every 9 macroblocks (header extension on
                   every other one)
  nvop_112x96.mp4  write_mpeg4 with vop_coded 0 at frames 5 and 23 (the
                   last): ffmpeg returns no frame for the first and the
                   last frame again for the second
  (write_mpeg4's streams also hold 4MV, AC prediction, DQUANT, intra and
  not-coded macroblocks in P-VOPs and vectors past the frame's edge, which
  cv2's writer does not make.)

expected.json: for each file, the JAX package's ``count_frames()``, the
text ``extract_timestamps`` writes, the SHA-256 of each RGB frame from
``frames()`` and of ``read_RGB(k)`` at a few k (null past the last frame).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

SEEKS = (0, 5, 11, 12, 13, 17, 22, 23, 35, 40)
SIZE = (112, 96)


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def panning(t: int, width: int, height: int) -> np.ndarray:
    """(height, width, 3) RGB frame t: fixture_frame's gradient and moving
    blob, seen through a window that pans 2 px right and 1 px down a
    frame."""
    from auformer_torch.data.fixtures import fixture_frame
    big = fixture_frame(7, 0, t, max(width, height) + 48)
    x0, y0 = (2 * t) % 40, t % 40
    return np.ascontiguousarray(big[y0:y0 + height, x0:x0 + width])


def write_cv2(cv2, path: str, fourcc: str, width: int, height: int,
              n: int) -> None:
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 25,
                        (width, height))
    if not w.isOpened():
        raise RuntimeError(f"cv2 cannot write {fourcc} to {path}")
    for t in range(n):
        w.write(cv2.cvtColor(panning(t, width, height), cv2.COLOR_RGB2BGR))
    w.release()


def main(argv=None) -> None:
    import cv2
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tests/data/videos_mpeg4")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from auformer.data import ingest
    from auformer.data.video import Video
    from auformer_torch.data.fixtures import write_mpeg4
    os.makedirs(args.out, exist_ok=True)
    p = lambda name: os.path.join(args.out, name)  # noqa: E731
    write_cv2(cv2, p("xvid_176.avi"), "XVID", 176, 144, 36)
    write_cv2(cv2, p("mp4v_176.mp4"), "mp4v", 176, 144, 36)
    write_cv2(cv2, p("mp4v_120x90.mp4"), "mp4v", 120, 90, 24)
    write_mpeg4(p("ipb_112x96.mp4"), *SIZE, 24, gop=12, b_frames=2,
                qscale=12, seed=2)
    write_mpeg4(p("ipb_112x96.avi"), *SIZE, 24, gop=12, b_frames=2,
                qscale=12, seed=3)
    write_mpeg4(p("mpegq_112x96.mp4"), *SIZE, 24, gop=12, mpeg_quant=True,
                resync=9, qscale=10, seed=4)
    write_mpeg4(p("nvop_112x96.mp4"), *SIZE, 24, gop=12, not_coded=(5, 23),
                qscale=12, seed=5)
    expected = {}
    for name in sorted(os.listdir(args.out)):
        if not name.endswith((".mp4", ".avi")):
            continue
        path = p(name)
        v = Video(path, write=False)
        frames = list(v.frames())
        seeks = {}
        for k in SEEKS:
            img = v.read_RGB(k)
            seeks[str(k)] = None if img is None else sha(img)
        v.release()
        with tempfile.TemporaryDirectory() as tmp:
            ts = ingest.extract_timestamps(path, os.path.join(tmp, "ts.txt"))
            with open(ts) as f:
                stamps = f.read()
        expected[name] = {"count_frames": Video(path, write=False)
                          .count_frames(),
                          "timestamps": stamps,
                          "frames_sha256": [sha(f) for f in frames],
                          "read_RGB_sha256": seeks}
    with open(p("expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
