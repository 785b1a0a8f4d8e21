"""Write the video fixtures of tests/data/videos_decode/ and what the JAX
package reads from them (expected.json, mjpg_112.npz).

Needs cv2 with its FFMPEG backend and the JAX package (auformer.data.video
and auformer.data.ingest read each file through cv2). Run from the root of
the repository:

    python scripts/make_h264_fixtures.py [--out tests/data/videos_decode]

Files (112x112, 30 fps, written by auformer_torch.data.fixtures; the H.264
ones are I_PCM IDR pictures every 12 frames, P pictures of P_Skip with a
moving band of I_PCM macroblock columns, and, in ipb_112.mp4, two B_Skip
pictures between references):
  ip_112.mp4     H.264 I+P in MP4 (avcC, stss)
  ipb_112.mp4    H.264 I+P+B in MP4, with ctts and an edit list from the
                 first presentation time: decode order differs from
                 presentation order
  ip_112.avi     H.264 I+P in AVI (Annex B chunks, idx1 key flags)
  mjpg_112.avi   MJPEG in AVI, 4:2:0 JPEGs of fixture_frame at quality 90

expected.json: for each file, the JAX package's ``count_frames()``, the text
``extract_timestamps`` writes, and the SHA-256 of each RGB frame from
``frames()`` and of ``read_RGB(k)`` at a few k; mjpg_112.npz holds the MJPEG
frames themselves, which the port matches within a tolerance (its inverse
DCT is libjpeg's or nvJPEG's, not ffmpeg's).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np

SIZE, FRAMES, GOP = 112, 26, 12
SEEKS = (0, 5, 11, 12, 13, 25)


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tests/data/videos_decode")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from auformer.data import ingest
    from auformer.data.video import Video
    from auformer_torch.data.fixtures import (fixture_frame, write_h264,
                                              write_mjpeg_avi)
    from auformer_torch.data.native import encode_jpeg
    os.makedirs(args.out, exist_ok=True)
    write_h264(os.path.join(args.out, "ip_112.mp4"), SIZE, SIZE, FRAMES,
               gop=GOP, seed=1)
    write_h264(os.path.join(args.out, "ipb_112.mp4"), SIZE, SIZE, FRAMES,
               gop=GOP, b_frames=2, band=2, seed=2)
    write_h264(os.path.join(args.out, "ip_112.avi"), SIZE, SIZE, FRAMES,
               gop=GOP, seed=3)
    write_mjpeg_avi(os.path.join(args.out, "mjpg_112.avi"),
                    [encode_jpeg(fixture_frame(4, 0, t, SIZE), 90)
                     for t in range(12)], SIZE, SIZE)
    expected = {}
    for name in sorted(os.listdir(args.out)):
        if not name.endswith((".mp4", ".avi")):
            continue
        path = os.path.join(args.out, name)
        v = Video(path, write=False)
        frames = list(v.frames())
        seeks = {str(k): sha(v.read_RGB(k)) for k in SEEKS
                 if k < len(frames)}
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
        if name.startswith("mjpg"):
            np.savez_compressed(os.path.join(args.out, "mjpg_112.npz"),
                                frames=np.stack(frames))
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
