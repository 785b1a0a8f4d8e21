"""Write the MPEG-4 part 2 fixtures of tests/data/videos_mpeg4/ and what the
JAX package reads from them (expected.json).

Needs cv2 with its FFMPEG backend (its writer makes the first three files
with ffmpeg's mpeg4 encoder, its reader is the JAX package's decoder) and
the JAX package; ``--xvid`` also needs ``gcc`` and the system's FFmpeg
libraries with their headers (libavcodec 59 linked against libxvidcore 4),
through which it encodes. Neither the port nor a test runs this script:
the tests read the committed files. Each mode rewrites its own files and
their entries in expected.json and keeps the other's. Run from the root of
the repository:

    JAX_PLATFORMS=cpu python scripts/make_mpeg4_fixtures.py \
        [--out tests/data/videos_mpeg4]
    JAX_PLATFORMS=cpu python scripts/make_mpeg4_fixtures.py --xvid \
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

With ``--xvid``, the streams of ``XVID_STREAMS``: libxvidcore through
libavcodec's libxvid encoder at 25 fps, of make_h264_fixtures'
``x264_source`` frames (a texture panning by fractions of a sample, three
discs moving each their own way), muxed by auformer_torch.data.fixtures in
AVI with the fourcc XVID. They carry XviD's signature (user data
"XviD0069"), so ffmpeg decodes them with XviD's inverse DCT; with B-frames
libxvid writes a packed bitstream (DivX's signature "DivX503b1393p" beside
XviD's, a reference and the B-VOP before it in one chunk, a 6-byte N-VOP
chunk after it) and libavcodec drops the empty output of each frame the
encoder holds back.

expected.json: for each file, the JAX package's ``count_frames()``, the
text ``extract_timestamps`` writes, the SHA-256 of each RGB frame from
``frames()`` and of ``read_RGB(k)`` at a few k (null past the last frame);
for the ``--xvid`` streams also the options and what they exercise, their
bytes per frame, and the SHA-256 of each frame's Y, U and V planes from
libavcodec 59's own ``mpeg4`` decoder (``planes_sha256``), so that a
mismatch can be placed in the decoder or in the colour conversion; the
script asserts that the system's libswscale converts those planes to
cv2's frames.
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


def entry(path: str) -> dict:
    """What the JAX package reads from ``path``: count, timestamps, frames
    and seeks."""
    from auformer.data import ingest
    from auformer.data.video import Video
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
    return {"count_frames": Video(path, write=False).count_frames(),
            "timestamps": stamps,
            "frames_sha256": [sha(f) for f in frames],
            "read_RGB_sha256": seeks}


def update_expected(out: str, entries: dict) -> None:
    """Write ``entries`` into out/expected.json, keeping the others."""
    path = os.path.join(out, "expected.json")
    expected = {}
    if os.path.exists(path):
        with open(path) as f:
            expected = json.load(f)
    expected.update(entries)
    with open(path, "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


def write_cv2_and_writer(out: str) -> None:
    """The fixtures of cv2's writers and of write_mpeg4 (module
    docstring)."""
    import cv2
    from auformer_torch.data.fixtures import write_mpeg4
    os.makedirs(out, exist_ok=True)
    p = lambda name: os.path.join(out, name)  # noqa: E731
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
    names = ("xvid_176.avi", "mp4v_176.mp4", "mp4v_120x90.mp4",
             "ipb_112x96.mp4", "ipb_112x96.avi", "mpegq_112x96.mp4",
             "nvop_112x96.mp4")
    update_expected(out, {name: entry(p(name)) for name in names})


# ---- libxvid through libavcodec -------------------------------------------

# (file, width, height, frames, encoder options, what it exercises); a
# stream's seed is its place in the list, so new streams go at the end.
# Options: "b" the B-frames (libavcodec's max_b_frames), "flags" qpel and
# 4mv (AV_CODEC_FLAG_QPEL, AV_CODEC_FLAG_4MV), "rate" the bit rate (0:
# libavcodec's default, 200 kbit/s), "vfw" the chunks as XviD's Video for
# Windows codec stores them, "seed" another stream's seed (the same VOPs)
XVID_STREAMS = [
    ("xvid_ip_176x144.avi", 176, 144, 24, {"b": 0},
     "I- and P-VOPs alone (low delay, one VOP a chunk): XviD's inverse DCT "
     "with half-pel prediction and 1MV"),
    ("xvid_packed_176x144.avi", 176, 144, 24, {"b": 2},
     "libxvid's defaults with 2 B-frames, one chunk a packet as libavcodec "
     "hands them out: a packed bitstream, with XviD's N-VOP chunks"),
    ("xvid_packed_nvop_176x144.avi", 176, 144, 24,
     {"b": 2, "vfw": True, "seed": 2},
     "the same VOPs one chunk a source frame, as XviD's Video for Windows "
     "codec stores them: a 1-byte chunk (0x7f) for each frame the encoder "
     "holds back, which ffmpeg skips in a signed stream"),
    ("xvid_qpel_176x144.avi", 176, 144, 24, {"b": 2, "flags": "qpel"},
     "quarter-pel (VOL version 2): the 8-tap filter at 16x16 in P- and "
     "B-VOPs, the direct mode's 8x8 blocks, qpel_motion's chroma vectors"),
    ("xvid_qpel_4mv_176x144.avi", 176, 144, 24,
     {"b": 2, "flags": "qpel+4mv"},
     "quarter-pel with 4MV: the 8-tap filter at 8x8, the chroma vector of "
     "the four halved luma vectors"),
    ("xvid_1280x720.avi", 1280, 720, 36, {"b": 2, "rate": 900000},
     "libxvid at full width with 2 B-frames, packed, at 900 kbit/s (11 KB "
     "a frame): the size of users' XviD files"),
]

XVID_TOOL = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <libavcodec/avcodec.h>
#include <libavutil/frame.h>
#include <libavutil/mem.h>
#include <libswscale/swscale.h>

/* encode W H N BFRAMES FLAGS RATE OUT: yuv420p frames on stdin through
   libxvid; each packet to OUT as int32 key, int32 size, bytes, and a record
   of key -1 and size 0 for a frame that gave no packet */
static int put(AVCodecContext *c, AVPacket *p, FILE *out, int *n) {
  int rc;
  while ((rc = avcodec_receive_packet(c, p)) == 0) {
    int32_t k[2] = {(p->flags & AV_PKT_FLAG_KEY) != 0, p->size};
    fwrite(k, 4, 2, out);
    fwrite(p->data, 1, p->size, out);
    av_packet_unref(p);
    ++*n;
  }
  return rc == AVERROR(EAGAIN) || rc == AVERROR_EOF ? 0 : rc;
}

static int encode(int w, int h, int n, int bframes, const char *flags,
                  long rate, const char *path) {
  const AVCodec *codec = avcodec_find_encoder_by_name("libxvid");
  if (!codec) return 10;
  AVCodecContext *c = avcodec_alloc_context3(codec);
  c->width = w;
  c->height = h;
  c->time_base = (AVRational){1, 25};
  c->framerate = (AVRational){25, 1};
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->thread_count = 1;
  c->max_b_frames = bframes;
  if (rate) c->bit_rate = rate;
  if (strstr(flags, "qpel")) c->flags |= AV_CODEC_FLAG_QPEL;
  if (strstr(flags, "4mv")) c->flags |= AV_CODEC_FLAG_4MV;
  if (avcodec_open2(c, codec, NULL) < 0) return 11;
  FILE *out = fopen(path, "wb");
  AVFrame *f = av_frame_alloc();
  f->format = c->pix_fmt;
  f->width = w;
  f->height = h;
  av_frame_get_buffer(f, 0);
  AVPacket *p = av_packet_alloc();
  int cw = (w + 1) / 2, ch = (h + 1) / 2;
  for (int t = 0; t < n; ++t) {
    av_frame_make_writable(f);
    for (int k = 0; k < 3; ++k)
      for (int r = 0; r < (k ? ch : h); ++r)
        if (fread(f->data[k] + r * f->linesize[k], 1, k ? cw : w, stdin) !=
            (size_t)(k ? cw : w))
          return 12;
    f->pts = t;
    int got = 0;
    if (avcodec_send_frame(c, f) < 0 || put(c, p, out, &got)) return 13;
    if (!got) {
      int32_t k[2] = {-1, 0};
      fwrite(k, 4, 2, out);
    }
  }
  int got = 0;
  avcodec_send_frame(c, NULL);
  if (put(c, p, out, &got)) return 14;
  fclose(out);
  return 0;
}

/* swscale's conversion to BGR24 as cv2's FFMPEG capture asks for it */
static int bgr(AVFrame *f, FILE *out) {
  struct SwsContext *s = sws_getContext(f->width, f->height, f->format,
                                        f->width, f->height, AV_PIX_FMT_BGR24,
                                        SWS_BICUBIC, NULL, NULL, NULL);
  if (!s) return 1;
  int full = f->color_range == AVCOL_RANGE_JPEG;
  sws_setColorspaceDetails(s, sws_getCoefficients(f->colorspace), full,
                           sws_getCoefficients(SWS_CS_DEFAULT), full, 0,
                           1 << 16, 1 << 16);
  int pitch = (3 * f->width + 63) & ~63;
  uint8_t *rgb = av_malloc((size_t)pitch * (f->height + 2));
  uint8_t *dst[4] = {rgb, NULL, NULL, NULL};
  int dst_pitch[4] = {pitch, 0, 0, 0};
  sws_scale(s, (const uint8_t *const *)f->data, f->linesize, 0, f->height,
            dst, dst_pitch);
  for (int r = 0; r < f->height; ++r)
    fwrite(rgb + (size_t)r * pitch, 1, 3 * (size_t)f->width, out);
  av_free(rgb);
  sws_freeContext(s);
  return 0;
}

/* decode FOURCC OUT BGR: the units (int32 size, bytes) on stdin through
   libavcodec's mpeg4 decoder, opened as an AVI's demuxer opens it (the
   fourcc as codec_tag, idct_algo auto); each frame's Y, U, V planes to OUT
   and its swscale BGR24 frame to BGR */
static int decode(const char *fourcc, const char *path, const char *bgr_path) {
  const AVCodec *codec = avcodec_find_decoder_by_name("mpeg4");
  AVCodecContext *c = avcodec_alloc_context3(codec);
  c->thread_count = 1;
  c->codec_tag = MKTAG(fourcc[0], fourcc[1], fourcc[2], fourcc[3]);
  if (avcodec_open2(c, codec, NULL) < 0) return 20;
  FILE *out = fopen(path, "wb");
  FILE *rgb = fopen(bgr_path, "wb");
  AVPacket *p = av_packet_alloc();
  AVFrame *f = av_frame_alloc();
  for (int end = 0; !end;) {
    int32_t size;
    if (fread(&size, 4, 1, stdin) == 1) {
      av_new_packet(p, size);
      if (fread(p->data, 1, size, stdin) != (size_t)size) return 21;
      if (avcodec_send_packet(c, p) < 0) return 22;
      av_packet_unref(p);
    } else {
      avcodec_send_packet(c, NULL);
      end = 1;
    }
    while (avcodec_receive_frame(c, f) == 0) {
      if (f->format != AV_PIX_FMT_YUV420P) return 23;
      for (int k = 0; k < 3; ++k) {
        int pw = k ? (f->width + 1) / 2 : f->width;
        int ph = k ? (f->height + 1) / 2 : f->height;
        for (int r = 0; r < ph; ++r)
          fwrite(f->data[k] + r * f->linesize[k], 1, pw, out);
      }
      if (bgr(f, rgb)) return 24;
      av_frame_unref(f);
    }
  }
  fclose(out);
  fclose(rgb);
  return 0;
}

int main(int argc, char **argv) {
  if (argc == 9 && !strcmp(argv[1], "encode"))
    return encode(atoi(argv[2]), atoi(argv[3]), atoi(argv[4]), atoi(argv[5]),
                  argv[6], atol(argv[7]), argv[8]);
  if (argc == 5 && !strcmp(argv[1], "decode"))
    return decode(argv[2], argv[3], argv[4]);
  return 2;
}
"""


def build_xvid_tool(tmp: str) -> str:
    """Compile XVID_TOOL against the system's libavcodec; its path."""
    import subprocess
    src, exe = os.path.join(tmp, "xvidtool.c"), os.path.join(tmp, "xvidtool")
    with open(src, "w") as f:
        f.write(XVID_TOOL)
    subprocess.run(["gcc", "-O2", src, "-o", exe, "-lavcodec", "-lswscale",
                    "-lavutil"], check=True)
    return exe


def xvid_encode(tool: str, tmp: str, width: int, height: int, n: int,
                opts: dict, seed: int) -> list[tuple[int, bytes]]:
    """(key flag, bytes) of each packet libavcodec hands out, with (-1,
    b"") for each source frame that gave none, in order."""
    import struct
    import subprocess
    from make_h264_fixtures import x264_source
    raw = b"".join(p.tobytes() for t in range(n)
                   for p in x264_source(seed, t, height, width))
    out = os.path.join(tmp, "packets")
    subprocess.run([tool, "encode", str(width), str(height), str(n),
                    str(opts["b"]), opts.get("flags", ""),
                    str(opts.get("rate", 0)), out], input=raw, check=True,
                   capture_output=True)
    data, off, packets = open(out, "rb").read(), 0, []
    while off < len(data):
        key, size = struct.unpack_from("<ii", data, off)
        off += 8
        packets.append((key, data[off:off + size]))
        off += size
    return packets


def xvid_planes(tool: str, tmp: str, units: list[bytes], width: int,
                height: int) -> tuple[list[dict], list[str]]:
    """SHA-256 of libavcodec's Y, U and V planes of each frame its mpeg4
    decoder outputs for ``units``, and of each frame as the system's
    libswscale converts it to RGB (the route cv2 takes)."""
    import struct
    import subprocess
    out, bgr = os.path.join(tmp, "planes"), os.path.join(tmp, "bgr")
    subprocess.run([tool, "decode", "XVID", out, bgr], check=True,
                   capture_output=True,
                   input=b"".join(struct.pack("<i", len(u)) + u
                                  for u in units))
    raw = np.fromfile(out, np.uint8)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    sizes = (width * height, cw * ch, cw * ch)
    frames, off = [], 0
    while off < raw.size:
        entry = {}
        for key, n in zip("yuv", sizes):
            entry[key] = sha(raw[off:off + n])
            off += n
        frames.append(entry)
    assert off == raw.size, "libavcodec's planes do not add up"
    rgb = np.fromfile(bgr, np.uint8).reshape(-1, height, width, 3)[..., ::-1]
    return frames, [sha(f) for f in rgb]


def write_xvid(out: str) -> None:
    """The ``XVID_STREAMS`` fixtures (module docstring)."""
    from auformer_torch.data.fixtures import _avi, _frame_rate
    os.makedirs(out, exist_ok=True)
    delta, scale = _frame_rate(25.0)
    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        tool = build_xvid_tool(tmp)
        for place, (name, w, h, n, opts, what) in enumerate(XVID_STREAMS):
            packets = xvid_encode(tool, tmp, w, h, n, opts,
                                  opts.get("seed", place + 1))
            if opts.get("vfw"):
                chunks = [(max(key, 0), unit or b"\x7f")
                          for key, unit in packets]
            else:
                chunks = [(key, unit) for key, unit in packets if key >= 0]
            units = [unit for _, unit in chunks]
            path = os.path.join(out, name)
            with open(path, "wb") as f:
                f.write(_avi(units, [bool(key) for key, _ in chunks],
                             b"XVID", delta, scale, w, h))
            planes, converted = xvid_planes(tool, tmp, units, w, h)
            e = entry(path)
            assert e["frames_sha256"] == converted, \
                f"{name}: swscale's frames of libavcodec's planes are not cv2's"
            e.update(xvid=opts, exercises=what, planes_sha256=planes,
                     bytes_per_frame=sum(map(len, units)) / n)
            entries[name] = e
            print(name, os.path.getsize(path), "bytes,",
                  e["bytes_per_frame"], "a frame")
    update_expected(out, entries)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--xvid", action="store_true",
                    help="write the libxvid streams (XVID_STREAMS)")
    ap.add_argument("--out", default="tests/data/videos_mpeg4")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.xvid:
        write_xvid(args.out)
    else:
        write_cv2_and_writer(args.out)


if __name__ == "__main__":
    main()
