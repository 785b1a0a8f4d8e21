"""Write the H.264 video fixtures and what the JAX package reads from them:
tests/data/videos_decode/ (the port's own I_PCM writer) and, with
``--x264``, tests/data/videos_h264/ (streams of a real encoder).

Needs cv2 with its FFMPEG backend and the JAX package (auformer.data.video
and auformer.data.ingest read each file through cv2); ``--x264`` needs
``gcc`` and the system's FFmpeg libraries with their headers (libavcodec 59
linked against libx264 164), through which it encodes. Neither the port nor
a test runs this script: the tests read the committed files. Run from the
root of the repository:

    python scripts/make_h264_fixtures.py [--out tests/data/videos_decode]
    JAX_PLATFORMS=cpu python scripts/make_h264_fixtures.py --x264 \
        [--out tests/data/videos_h264]

tests/data/videos_decode/ (112x112, 30 fps, written by
auformer_torch.data.fixtures; the H.264 ones are I_PCM IDR pictures every 12
frames, P pictures of P_Skip with a moving band of I_PCM macroblock columns,
and, in ipb_112.mp4, two B_Skip pictures between references):
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

tests/data/videos_h264/ (x264 through libavcodec, 30 fps, of
``x264_source``'s frames: a textured background that pans by fractions of
a sample and three textured discs that move each their own way, so that
the motion vectors vary, in the pixel format the file's name selects
(``pix_fmt_of``: yuv420p, or yuv444p, yuv422p, gray, and yuv420p10le,
yuv422p10le and yuv444p10le, whose samples are four times the 8-bit ones);
each
stream muxed by auformer_torch.data.fixtures,
in MP4 with avcC, stss, and ctts plus an edit list where there are B
frames, or in AVI). ``X264_STREAMS`` lists each file's size, frame count,
x264 options and what it exercises; expected.json repeats the options and
the account beside cv2's numbers: the JAX package's ``count_frames()`` and
its timestamps text; for the streams the port decodes, also the SHA-256 of
each RGB frame and of ``read_RGB(k)`` at ``SEEKS_X264`` (null past the last
frame), and the SHA-256 of each frame's Y, U and V planes from libavcodec's
own ``h264`` decoder (``planes_sha256``; samples deeper than 8 bits as
16-bit little-endian words), so that a mismatch can be placed in the
decoder or in the colour conversion. The frames are cv2's where they are
real (``frames_from`` "cv2": the same in another process and equal to
swscale's conversion of libavcodec's planes; deeper than 8 bits, to
auformer_torch's ``yuv_rgb_plain`` of them, since the system's libswscale
6.7 converts those by another route than cv2's 9.5); cv2 flags MBAFF
frames interlaced and returns a buffer it never wrote (ROADMAP.md C14), so
for those streams they are the system's libswscale 6.7 conversion of
libavcodec's frames, with cv2's flags (``frames_from`` "swscale"), a
route the script first checks against every progressive stream's cv2
frames bit for bit: libswscale 6.7 and cv2's 9.5 agree on the 4:4:4,
4:2:2 and monochrome streams too (libavcodec puts monochrome out as
yuv420p with chroma 128). An MBAFF stream deeper than 8 bits has
``yuv_rgb_plain``'s frames of libavcodec's planes (``frames_from``
"plain"). x264 drops weightp on interlaced streams. The refused stream
(4:2:2 coded for fields) keeps only cv2's count and timestamps.
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


def write_pcm(out: str) -> None:
    """tests/data/videos_decode/ (module docstring)."""
    from auformer.data import ingest
    from auformer.data.video import Video
    from auformer_torch.data.fixtures import (fixture_frame, write_h264,
                                              write_mjpeg_avi)
    from auformer_torch.data.native import encode_jpeg
    os.makedirs(out, exist_ok=True)
    write_h264(os.path.join(out, "ip_112.mp4"), SIZE, SIZE, FRAMES,
               gop=GOP, seed=1)
    write_h264(os.path.join(out, "ipb_112.mp4"), SIZE, SIZE, FRAMES,
               gop=GOP, b_frames=2, band=2, seed=2)
    write_h264(os.path.join(out, "ip_112.avi"), SIZE, SIZE, FRAMES,
               gop=GOP, seed=3)
    write_mjpeg_avi(os.path.join(out, "mjpg_112.avi"),
                    [encode_jpeg(fixture_frame(4, 0, t, SIZE), 90)
                     for t in range(12)], SIZE, SIZE)
    expected = {}
    for name in sorted(os.listdir(out)):
        if not name.endswith((".mp4", ".avi")):
            continue
        path = os.path.join(out, name)
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
            np.savez_compressed(os.path.join(out, "mjpg_112.npz"),
                                frames=np.stack(frames))
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")



# ---- tests/data/videos_h264: x264 through libavcodec ----------------------

SEEKS_X264 = (0, 5, 11, 12, 13, 17, 22, 23, 35, 40)

# (file, width, height, frames, x264 options, what it exercises); a
# stream's seed is its place in the list, so new streams go at the end
X264_STREAMS = [
    ("ip_cavlc_120x90.mp4", 120, 90, 24,
     "cabac=0:bframes=0:ref=1:8x8dct=0:keyint=12",
     "Baseline-style I and P pictures, IDR every 12, coded 120x96 and "
     "cropped to 90 rows"),
    ("ipb_main_176x144.mp4", 176, 144, 30,
     "cabac=0:bframes=3:b-pyramid=normal:ref=4:weightp=2:direct=spatial:"
     "8x8dct=0:slices=3:keyint=12",
     "Main profile CAVLC: B-pyramids (B pictures as references), four "
     "references, explicit weighted P prediction, spatial direct, three "
     "slices a picture"),
    ("ipb_temporal_176x144.mp4", 176, 144, 30,
     "cabac=0:bframes=3:b-pyramid=normal:ref=4:direct=temporal:weightb=1:"
     "constrained-intra=1:8x8dct=0:keyint=12",
     "temporal direct, implicit weighted bi-prediction "
     "(weighted_bipred_idc 2), constrained intra prediction"),
    ("high_cavlc_176x144.mp4", 176, 144, 30,
     "cabac=0:8x8dct=1:analyse=all:deblock=-2,-1:chroma-qp-offset=2:"
     "bframes=3:b-pyramid=normal:ref=3:keyint=12",
     "High profile CAVLC: the 8x8 transform and Intra_8x8, every "
     "partition, deblocking offsets, a chroma QP offset"),
    ("qp_low_176x144.mp4", 176, 144, 12,
     "cabac=0:qp=4:bframes=2:8x8dct=1:analyse=all:keyint=12",
     "QP 4: large levels (level_prefix 15 and up, suffixLength growth)"),
    ("qp_high_176x144.mp4", 176, 144, 24,
     "cabac=0:qp=48:bframes=2:keyint=12",
     "QP 48: few coefficients, the strongest deblocking"),
    ("nodeblock_176x144.avi", 176, 144, 24,
     "cabac=0:no-deblock=1:bframes=2:b-pyramid=none:keyint=12",
     "disable_deblocking_filter_idc 1, B pictures in AVI (Annex B chunks, "
     "no presentation times: cv2's timestamps are the decode times of the "
     "chunks that return the frames)"),
    ("bt709_176x144.mp4", 176, 144, 3, "cabac=0:colormatrix=bt709",
     "VUI matrix_coefficients 1: cv2 converts with BT.709"),
    ("smpte240m_176x144.mp4", 176, 144, 3, "cabac=0:colormatrix=smpte240m",
     "VUI matrix_coefficients 7: SMPTE 240M"),
    ("bt2020nc_176x144.mp4", 176, 144, 3, "cabac=0:colormatrix=bt2020nc",
     "VUI matrix_coefficients 9: BT.2020 non-constant luminance"),
    ("fcc_176x144.mp4", 176, 144, 3, "cabac=0:colormatrix=fcc",
     "VUI matrix_coefficients 4: FCC"),
    ("fullrange_176x144.mp4", 176, 144, 3, "cabac=0:fullrange=on",
     "video_full_range_flag 1: cv2 converts as full range (yuvj420p)"),
    ("fullrange_bt709_176x144.mp4", 176, 144, 3,
     "cabac=0:fullrange=on:colormatrix=bt709",
     "full range with BT.709: swscale's row scaled by 224 / 255"),
    ("ipb_1280x720.mp4", 1280, 720, 24,
     "cabac=0:8x8dct=1:bframes=3:b-pyramid=normal:ref=3:weightp=2:crf=26",
     "High profile CAVLC at full width, at an encoder's rate (crf 26)"),
    # x264's defaults: CABAC; with cqm, scaling matrices
    ("cabac_176x144.mp4", 176, 144, 3, "bframes=2",
     "x264's default CABAC: I, P and B slices, spatial direct, the 8x8 "
     "transform"),
    ("interlaced_176x144.mp4", 176, 144, 12, "cabac=0:interlaced=1",
     "MBAFF CAVLC, top field first: field and frame macroblock pairs, "
     "field scans, B pictures"),
    ("cqm_176x144.mp4", 176, 144, 3, "cabac=0:cqm=jvt",
     "CAVLC with the standard's default scaling lists (cqm=jvt)"),
    ("yuv444_176x144.mp4", 176, 144, 3, "cabac=0",
     "chroma_format_idc 3 (4:4:4), CAVLC"),
    # CABAC and scaling matrices
    ("ip_cabac_176x144.mp4", 176, 144, 24,
     "bframes=0:ref=1:8x8dct=0:keyint=12",
     "CABAC I and P pictures: mb_skip_flag, P partitions down to 4x4, "
     "ref_idx and mvd contexts with one reference"),
    ("high_cabac_176x144.mp4", 176, 144, 30,
     "8x8dct=1:analyse=all:deblock=-2,-1:chroma-qp-offset=2:bframes=3:"
     "b-pyramid=normal:ref=3:weightp=2:keyint=12",
     "High profile CABAC: transform_size_8x8_flag and the 8x8 significance "
     "map (ctxBlockCat 5), Intra_8x8, B-pyramids, three references, "
     "explicit weighted P prediction, deblocking and chroma QP offsets"),
    ("slices_cabac_176x144.mp4", 176, 144, 30,
     "bframes=3:b-pyramid=normal:ref=4:direct=temporal:weightb=1:"
     "constrained-intra=1:8x8dct=0:slices=3:keyint=12",
     "CABAC with three slices a picture (engine and context initialisation "
     "per slice, neighbours across slice edges unavailable), temporal "
     "direct, implicit weights, constrained intra prediction"),
    ("idc1_cabac_176x144.mp4", 176, 144, 12,
     "cabac-idc=1:bframes=2:keyint=12", "cabac_init_idc 1"),
    ("idc2_cabac_176x144.mp4", 176, 144, 12,
     "cabac-idc=2:bframes=2:keyint=12", "cabac_init_idc 2"),
    ("qp_low_cabac_176x144.mp4", 176, 144, 12,
     "qp=1:psy=0:subme=7:bframes=2:8x8dct=1:analyse=all:keyint=12",
     "QP 1: large levels (the UEG0 suffix of coeff_abs_level_minus1, "
     "long mvd suffixes), I_PCM where x264 chooses it"),
    ("qp_high_cabac_176x144.mp4", 176, 144, 24,
     "qp=48:bframes=2:keyint=12",
     "QP 48: mostly skipped macroblocks, few coefficients"),
    ("cqm_cabac_176x144.mp4", 176, 144, 12,
     "cqm=jvt:8x8dct=1:bframes=2:keyint=12",
     "CABAC with the default scaling lists (useDefaultScalingMatrixFlag), "
     "4x4 and 8x8"),
    ("cqm_custom_176x144.mp4", 176, 144, 12,
     "cqm4iy=" + ",".join(str(6 + 3 * k) for k in range(16))
     + ":cqm4pc=" + ",".join(str(24 - k) for k in range(16))
     + ":cqm8i=" + ",".join(str(8 + (k % 8) + 2 * (k // 8))
                            for k in range(64))
     + ":8x8dct=1:bframes=2:keyint=12",
     "lists that are neither flat nor the defaults: Intra Y 4x4, Inter "
     "chroma 4x4 and Intra 8x8 given, the others by the fall-back rules"),
    ("ipb_cabac_1280x720.mp4", 1280, 720, 24,
     "bframes=3:b-pyramid=normal:ref=3:weightp=2:8x8dct=1:crf=26",
     "x264's High profile defaults at full width, at an encoder's rate "
     "(crf 26)"),
    # interlaced: frame_mbs_only_flag 0, the source's two fields half a
    # frame apart (x264_source), so that x264 codes pairs as fields
    ("mbaff_cabac_176x144.mp4", 176, 144, 24,
     "interlaced=1:bframes=3:b-pyramid=normal:ref=3:8x8dct=1:keyint=12",
     "MBAFF CABAC, top field first: mb_field_decoding_flag, CABAC's field "
     "contexts, field reference lists, B-pyramids, the 8x8 transform"),
    ("mbaff_bff_cabac_176x144.mp4", 176, 144, 12, "bff=1:keyint=12",
     "MBAFF CABAC, bottom field first"),
    ("mbaff_temporal_cabac_176x144.mp4", 176, 144, 24,
     "interlaced=1:bframes=3:b-pyramid=normal:direct=temporal:weightb=1:"
     "slices=3:keyint=12",
     "MBAFF temporal direct (co-located field and frame pairs), implicit "
     "weights from field order counts, three slices a picture"),
    ("fakeint_cabac_176x144.mp4", 176, 144, 12,
     "fake-interlaced=1:bframes=2:keyint=12",
     "frame_mbs_only_flag 0 without MBAFF (fake-interlaced): frame "
     "pictures of a stream flagged for fields"),
    ("ipb_mbaff_1920x1080.mp4", 1920, 1080, 12, "interlaced=1:crf=26",
     "MBAFF at AVCHD's 1920x1080 (CropUnitY 4: 1088 rows cropped by 8), "
     "x264's High profile defaults at an encoder's rate (crf 26)"),
    # the other chroma formats (pix_fmt_of: from the name) and lossless
    # coding; yuv444_176x144.mp4 above decodes too
    ("yuv444_cabac_176x144.mp4", 176, 144, 24,
     "bframes=3:b-pyramid=normal:ref=3:weightp=2:8x8dct=1:analyse=all:"
     "keyint=12",
     "4:4:4 CABAC (High 4:4:4 Predictive): ctxIdx 460-1023, Cb and Cr "
     "coded as luma (8x8 and Intra_16x16 blocks, luma intra modes, 6-tap "
     "interpolation, weights, the luma deblocking filter)"),
    ("yuv444_cavlc_176x144.mp4", 176, 144, 24,
     "cabac=0:bframes=3:ref=3:8x8dct=1:analyse=all:chroma-qp-offset=2:"
     "keyint=12",
     "4:4:4 CAVLC: nC from each plane's own neighbours, the chroma QP "
     "offsets"),
    ("yuv444_cqm_cabac_176x144.mp4", 176, 144, 12,
     "cqm=jvt:8x8dct=1:bframes=2:keyint=12",
     "4:4:4 with scaling lists: 12 in the SPS, the Cb and Cr 8x8 lists' "
     "fall-back"),
    ("yuv444_fullrange_bt709_176x144.mp4", 176, 144, 3,
     "fullrange=on:colormatrix=bt709",
     "4:4:4 at full range with BT.709: swscale's full-chroma route"),
    ("yuv422_cabac_176x144.mp4", 176, 144, 24,
     "bframes=3:b-pyramid=normal:ref=3:8x8dct=1:analyse=all:keyint=12",
     "4:2:2 CABAC (High 4:2:2): the 2x4 chroma DC, its 8-coefficient "
     "contexts, 8x16 chroma intra prediction, vertical chroma vectors in "
     "luma units, the 4:2:2 deblocking edges"),
    ("yuv422_cavlc_176x144.mp4", 176, 144, 24,
     "cabac=0:bframes=2:8x8dct=1:cqm=jvt:keyint=12",
     "4:2:2 CAVLC: the nC = -2 chroma DC tables, its dequantisation with "
     "scaling lists"),
    ("gray_176x144.mp4", 176, 144, 12, "bframes=2:keyint=12",
     "chroma_format_idc 0 (monochrome): no chroma syntax; libavcodec "
     "outputs 4:2:0 planes whose chroma is 128"),
    ("lossless_cavlc_176x144.mp4", 176, 144, 12,
     "cabac=0:qp=0:bframes=2:keyint=12",
     "transform bypass (qpprime_y_zero_transform_bypass_flag, QP 0) with "
     "CAVLC, 4:2:0"),
    ("lossless_yuv444_176x144.mp4", 176, 144, 12,
     "qp=0:bframes=2:keyint=12",
     "transform bypass with CABAC at 4:4:4: -crf 0 from an RGB source"),
    ("ipb_yuv444_1280x720.mp4", 1280, 720, 24,
     "bframes=3:b-pyramid=normal:ref=3:8x8dct=1:crf=26",
     "4:4:4 at full width: x264's High 4:4:4 defaults at an encoder's "
     "rate (crf 26)"),
    ("high10_176x144.mp4", 176, 144, 3, "cabac=0",
     "10-bit 4:2:0 (High 10) CAVLC: 16-bit samples, swscale's high-depth "
     "route in cv2"),
    # bit depths above 8 (pix_fmt_of: yuv420p10le, yuv422p10le,
    # yuv444p10le)
    ("high10_cabac_176x144.mp4", 176, 144, 24,
     "bframes=3:b-pyramid=normal:ref=3:weightp=2:8x8dct=1:keyint=12",
     "High 10 CABAC: B-pyramids, explicit weighted P prediction with "
     "offsets scaled to 10 bits, the 8x8 transform, the deblocking "
     "filter's thresholds scaled to 10 bits"),
    ("high10_cqm_cabac_176x144.mp4", 176, 144, 12,
     "cqm=jvt:8x8dct=1:bframes=2:keyint=12",
     "High 10 with the default scaling lists"),
    ("high10_qp_low_176x144.mp4", 176, 144, 12,
     "qp=4:bframes=2:8x8dct=1:analyse=all:keyint=12",
     "High 10 at x264's QP 4 (QP'Y 4): a negative slice QPY, QpBdOffset "
     "in every QP, mb_qp_delta's wider range"),
    ("high10_lossless_176x144.mp4", 176, 144, 12, "qp=0:bframes=2:keyint=12",
     "10-bit transform bypass (QP'Y 0, QPY -12)"),
    ("high422_10_cabac_176x144.mp4", 176, 144, 24,
     "bframes=3:b-pyramid=normal:ref=3:8x8dct=1:analyse=all:keyint=12",
     "High 4:2:2 at 10 bits: swscale's high-depth route without vertical "
     "chroma interpolation"),
    ("high444_10_cabac_176x144.mp4", 176, 144, 24,
     "bframes=3:b-pyramid=normal:ref=3:weightp=2:8x8dct=1:analyse=all:"
     "keyint=12",
     "High 4:4:4 Predictive at 10 bits: the full-chroma route from 15-bit "
     "samples"),
    ("mbaff_high10_cabac_176x144.mp4", 176, 144, 24,
     "interlaced=1:bframes=3:b-pyramid=normal:ref=3:8x8dct=1:keyint=12",
     "MBAFF at 10 bits: held to libavcodec's planes and to yuv_rgb_plain "
     "of them (frames_from \"plain\": cv2 does not convert MBAFF frames, "
     "C14, and libswscale 6.7's 10-bit route is not cv2's)"),
    ("ipb_high10_1280x720.mp4", 1280, 720, 24,
     "bframes=3:b-pyramid=normal:ref=3:8x8dct=1:crf=26",
     "x264's High 10 defaults at full width, at an encoder's rate (crf "
     "26): a 10-bit capture re-encoded"),
    # refused by the port: NotImplementedError naming A9
    ("mbaff_yuv422_176x144.mp4", 176, 144, 6, "interlaced=1",
     "4:2:2 coded for fields (interlaced, chroma_format_idc 2 with "
     "frame_mbs_only_flag 0)"),
]
X264_REFUSED = ("mbaff_yuv422_",)

X264_TOOL = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <libavcodec/avcodec.h>
#include <libavutil/frame.h>
#include <libavutil/mem.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
#include <libswscale/swscale.h>

/* encode W H N PIX_FMT PARAMS OUT: raw planar frames of the pixel format
   (yuv420p, yuv422p, yuv444p, gray and the 10le ones) on stdin; each
   packet to OUT as int64 pts, int64 dts, int32 key, int32 size, bytes */
static int put(AVCodecContext *c, AVPacket *p, FILE *out) {
  int rc;
  while ((rc = avcodec_receive_packet(c, p)) == 0) {
    int64_t t[2] = {p->pts, p->dts};
    int32_t k[2] = {(p->flags & AV_PKT_FLAG_KEY) != 0, p->size};
    fwrite(t, 8, 2, out);
    fwrite(k, 4, 2, out);
    fwrite(p->data, 1, p->size, out);
    av_packet_unref(p);
  }
  return rc == AVERROR(EAGAIN) || rc == AVERROR_EOF ? 0 : rc;
}

static int encode(int w, int h, int n, const char *pix_fmt,
                  const char *params, const char *path) {
  const AVCodec *codec = avcodec_find_encoder_by_name("libx264");
  if (!codec) return 10;
  AVCodecContext *c = avcodec_alloc_context3(codec);
  c->width = w;
  c->height = h;
  c->time_base = (AVRational){1, 30};
  c->framerate = (AVRational){30, 1};
  c->pix_fmt = av_get_pix_fmt(pix_fmt);
  if (c->pix_fmt == AV_PIX_FMT_NONE) return 15;
  c->thread_count = 1;
  av_opt_set(c->priv_data, "preset", "medium", 0);
  av_opt_set(c->priv_data, "x264-params", params, 0);
  if (avcodec_open2(c, codec, NULL) < 0) return 11;
  FILE *out = fopen(path, "wb");
  AVFrame *f = av_frame_alloc();
  f->format = c->pix_fmt;
  f->width = w;
  f->height = h;
  av_frame_get_buffer(f, 0);
  AVPacket *p = av_packet_alloc();
  const AVPixFmtDescriptor *d = av_pix_fmt_desc_get(c->pix_fmt);
  int planes = av_pix_fmt_count_planes(c->pix_fmt);
  int bytes = d->comp[0].depth > 8 ? 2 : 1;
  int cw = -((-w) >> d->log2_chroma_w), ch = -((-h) >> d->log2_chroma_h);
  /* libavcodec hands x264 each frame's field order: top field first
     unless the stream asks for bff */
  int interlaced = strstr(params, "interlaced=1") || strstr(params, "bff=1");
  for (int t = 0; t < n; ++t) {
    av_frame_make_writable(f);
    if (interlaced) f->top_field_first = !strstr(params, "bff=1");
    for (int k = 0; k < planes; ++k)
      for (int r = 0; r < (k ? ch : h); ++r)
        if (fread(f->data[k] + r * f->linesize[k], bytes, k ? cw : w, stdin) !=
            (size_t)(k ? cw : w))
          return 12;
    f->pts = t;
    if (avcodec_send_frame(c, f) < 0 || put(c, p, out)) return 13;
  }
  avcodec_send_frame(c, NULL);
  if (put(c, p, out)) return 14;
  fclose(out);
  return 0;
}

/* swscale's conversion to BGR24 as cv2's FFMPEG capture asks for it:
   bicubic at the same size, the frame's matrix and range */
static int bgr(AVFrame *f, FILE *out) {
  struct SwsContext *s = sws_getContext(f->width, f->height, f->format,
                                        f->width, f->height, AV_PIX_FMT_BGR24,
                                        SWS_BICUBIC, NULL, NULL, NULL);
  if (!s) return 1;
  int full = f->color_range == AVCOL_RANGE_JPEG ||
             f->format == AV_PIX_FMT_YUVJ420P;
  sws_setColorspaceDetails(s, sws_getCoefficients(f->colorspace), full,
                           sws_getCoefficients(SWS_CS_DEFAULT), full, 0,
                           1 << 16, 1 << 16);
  /* rows padded as av_image_alloc pads them: swscale writes past 3 w */
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

/* decode OUT [BGR]: Annex B units (int32 size, bytes) on stdin through
   libavcodec's h264 decoder; each frame's cropped Y, U, V planes to OUT,
   and its swscale BGR24 frame to BGR */
static int decode(const char *path, const char *bgr_path) {
  const AVCodec *codec = avcodec_find_decoder_by_name("h264");
  AVCodecContext *c = avcodec_alloc_context3(codec);
  c->thread_count = 1;
  if (avcodec_open2(c, codec, NULL) < 0) return 20;
  FILE *out = fopen(path, "wb");
  FILE *rgb = bgr_path ? fopen(bgr_path, "wb") : NULL;
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
      const AVPixFmtDescriptor *d = av_pix_fmt_desc_get(f->format);
      if (d->flags & AV_PIX_FMT_FLAG_RGB) return 23;
      fprintf(stderr, "format %s\n", d->name); /* x264_planes reads it */
      /* samples deeper than 8 bits as libavcodec holds them: 16-bit
         little endian */
      int bytes = d->comp[0].depth > 8 ? 2 : 1;
      for (int k = 0; k < av_pix_fmt_count_planes(f->format); ++k) {
        int pw = k ? -((-f->width) >> d->log2_chroma_w) : f->width;
        int ph = k ? -((-f->height) >> d->log2_chroma_h) : f->height;
        for (int r = 0; r < ph; ++r)
          fwrite(f->data[k] + r * f->linesize[k], bytes, pw, out);
      }
      if (rgb && bgr(f, rgb)) return 24;
      av_frame_unref(f);
    }
  }
  fclose(out);
  if (rgb) fclose(rgb);
  return 0;
}

int main(int argc, char **argv) {
  if (argc == 8 && !strcmp(argv[1], "encode"))
    return encode(atoi(argv[2]), atoi(argv[3]), atoi(argv[4]), argv[5],
                  argv[6], argv[7]);
  if ((argc == 3 || argc == 4) && !strcmp(argv[1], "decode"))
    return decode(argv[2], argc == 4 ? argv[3] : NULL);
  return 2;
}
"""


def build_x264_tool(tmp: str) -> str:
    """Compile X264_TOOL against the system's libavcodec; its path."""
    import subprocess
    src, exe = os.path.join(tmp, "x264tool.c"), os.path.join(tmp, "x264tool")
    with open(src, "w") as f:
        f.write(X264_TOOL)
    subprocess.run(["gcc", "-O2", src, "-o", exe, "-lavcodec", "-lswscale",
                    "-lavutil"], check=True)
    return exe


def _sample(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear sample of a texture at 4x magnification, wrapping."""
    n = tex.shape[0]
    x, y = x / 4.0, y / 4.0
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    x0, y0 = x0 % n, y0 % n
    x1, y1 = (x0 + 1) % n, (y0 + 1) % n
    return ((1 - fy) * ((1 - fx) * tex[y0, x0] + fx * tex[y0, x1])
            + fy * ((1 - fx) * tex[y1, x0] + fx * tex[y1, x1]))


def x264_source(seed: int, t: int, height: int, width: int,
                pix_fmt: str = "yuv420p", fields: str | None = None,
                speed: float = 1) -> list[np.ndarray]:
    """Frame t's planes in the pixel format ``pix_fmt`` (``PIX_FMTS``: Y,
    U and V; Y alone for "gray"; 10-bit samples, four times the 8-bit ones,
    for "yuv420p10le"): a texture that pans
    1.3 samples right and 0.7 down a frame, three textured discs that move
    each their own way (``speed`` times as fast), a little noise, smooth
    moving chroma. With ``fields`` ("tff" or "bff") the frame is
    interlaced: the first field's rows (even ones for "tff", odd ones for
    "bff") show instant t, the other field's t + 1/2, the discs
    ``FIELD_SPEED`` times as fast, so that x264 codes the pairs they cross
    as fields and the slowly panning background as frames."""
    if fields is not None:
        first = x264_source(seed, t, height, width, pix_fmt,
                            speed=FIELD_SPEED)
        second = x264_source(seed, t + 0.5, height, width, pix_fmt,
                             speed=FIELD_SPEED)
        odd_first = fields == "bff"
        for a, b in zip(first, second):
            a[1 - odd_first::2] = b[1 - odd_first::2]
        return first
    rs = np.random.RandomState(seed)
    tex = rs.rand(64, 64)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    y = 40 + 150 * _sample(tex, xx + 1.3 * t, yy + 0.7 * t)
    for k in range(3):
        cx = width * (0.2 + 0.3 * k) + (2.5 - 1.75 * k) * (t * speed)
        cy = (height * (0.3 + 0.2 * k)
              + (1.0 + 0.6 * k) * (t * speed) * (-1) ** k)
        r = min(height, width) * (0.12 + 0.04 * k)
        disc = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        y = np.where(disc, 60 + 120 * _sample(tex, xx - cx + 40 * k, yy - cy),
                     y)
    noise = [seed, t] if t == int(t) else [seed, int(t), 1]
    y += np.random.RandomState(noise).standard_normal(y.shape) * 2
    sy, sx = PIX_FMTS[pix_fmt]
    cyy, cxx = yy[::sy, ::sx], xx[::sy, ::sx]
    u = 128 + 60 * np.sin((cxx + t) / width * 6.3) * np.cos(cyy / height * 3)
    v = 128 + 60 * np.cos((cyy - t) / height * 6.3)
    planes = [np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, u, v)]
    if pix_fmt == "gray":
        return planes[:1]
    if pix_fmt.endswith("10le"):
        return [p.astype("<u2") * 4 for p in planes]
    return planes


# the chroma subsampling (rows, columns) of each pixel format x264 writes
# here; gray's has no chroma planes
PIX_FMTS = {"yuv420p": (2, 2), "yuv422p": (1, 2), "yuv444p": (1, 1),
            "gray": (1, 1), "yuv420p10le": (2, 2), "yuv422p10le": (1, 2),
            "yuv444p10le": (1, 1)}


def pix_fmt_of(name: str) -> str:
    """The pixel format of X264_STREAMS' file ``name``: 10-bit for the
    High 10, High 4:2:2 10 and High 4:4:4 10 streams (``high10``,
    ``high422_10``, ``high444_10``)."""
    for tag, fmt in (("high422_10", "yuv422p10le"),
                     ("high444_10", "yuv444p10le"),
                     ("high10", "yuv420p10le"), ("yuv444", "yuv444p"),
                     ("yuv422", "yuv422p"), ("gray", "gray")):
        if tag in name:
            return fmt
    return "yuv420p"


FIELD_SPEED = 6


def field_order(params: str) -> str | None:
    """"tff" or "bff" for an x264 stream coded interlaced (MBAFF), whose
    source x264_source renders as two fields; None for a progressive
    source (fake-interlaced streams too)."""
    opts = dict(o.split("=", 1) for o in params.split(":"))
    if opts.get("bff") == "1":
        return "bff"
    return "tff" if opts.get("interlaced") == "1" else None


def x264_encode(tool: str, tmp: str, width: int, height: int, n: int,
                params: str, seed: int, pix_fmt: str = "yuv420p"
                ) -> list[tuple]:
    """(pts, key, Annex B bytes) of each packet in decode order."""
    import struct
    import subprocess
    fields = field_order(params)
    raw = b"".join(p.tobytes() for t in range(n)
                   for p in x264_source(seed, t, height, width, pix_fmt,
                                        fields))
    out = os.path.join(tmp, "packets")
    subprocess.run([tool, "encode", str(width), str(height), str(n),
                    pix_fmt, params, out], input=raw, check=True,
                   capture_output=True)
    data, off, packets = open(out, "rb").read(), 0, []
    while off < len(data):
        pts, _, key, size = struct.unpack_from("<qqii", data, off)
        off += 24
        packets.append((pts, bool(key), data[off:off + size]))
        off += size
    return packets


def x264_planes(tool: str, tmp: str, units: list[bytes], width: int,
                height: int) -> tuple[list[dict], list[str], list[tuple]]:
    """SHA-256 of libavcodec's planes of each frame it outputs (Y, U and V;
    Y alone for a gray frame; 16-bit little-endian samples for a format
    deeper than 8 bits), of each frame as swscale converts it to RGB (the
    route cv2 takes at 8 bits, done here with the system's libswscale,
    which converts interlaced frames as it does progressive ones), and the
    planes themselves of the frames deeper than 8 bits (int16 arrays)."""
    import struct
    import subprocess
    out, bgr = os.path.join(tmp, "planes"), os.path.join(tmp, "bgr")
    run = subprocess.run([tool, "decode", out, bgr], check=True,
                         capture_output=True,
                         input=b"".join(struct.pack("<i", len(u)) + u
                                        for u in units))
    formats = [line.split()[1] for line in run.stderr.decode().splitlines()
               if line.startswith("format ")]
    raw = np.fromfile(out, np.uint8)
    frames, deep, off = [], [], 0
    for fmt in formats:
        sy, sx = PIX_FMTS[fmt.replace("yuvj", "yuv")]
        cw, ch = -(-width // sx), -(-height // sy)
        shapes = [(height, width)] + ([] if fmt == "gray" else [(ch, cw)] * 2)
        size = 2 if fmt.endswith("10le") else 1
        entry, arrays = {}, []
        for key, shape in zip("yuv", shapes):
            n = size * shape[0] * shape[1]
            entry[key] = sha(raw[off:off + n])
            arrays.append(raw[off:off + n].view("<i2").reshape(shape)
                          if size == 2 else None)
            off += n
        frames.append(entry)
        if size == 2:
            deep.append(tuple(arrays))
    assert off == raw.size, "libavcodec's planes do not add up"
    rgb = np.fromfile(bgr, np.uint8).reshape(-1, height, width, 3)[..., ::-1]
    return frames, [sha(f) for f in rgb], deep


def cv2_frames_elsewhere(path: str) -> list[str]:
    """SHA-256 of the JAX package's frames of ``path`` read in a process of
    their own."""
    import subprocess
    code = ("import hashlib, json, sys, numpy as np\n"
            "from auformer.data.video import Video\n"
            "print(json.dumps([hashlib.sha256(np.ascontiguousarray(f)"
            ".tobytes()).hexdigest() for f in Video(sys.argv[1], "
            "write=False).frames()]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, path], check=True,
                         capture_output=True, text=True, env=env,
                         cwd=os.getcwd())
    return json.loads(out.stdout.strip().splitlines()[-1])


def x264_mux(path: str, packets: list[tuple], width: int, height: int
             ) -> None:
    """Write the packets to an MP4 (avcC from the first SPS and PPS, the
    parameter sets out of the samples; ctts and an edit list where decode
    order differs from presentation order) or an AVI (Annex B chunks)."""
    import struct
    from auformer_torch.data.bitstream import annexb_nals
    from auformer_torch.data.fixtures import _avi, _frame_rate, _mp4
    delta, scale = _frame_rate(30.0)
    sync = [key for _, key, _ in packets]
    with open(path, "wb") as f:
        if path.endswith(".avi"):
            f.write(_avi([u for _, _, u in packets], sync, b"H264", delta,
                         scale, width, height))
            return
        nals = [annexb_nals(u) for _, _, u in packets]
        sps = next(n for ns in nals for n in ns if n[0] & 0x1F == 7)
        pps = next(n for ns in nals for n in ns if n[0] & 0x1F == 8)
        avcc = (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
                + struct.pack(">H", len(sps)) + sps + b"\x01"
                + struct.pack(">H", len(pps)) + pps)
        samples = [b"".join(struct.pack(">I", len(n)) + n for n in ns
                            if n[0] & 0x1F not in (7, 8, 9))
                   for ns in nals]
        order = [pts for pts, _, _ in packets]
        shift = max(0, max(k - t for k, t in enumerate(order)))
        offsets = [(t + shift - k) * delta for k, t in enumerate(order)]
        f.write(_mp4(samples, sync, offsets, delta, scale, width, height,
                     avcc, shift * delta))


def write_x264(out: str) -> None:
    """tests/data/videos_h264/ (module docstring)."""
    import torch
    from auformer.data import ingest
    from auformer.data.video import Video
    from auformer_torch.ops.colour import yuv_rgb_plain
    os.makedirs(out, exist_ok=True)
    expected = {}
    with tempfile.TemporaryDirectory() as tmp:
        tool = build_x264_tool(tmp)
        for seed, (name, w, h, n, params, what) in enumerate(X264_STREAMS):
            pix_fmt = pix_fmt_of(name)
            packets = x264_encode(tool, tmp, w, h, n, params, seed + 1,
                                  pix_fmt)
            path = os.path.join(out, name)
            x264_mux(path, packets, w, h)
            ts = ingest.extract_timestamps(path, os.path.join(tmp, "ts.txt"))
            with open(ts) as f:
                stamps = f.read()
            entry = {"x264": params, "exercises": what,
                     "count_frames": Video(path, write=False).count_frames(),
                     "timestamps": stamps}
            if name.startswith(X264_REFUSED):   # the port gives no frames
                expected[name] = entry
                print(name, os.path.getsize(path), "bytes")
                continue
            planes, converted, deep = x264_planes(
                tool, tmp, [u for _, _, u in packets], w, h)
            v = Video(path, write=False)
            theirs = [sha(f) for f in v.frames()]
            progressive = (field_order(params) is None
                           and "interlaced" not in params)
            if deep:
                # libswscale 6.7's high-depth route is not cv2's 9.5: the
                # frames are cv2's where they are real, else yuv_rgb_plain
                # of libavcodec's planes (the VUI gives no colour here),
                # which must give cv2's on every progressive stream
                assert not any(o in params for o in ("colormatrix",
                                                     "fullrange"))
                source, reference = "plain", [sha(yuv_rgb_plain(
                    *(torch.from_numpy(p) for p in yuv), limited=True,
                    bit_depth=10).numpy()) for yuv in deep]
                real = progressive and cv2_frames_elsewhere(path) == theirs
                if progressive:
                    assert real and reference == theirs, \
                        f"{name}: yuv_rgb_plain's frames are not cv2's"
            else:
                # cv2's frames are real when they are swscale's conversion
                # of libavcodec's planes and the same in another process;
                # where libavcodec flags a frame interlaced, cv2's newer
                # swscale refuses it and cv2 returns a buffer never
                # written (C14)
                source, reference = "swscale", converted
                real = theirs == converted and (
                    progressive or cv2_frames_elsewhere(path) == theirs)
                # the swscale route reproduces cv2 wherever cv2's frames
                # are real: the progressive streams check it
                if progressive:
                    assert real, f"{name}: swscale's frames are not cv2's"
            if real:
                seeks = {str(k): sha(img) if (img := v.read_RGB(k))
                         is not None else None for k in SEEKS_X264}
            else:
                seeks = {str(k): reference[k] if k < len(reference) else None
                         for k in SEEKS_X264}
            v.release()
            entry.update(frames_sha256=theirs if real else reference,
                         read_RGB_sha256=seeks, planes_sha256=planes,
                         frames_from="cv2" if real else source)
            expected[name] = entry
            print(name, os.path.getsize(path), "bytes")
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--x264", action="store_true",
                    help="write tests/data/videos_h264 (x264 streams)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    if args.x264:
        write_x264(args.out or "tests/data/videos_h264")
    else:
        write_pcm(args.out or "tests/data/videos_decode")


if __name__ == "__main__":
    main()
