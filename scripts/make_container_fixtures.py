"""Write the Matroska/WebM and fragmented MP4 fixtures of
tests/data/videos_container/ and what the JAX package reads from them
(expected.json).

Needs ``gcc`` and the system's FFmpeg libraries with their headers
(libavformat 59, libavcodec 59 with libvpx, libaom and libx265), through
which ``AV_TOOL`` remuxes the streams already committed (without
re-encoding them) and encodes the three codecs the port does not decode;
cv2 with its FFMPEG backend and the JAX package, which read each file for
its numbers. Neither the port nor a test runs this script: the tests read
the committed files. Run from the root of the repository:

    JAX_PLATFORMS=cpu python scripts/make_container_fixtures.py \
        [--out tests/data/videos_container]

It writes the folder anew: run scripts/make_stream_fixtures.py after it
for the ASF and MPEG stream files and their entries.

Files written by libavformat 59 (``AV_TOOL remux``: the source's packets
with their times, the frame rate as the stream's ``avg_frame_rate``, so
that the Matroska muxer writes DefaultDuration, Cues, CRC-32 elements and
the Segment's Duration):
  h264_ipb_176x144.mkv        videos_h264/ipb_main_176x144.mp4 (B-pyramid,
                              30 frames) behind a PCM audio track numbered
                              1 that runs 0.5 s past the video: cv2's
                              count comes from the Segment's Duration (45)
  h264_cabac_1280x720.mkv     videos_h264/ipb_cabac_1280x720.mp4, 24 frames
                              of 1280x720 CABAC with B frames (a 720p
                              recording as OBS writes it)
  h264_ntsc_176x144.mkv       videos_h264/high_cabac_176x144.mp4 retimed to
                              30000/1001 (DefaultDuration 33366666 ns,
                              millisecond block times)
  xvid_176.mkv                videos_mpeg4/xvid_176.avi as V_MPEG4/ISO/ASP,
                              a copy of its VOL as CodecPrivate
                              (extract_extradata), the stream's own in band
  mjpg_112.mkv                videos_decode/mjpg_112.avi as V_MJPEG
  h264_ipb_176x144_live.mkv   ipb_main_176x144.mp4 muxed to a pipe: a
                              Segment of unknown size, no Cues, no
                              Duration; cv2 knows no frame count and does
                              not seek
  h264_ipb_176x144_frag.mp4   movflags frag_keyframe+empty_moov (OBS's
                              fragmented MP4)
  h264_ipb_176x144_cmaf.mp4   frag_keyframe+empty_moov+default_base_moof
                              +global_sidx (DASH/CMAF as YouTube serves it)
  h264_ipb_176x144_firstfrag.mp4  frag_keyframe alone: the first GOP's
                              samples in the moov, the rest in fragments
  h264_ipb_176x144_live_frag.mp4  frag_keyframe+empty_moov to a pipe
  h264_cabac_1280x720_frag.mp4    ipb_cabac_1280x720.mp4 in fragments
  xvid_176_frag.mp4           xvid_176.avi in fragments (the VOL copied to
                              the esds)
Encoded by AV_TOOL (12 frames of make_h264_fixtures' x264_source at
176x144, 30 fps; meta only, the port decodes none of them):
  vp9_176x144.webm            libvpx-vp9
  av1_176x144.webm            libaom-av1
  hevc_176x144.mkv            libx265
Written by auformer_torch.data.fixtures (what libavformat does not write):
  h264_ipb_176x144_groups.mkv     write_matroska: BlockGroups with
                              BlockDuration and ReferenceBlock, behind a
                              PCM track numbered 1, TimestampScale 1 ms
  h264_ipb_176x144_unknown.mkv    SimpleBlocks in Clusters of unknown size
                              in a Segment of unknown size, no Cues, no
                              Duration
  mjpg_112_xiph.mkv           Xiph lacing, 3 frames a SimpleBlock (lace
                              times from DefaultDuration)
  mjpg_112_ebml.mkv           EBML lacing, 4 frames a BlockGroup (lace
                              times from BlockDuration)
  mjpg_112_fixed.mkv          fixed-size lacing, 2 frames a block, each
                              padded with zeros after its EOI
  mjpg_112_zlib.mkv           zlib ContentCompression of every frame
  xvid_176_strip.mkv          header stripping (as mkvmerge strips
                              headers: the start code prefix 00 00 01 out
                              of every frame),
                              TimestampScale 100000 ns
  xvid_176_vfw.mkv            V_MS/VFW/FOURCC XVID (mkvmerge's mapping of
                              an AVI): block times are decode times
  mpeg4_ipb_112x96_vfw.mkv    videos_mpeg4/ipb_112x96.avi (B-VOPs, not low
                              delay) as V_MS/VFW/FOURCC FMP4
  h264_ipb_176x144_truns.mp4  write_fragmented_mp4: two truns a traf,
                              per-sample flags, version-1 (signed)
                              composition offsets, explicit base offsets
  h264_ipb_176x144_moofbase.mp4   default-base-is-moof, a first-sample
                              flag over the tfhd's default, version-0
                              offsets, no tfdt, an edit list from the
                              first presentation time

expected.json: for each file its ``writer`` and ``source``, the JAX
package's ``meta`` (``Video(path, write=False).meta``), ``count_frames()``
and ``extract_timestamps`` text, and for the codecs the port decodes the
SHA-256 of each RGB frame from ``frames()`` and ``read_RGB`` as a list of
(k, SHA-256 or None past the last frame) in the order read, on one
``Video`` (the live file's reads depend on the ones before). A remux's
frames are asserted equal to its source's (the source's expected.json;
for MJPEG, whose frames the port matches within a tolerance, the same
JPEG data in every container).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile

import numpy as np

SEEKS = (0, 5, 11, 12, 13, 25)
WIDE_SEEKS = (0, 13, 23)           # the 720p files': each decodes a GOP

AV_TOOL = r"""#include <libavformat/avformat.h>
#include <libavcodec/avcodec.h>
#include <libavcodec/bsf.h>
#include <libavutil/opt.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static AVFormatContext *open_out(const char *path, const char *fmt) {
  AVFormatContext *o = NULL;
  if (avformat_alloc_output_context2(&o, NULL, fmt, path) < 0) exit(10);
  return o;
}

static void start(AVFormatContext *o, const char *path, const char *opts) {
  AVDictionary *d = NULL;
  if (*opts) av_dict_parse_string(&d, opts, "=", ",", 0);
  if (avio_open(&o->pb, strcmp(path, "-") ? path : "pipe:1",
                AVIO_FLAG_WRITE) < 0) exit(11);
  if (avformat_write_header(o, &d) < 0) exit(12);
  if (av_dict_count(d)) { fprintf(stderr, "unused muxer option\n"); exit(13); }
  av_dict_free(&d);
}

/* remux IN OUT FORMAT OPTS AUDIO_EXTRA_MS NTSC */
static int remux(char **a) {
  const char *in = a[0], *out = a[1], *fmt = a[2], *opts = a[3];
  int extra = atoi(a[4]), ntsc = atoi(a[5]);
  AVFormatContext *ic = NULL;
  if (avformat_open_input(&ic, in, NULL, NULL) < 0) return 20;
  if (avformat_find_stream_info(ic, NULL) < 0) return 21;
  int vi = av_find_best_stream(ic, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
  if (vi < 0) return 22;
  AVStream *is = ic->streams[vi];
  AVFormatContext *o = open_out(out, fmt);
  AVStream *as = NULL;
  if (extra) {
    as = avformat_new_stream(o, NULL);
    as->codecpar->codec_type = AVMEDIA_TYPE_AUDIO;
    as->codecpar->codec_id = AV_CODEC_ID_PCM_S16LE;
    as->codecpar->sample_rate = 8000;
    av_channel_layout_default(&as->codecpar->ch_layout, 1);
    as->codecpar->bits_per_coded_sample = 16;
    as->codecpar->block_align = 2;
    as->time_base = (AVRational){1, 8000};
  }
  AVStream *os = avformat_new_stream(o, NULL);
  avcodec_parameters_copy(os->codecpar, is->codecpar);
  os->codecpar->codec_tag = 0;
  AVRational rate = ntsc ? (AVRational){30000, 1001} : is->avg_frame_rate;
  os->avg_frame_rate = rate;
  os->time_base = av_inv_q(rate);
  if (is->codecpar->codec_id == AV_CODEC_ID_MPEG4 &&
      !is->codecpar->extradata_size) {
    /* a copy of the first packet's VOL as the codec's setup data (the
       stream keeps its own in band) */
    AVBSFContext *bsf = NULL;
    av_bsf_alloc(av_bsf_get_by_name("extract_extradata"), &bsf);
    avcodec_parameters_copy(bsf->par_in, is->codecpar);
    av_bsf_init(bsf);
    AVPacket *p = av_packet_alloc();
    av_read_frame(ic, p);
    while (p->stream_index != vi) { av_packet_unref(p); av_read_frame(ic, p); }
    size_t n;
    av_bsf_send_packet(bsf, p);
    av_bsf_receive_packet(bsf, p);
    uint8_t *x = av_packet_get_side_data(p, AV_PKT_DATA_NEW_EXTRADATA, &n);
    if (!x) return 23;
    os->codecpar->extradata = av_mallocz(n + AV_INPUT_BUFFER_PADDING_SIZE);
    memcpy(os->codecpar->extradata, x, n);
    os->codecpar->extradata_size = n;
    av_packet_free(&p);
    av_bsf_free(&bsf);
    av_seek_frame(ic, vi, 0, AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE);
  }
  start(o, out, opts);
  AVPacket *p = av_packet_alloc();
  int64_t samples = 0, total = -1;
  AVRational src = av_inv_q(rate);
  /* the video's frames are numbered 0.. in presentation order by their
     pts in frames of the source's rate */
  AVPacket **vp = NULL; int nv = 0;
  while (av_read_frame(ic, p) >= 0) {
    if (p->stream_index != vi) { av_packet_unref(p); continue; }
    vp = realloc(vp, sizeof(*vp) * (nv + 1));
    vp[nv++] = av_packet_clone(p);
    av_packet_unref(p);
  }
  AVRational ist = is->time_base, fr = is->avg_frame_rate;
  for (int k = 0; k < nv; ++k) {
    AVPacket *q = vp[k];
    int64_t pts = q->pts == AV_NOPTS_VALUE ? q->dts : q->pts;
    /* to frames of the source's rate */
    int64_t fp = av_rescale_q_rnd(pts, ist, av_inv_q(fr), AV_ROUND_NEAR_INF);
    int64_t fd = q->dts == AV_NOPTS_VALUE ? fp :
        av_rescale_q_rnd(q->dts, ist, av_inv_q(fr), AV_ROUND_NEAR_INF);
    if (fp + 1 > total) total = fp + 1;
    q->pts = av_rescale_q(fp, src, os->time_base);
    q->dts = av_rescale_q(fd, src, os->time_base);
    q->duration = av_rescale_q(1, src, os->time_base);
    q->stream_index = os->index;
    q->pos = -1;
    if (as) { /* audio up to this packet's decode time */
      while (av_rescale_q(samples, (AVRational){1, 8000}, src) <= fd) {
        AVPacket *ap = av_packet_alloc();
        av_new_packet(ap, 1600);
        for (int s = 0; s < 800; ++s)
          ((int16_t *)ap->data)[s] = (int16_t)(3000 * ((samples + s) % 40 < 20 ? 1 : -1));
        ap->pts = ap->dts = samples; ap->duration = 800;
        ap->stream_index = as->index; ap->flags = AV_PKT_FLAG_KEY;
        av_packet_rescale_ts(ap, (AVRational){1, 8000}, as->time_base);
        samples += 800;
        if (av_interleaved_write_frame(o, ap) < 0) return 25;
        av_packet_free(&ap);
      }
    }
    if (av_interleaved_write_frame(o, q) < 0) return 26;
    av_packet_free(&q);
  }
  if (as) {
    int64_t end = av_rescale_q(total, src, (AVRational){1, 8000}) + 8 * extra;
    while (samples < end) {
      AVPacket *ap = av_packet_alloc();
      int n = end - samples < 800 ? end - samples : 800;
      av_new_packet(ap, 2 * n);
      memset(ap->data, 0, 2 * n);
      ap->pts = ap->dts = samples; ap->duration = n;
      ap->stream_index = as->index; ap->flags = AV_PKT_FLAG_KEY;
      av_packet_rescale_ts(ap, (AVRational){1, 8000}, as->time_base);
      samples += n;
      if (av_interleaved_write_frame(o, ap) < 0) return 27;
      av_packet_free(&ap);
    }
  }
  av_write_trailer(o);
  avio_closep(&o->pb);
  return 0;
}

/* encode ENCODER ENC_OPTS W H N OUT FORMAT MUX_OPTS: yuv420p frames on
   stdin at 30 fps */
static int encode(char **a) {
  const AVCodec *codec = avcodec_find_encoder_by_name(a[0]);
  if (!codec) return 30;
  int w = atoi(a[2]), h = atoi(a[3]), n = atoi(a[4]);
  AVFormatContext *o = open_out(a[5], a[6]);
  AVCodecContext *c = avcodec_alloc_context3(codec);
  c->width = w; c->height = h; c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->time_base = (AVRational){1, 30}; c->framerate = (AVRational){30, 1};
  c->gop_size = 12; c->thread_count = 1;
  if (o->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVDictionary *d = NULL;
  if (*a[1]) av_dict_parse_string(&d, a[1], "=", ",", 0);
  if (avcodec_open2(c, codec, &d) < 0) return 31;
  AVStream *os = avformat_new_stream(o, NULL);
  avcodec_parameters_from_context(os->codecpar, c);
  os->avg_frame_rate = c->framerate;
  os->time_base = c->time_base;
  start(o, a[5], a[7]);
  AVFrame *f = av_frame_alloc();
  f->width = w; f->height = h; f->format = AV_PIX_FMT_YUV420P;
  av_frame_get_buffer(f, 0);
  AVPacket *p = av_packet_alloc();
  for (int k = 0; k <= n; ++k) {
    if (k < n) {
      av_frame_make_writable(f);
      for (int pl = 0; pl < 3; ++pl) {
        int pw = pl ? (w + 1) / 2 : w, ph = pl ? (h + 1) / 2 : h;
        for (int r = 0; r < ph; ++r)
          if (fread(f->data[pl] + r * f->linesize[pl], 1, pw, stdin) != (size_t)pw) return 32;
      }
      f->pts = k;
      if (avcodec_send_frame(c, f) < 0) return 33;
    } else avcodec_send_frame(c, NULL);
    while (avcodec_receive_packet(c, p) == 0) {
      av_packet_rescale_ts(p, c->time_base, os->time_base);
      p->stream_index = 0;
      if (av_interleaved_write_frame(o, p) < 0) return 34;
    }
  }
  av_write_trailer(o);
  avio_closep(&o->pb);
  return 0;
}

int main(int argc, char **argv) {
  if (argc == 8 && !strcmp(argv[1], "remux")) return remux(argv + 2);
  if (argc == 10 && !strcmp(argv[1], "encode")) return encode(argv + 2);
  return 2;
}
"""


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def build_tool(tmp: str) -> str:
    """Compile AV_TOOL against the system's FFmpeg libraries; its path."""
    src, exe = os.path.join(tmp, "avtool.c"), os.path.join(tmp, "avtool")
    with open(src, "w") as f:
        f.write(AV_TOOL)
    subprocess.run(["gcc", "-O2", src, "-o", exe, "-lavformat", "-lavcodec",
                    "-lavutil"], check=True)
    return exe


DATA = os.path.join("tests", "data")
LIBAV = [  # name, source, muxer, muxer options, audio ms, 30000/1001, pipe
    ("h264_ipb_176x144.mkv", "videos_h264/ipb_main_176x144.mp4", "matroska",
     "", 500, False, False),
    ("h264_cabac_1280x720.mkv", "videos_h264/ipb_cabac_1280x720.mp4",
     "matroska", "", 0, False, False),
    ("h264_ntsc_176x144.mkv", "videos_h264/high_cabac_176x144.mp4",
     "matroska", "", 0, True, False),
    ("xvid_176.mkv", "videos_mpeg4/xvid_176.avi", "matroska", "", 0, False,
     False),
    ("mjpg_112.mkv", "videos_decode/mjpg_112.avi", "matroska", "", 0, False,
     False),
    ("h264_ipb_176x144_live.mkv", "videos_h264/ipb_main_176x144.mp4",
     "matroska", "", 0, False, True),
    ("h264_ipb_176x144_frag.mp4", "videos_h264/ipb_main_176x144.mp4", "mp4",
     "movflags=frag_keyframe+empty_moov", 0, False, False),
    ("h264_ipb_176x144_cmaf.mp4", "videos_h264/ipb_main_176x144.mp4", "mp4",
     "movflags=frag_keyframe+empty_moov+default_base_moof+global_sidx", 0,
     False, False),
    ("h264_ipb_176x144_firstfrag.mp4", "videos_h264/ipb_main_176x144.mp4",
     "mp4", "movflags=frag_keyframe", 0, False, False),
    ("h264_ipb_176x144_live_frag.mp4", "videos_h264/ipb_main_176x144.mp4",
     "mp4", "movflags=frag_keyframe+empty_moov", 0, False, True),
    ("h264_cabac_1280x720_frag.mp4", "videos_h264/ipb_cabac_1280x720.mp4",
     "mp4", "movflags=frag_keyframe+empty_moov", 0, False, False),
    ("xvid_176_frag.mp4", "videos_mpeg4/xvid_176.avi", "mp4",
     "movflags=frag_keyframe+empty_moov", 0, False, False),
]
ENCODED = [  # name, encoder, encoder options, muxer
    ("vp9_176x144.webm", "libvpx-vp9", "deadline=realtime,cpu-used=8",
     "webm"),
    ("av1_176x144.webm", "libaom-av1", "cpu-used=8,usage=realtime", "webm"),
    ("hevc_176x144.mkv", "libx265", "preset=ultrafast", "matroska"),
]
# the codecs the port decodes
DECODED = ("h264", "mpeg4", "mjpeg")


def remux(tool: str, out: str, name: str, source: str, muxer: str,
          opts: str, audio_ms: int, ntsc: bool, pipe: bool) -> dict:
    path = os.path.join(out, name)
    args = [tool, "remux", os.path.join(DATA, source), "-" if pipe else path,
            muxer, opts, str(audio_ms), str(int(ntsc))]
    if pipe:
        with open(path, "wb") as f:
            subprocess.run(args, check=True, stdout=f)
    else:
        subprocess.run(args, check=True, capture_output=True)
    return {"writer": "libavformat 59", "source": source,
            "options": " ".join(x for x in (
                muxer, opts, f"audio +{audio_ms} ms" if audio_ms else "",
                "30000/1001" if ntsc else "", "to a pipe" if pipe else "")
                if x)}


def encode(tool: str, out: str, name: str, encoder: str, opts: str,
           muxer: str, n: int = 12) -> dict:
    sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
    from make_h264_fixtures import x264_source
    raw = b"".join(p.tobytes() for t in range(n)
                   for p in x264_source(len(name), t, 144, 176))
    subprocess.run([tool, "encode", encoder, opts, "176", "144", str(n),
                    os.path.join(out, name), muxer, ""], input=raw,
                   check=True, capture_output=True)
    return {"writer": "libavformat 59", "source": None,
            "options": f"{encoder} {opts}, {n} frames, {muxer}"}


def _source(path: str) -> tuple[dict, list[bytes], bytes]:
    """(the port's packet index, each packet's stored bytes, the MP4's
    avcC or the first chunk's VOL) of a committed stream."""
    from auformer_torch.data import container
    index = container.packet_index(path)
    with open(path, "rb") as f:
        data = []
        for p in index["packets"]:
            f.seek(p.offset)
            data.append(f.read(p.size))
    config = b""
    if index["codec"] == "h264" and path.endswith(".mp4"):
        with open(path, "rb") as f:
            raw = f.read()
        at = raw.index(b"avcC")
        size = int.from_bytes(raw[at - 4:at], "big")
        config = raw[at + 4:at - 4 + size]
    elif index["codec"] == "mpeg4":
        vop = data[0].index(b"\x00\x00\x01\xb6")
        config, data[0] = data[0][:vop], data[0][vop:]
    return index, data, config


def write_own(out: str) -> dict:
    """The files of auformer_torch.data.fixtures (module docstring)."""
    from auformer_torch.data.fixtures import (write_fragmented_mp4,
                                              write_matroska)
    entries = {}
    ipb = "videos_h264/ipb_main_176x144.mp4"
    index, data, avcc = _source(os.path.join(DATA, ipb))
    tb = index["time_base"]
    # ms block times of the presentation times, from the first
    first = min(p.pts for p in index["packets"])
    ms = [round((p.pts - first) * tb * 1000) for p in index["packets"]]
    keys = [p.sync for p in index["packets"]]
    common = dict(codec_private=avcc, default_duration=33333333)
    write_matroska(os.path.join(out, "h264_ipb_176x144_groups.mkv"), data,
                   keys, ms, "V_MPEG4/ISO/AVC", 176, 144, groups=True,
                   audio=True, duration=1000.0, **common)
    entries["h264_ipb_176x144_groups.mkv"] = {
        "writer": "fixtures.write_matroska", "source": ipb,
        "options": "BlockGroups, BlockDuration, ReferenceBlock, PCM track 1"}
    write_matroska(os.path.join(out, "h264_ipb_176x144_unknown.mkv"), data,
                   keys, ms, "V_MPEG4/ISO/AVC", 176, 144, live=True,
                   **common)
    entries["h264_ipb_176x144_unknown.mkv"] = {
        "writer": "fixtures.write_matroska", "source": ipb,
        "options": "Segment and Clusters of unknown size, no Cues"}
    dts = [p.dts for p in index["packets"]]
    cts = [p.pts for p in index["packets"]]
    scale = round(1 / tb)
    write_fragmented_mp4(os.path.join(out, "h264_ipb_176x144_truns.mp4"),
                         data, keys, dts, [c - max(c - d for c, d in zip(
                             cts, dts)) for c in cts], scale, 176, 144, avcc,
                         base="explicit", truns=2, version=1)
    entries["h264_ipb_176x144_truns.mp4"] = {
        "writer": "fixtures.write_fragmented_mp4", "source": ipb,
        "options": "two truns a traf, per-sample flags, version 1, "
                   "explicit base offsets"}
    write_fragmented_mp4(os.path.join(out, "h264_ipb_176x144_moofbase.mp4"),
                         data, keys, dts, cts, scale, 176, 144, avcc,
                         base="moof", truns=1, version=0, sample_flags=False,
                         tfdt=False, edit=min(cts))
    entries["h264_ipb_176x144_moofbase.mp4"] = {
        "writer": "fixtures.write_fragmented_mp4", "source": ipb,
        "options": "default-base-is-moof, first-sample flags, version 0, "
                   "no tfdt, an edit list"}
    mjpg = "videos_decode/mjpg_112.avi"
    index, data, _ = _source(os.path.join(DATA, mjpg))
    ms = [round(k * 1000 / 30) for k in range(len(data))]
    keys = [True] * len(data)
    for name, lacing, lace, groups, encoding in (
            ("mjpg_112_xiph.mkv", "xiph", 3, False, None),
            ("mjpg_112_ebml.mkv", "ebml", 4, True, None),
            ("mjpg_112_fixed.mkv", "fixed", 2, False, None),
            ("mjpg_112_zlib.mkv", None, 1, False, "zlib")):
        write_matroska(os.path.join(out, name), data, keys, ms, "V_MJPEG",
                       112, 112, default_duration=33333333, lacing=lacing,
                       lace=lace, groups=groups, encoding=encoding,
                       duration=400.0)
        entries[name] = {"writer": "fixtures.write_matroska",
                         "source": mjpg, "options": encoding or
                         f"{lacing} lacing, {lace} frames a "
                         f"{'BlockGroup' if groups else 'SimpleBlock'}"}
    xvid = "videos_mpeg4/xvid_176.avi"
    index, data, vol = _source(os.path.join(DATA, xvid))
    n = len(data)
    write_matroska(os.path.join(out, "xvid_176_strip.mkv"), data, [
        p.sync for p in index["packets"]], [400 * k for k in range(n)],
        "V_MPEG4/ISO/ASP", 176, 144, codec_private=vol,
        timestamp_scale=100000, default_duration=40000000,
        strip=b"\x00\x00\x01", duration=400.0 * n)
    entries["xvid_176_strip.mkv"] = {
        "writer": "fixtures.write_matroska", "source": xvid,
        "options": "header stripping 000001, TimestampScale 100000"}
    for name, src, fourcc, w, h, rate in (
            ("xvid_176_vfw.mkv", xvid, b"XVID", 176, 144, 25),
            ("mpeg4_ipb_112x96_vfw.mkv", "videos_mpeg4/ipb_112x96.avi",
             b"FMP4", 112, 96, 30)):
        index, data, vol = _source(os.path.join(DATA, src))
        data[0] = vol + data[0]
        bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc,
                          w * h * 3, 0, 0, 0, 0)
        step = 1000 / rate
        write_matroska(os.path.join(out, name), data, [
            p.sync for p in index["packets"]], [round(k * step) for k in
                                                range(len(data))],
            "V_MS/VFW/FOURCC", w, h, codec_private=bih,
            default_duration=round(1e9 / rate),
            duration=len(data) * step)
        entries[name] = {"writer": "fixtures.write_matroska", "source": src,
                         "options": f"V_MS/VFW/FOURCC {fourcc.decode()}"}
    return entries


def numbers(path: str, seeks: tuple, decoded: bool) -> dict:
    """What the JAX package reads from ``path`` (module docstring)."""
    from auformer.data import ingest
    from auformer.data.video import Video
    entry = {"meta": Video(path, write=False).meta,
             "count_frames": Video(path, write=False).count_frames()}
    with tempfile.TemporaryDirectory() as tmp:
        with open(ingest.extract_timestamps(path, os.path.join(tmp, "t.txt"))
                  ) as f:
            entry["timestamps"] = f.read()
    if decoded:
        entry["frames_sha256"] = [sha(f) for f in
                                  Video(path, write=False).frames()]
        v = Video(path, write=False)
        entry["read_RGB_sha256"] = [
            [k, None if (img := v.read_RGB(k)) is None else sha(img)]
            for k in seeks]
        v.release()
    return entry


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(DATA, "videos_container"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from auformer_torch.data import container
    out = args.out
    if os.path.isdir(out):
        shutil.rmtree(out)
    os.makedirs(out)
    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        tool = build_tool(tmp)
        for name, *rest in LIBAV:
            entries[name] = remux(tool, out, name, *rest)
        for name, *rest in ENCODED:
            entries[name] = encode(tool, out, name, *rest)
    entries.update(write_own(out))
    sources: dict = {}
    for name in sorted(entries):
        path = os.path.join(out, name)
        entry = entries[name]
        codec = container.packet_index(path)["codec"]
        wide = "1280x720" in name
        entry.update(codec=codec, **numbers(path, WIDE_SEEKS if wide
                                            else SEEKS, codec in DECODED))
        source = entry["source"]
        if source and codec in DECODED:
            folder, file = source.split("/")
            if folder not in sources:
                with open(os.path.join(DATA, folder, "expected.json")) as f:
                    sources[folder] = json.load(f)
            assert entry["frames_sha256"] == sources[folder][file][
                "frames_sha256"], f"{name}: not its source's frames"
        print(name, os.path.getsize(path), "bytes", entry["count_frames"],
              "frames")
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(entries, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
