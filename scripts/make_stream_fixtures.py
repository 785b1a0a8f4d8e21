"""Write the MPEG program and transport stream and ASF fixtures of
tests/data/videos_container/ and add what the JAX package reads from them
to its expected.json (the schema of scripts/make_container_fixtures.py,
whose files this script leaves as they are).

Needs ``gcc`` and the system's FFmpeg libraries with their headers
(libavformat 59's ``mpegts``, ``mpeg``, ``vob`` and ``asf`` muxers;
libavcodec 59's ``mpeg1video``, ``mpeg2video``, ``wmv2``, ``mp2`` and
``wmav2`` encoders), through which ``AV_TOOL`` remuxes streams already
committed (without re-encoding them) and encodes the codecs the port does
not decode; cv2 with its FFMPEG backend and the JAX package, which read
each file for its numbers. Neither the port nor a test runs this script.
Run from the root of the repository:

    JAX_PLATFORMS=cpu python scripts/make_stream_fixtures.py \\
        [--out tests/data/videos_container]

Remuxed by libavformat 59 (``AV_TOOL remux``: the source's packets with
their times renumbered in frames of its rate from 0, H.264 as Annex B):
  h264_ipb_176x144_mp2.ts     videos_h264/ipb_main_176x144.mp4 (B-pyramid)
                              with an MP2 track that runs 0.5 s past the
                              video: cv2's count comes from it (48)
  h264_ipb_176x144_bdav.m2ts  the same in 192-byte packets, no audio
  h264_cabac_1280x720_avchd.m2ts
                              videos_h264/ipb_cabac_1280x720.mp4 as AVCHD
                              camcorders write 720p (one GOP: cv2 finds no
                              key frame after any seek, every read is None)
  xvid_176_ts.ts              videos_mpeg4/xvid_176.avi, stream type 0x10
  h264_ipb_176x144_ps.mpg     the ``mpeg`` muxer: 2 KiB packs, so that
                              some units share a PES and take no PTS
  h264_ipb_176x144_vob.mpg    the ``vob`` muxer
  xvid_176_ps.mpg             the ``mpeg`` muxer
  xvid_176_asf.wmv            ASF, fourcc M4S2, the VOL in the
                              BITMAPINFOHEADER and in band
Encoded by AV_TOOL (30 frames of make_h264_fixtures' x264_source at
176x144; meta only, the port decodes none of them):
  mpeg1_176x144.mpg           mpeg1video at 25 fps with MP2, an MPEG-1
                              system stream
  mpeg2_176x144_ntsc.mpg      mpeg2video at 30000/1001, the ``vob`` muxer
  mpeg2_176x144.ts            mpeg2video at 25 fps
  wmv2_176x144.wmv            WMV2 at 25 fps with WMA (wmav2) audio
Written by auformer_torch.data.fixtures (what libavformat does not write):
  h264_ipb_176x144_wrap.m2ts  write_mpegts: ipb_main_176x144.mp4's units
                              whose PTS start 0.5 s before 2^33 and wrap
                              in mid stream, M2TS packets
  h264_ipb_176x144_pes.ts     PES packets not on unit boundaries: two units
                              in one PES, a unit over two PES, adaptation-
                              field stuffing and PCRs
  xvid_176_pes.ts             xvid_176.avi the same way (units without a
                              PTS take the last one's plus a frame)
  xvid_176_multi.wmv          write_asf: several payloads in a packet,
                              objects split over packets of 700 bytes
  xvid_176_noindex.wmv        no Simple Index Object
  xvid_176_broadcast.wmv      the broadcast flag: no play duration, so cv2
                              knows no count and does not seek

Every file's name has a stem of its own (``postprocess`` keys its frame
counts by stem). Each entry has its ``writer``, ``source``, ``options``
and ``codec``, and the JAX package's ``meta``, ``count_frames``, ``extract_timestamps`` text
and, for the codecs the port decodes, the frames' and reads' SHA-256s
(make_container_fixtures.numbers). A remux's frames are asserted equal to
its source's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from make_container_fixtures import (DATA, DECODED, SEEKS,  # noqa: E402
                                     WIDE_SEEKS, numbers)

AV_TOOL = r"""#include <libavformat/avformat.h>
#include <libavcodec/avcodec.h>
#include <libavcodec/bsf.h>
#include <libavutil/opt.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

static AVFormatContext *open_out(const char *path, const char *fmt) {
  AVFormatContext *o = NULL;
  if (avformat_alloc_output_context2(&o, NULL, fmt, path) < 0) exit(10);
  return o;
}

static void start(AVFormatContext *o, const char *path, const char *opts) {
  AVDictionary *d = NULL;
  if (*opts) av_dict_parse_string(&d, opts, "=", ",", 0);
  if (avio_open(&o->pb, path, AVIO_FLAG_WRITE) < 0) exit(11);
  if (avformat_write_header(o, &d) < 0) exit(12);
  if (av_dict_count(d)) { fprintf(stderr, "unused muxer option\n"); exit(13); }
  av_dict_free(&d);
}

/* an audio track of a tone: its encoder context and stream */
static AVCodecContext *audio_open(AVFormatContext *o, const char *name,
                                  AVStream **st) {
  const AVCodec *codec = avcodec_find_encoder_by_name(name);
  if (!codec) exit(40);
  AVCodecContext *c = avcodec_alloc_context3(codec);
  c->sample_rate = 44100;
  if (!strcmp(name, "mp2")) c->sample_rate = 48000;
  c->sample_fmt = codec->sample_fmts[0];
  av_channel_layout_default(&c->ch_layout, 1);
  c->bit_rate = 64000;
  c->time_base = (AVRational){1, c->sample_rate};
  if (o->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(c, codec, NULL) < 0) exit(41);
  *st = avformat_new_stream(o, NULL);
  avcodec_parameters_from_context((*st)->codecpar, c);
  (*st)->time_base = c->time_base;
  return c;
}

/* the audio packets of a tone of SECONDS */
static AVPacket **audio_packets(AVCodecContext *c, double seconds, int *n) {
  AVPacket **out = NULL; *n = 0;
  AVFrame *f = av_frame_alloc();
  f->nb_samples = c->frame_size ? c->frame_size : 1024;
  f->format = c->sample_fmt; f->sample_rate = c->sample_rate;
  av_channel_layout_copy(&f->ch_layout, &c->ch_layout);
  av_frame_get_buffer(f, 0);
  int64_t total = (int64_t)(seconds * c->sample_rate), at = 0;
  AVPacket *p = av_packet_alloc();
  for (int done = 0; !done;) {
    if (at < total) {
      av_frame_make_writable(f);
      for (int s = 0; s < f->nb_samples; ++s) {
        double v = 0.2 * sin(2 * M_PI * 440.0 * (at + s) / c->sample_rate);
        if (c->sample_fmt == AV_SAMPLE_FMT_S16)
          ((int16_t *)f->data[0])[s] = (int16_t)(v * 32767);
        else ((float *)f->data[0])[s] = (float)v;
      }
      f->pts = at; at += f->nb_samples;
      if (avcodec_send_frame(c, f) < 0) exit(42);
    } else { avcodec_send_frame(c, NULL); done = 1; }
    while (avcodec_receive_packet(c, p) == 0) {
      out = realloc(out, sizeof(*out) * (*n + 1));
      out[(*n)++] = av_packet_clone(p);
      av_packet_unref(p);
    }
  }
  av_frame_free(&f);
  av_packet_free(&p);
  return out;
}

/* write the video packets VP (in their stream's time base) and the audio
   packets AP (in the encoder's) interleaved by decode time */
static int write_all(AVFormatContext *o, AVStream *vs, AVPacket **vp, int nv,
                     AVRational vtb, AVStream *as, AVPacket **ap, int na,
                     AVRational atb) {
  int i = 0, j = 0;
  while (i < nv || j < na) {
    int video = j >= na || (i < nv &&
        av_compare_ts(vp[i]->dts, vtb, ap[j]->dts, atb) <= 0);
    AVPacket *q = video ? vp[i++] : ap[j++];
    av_packet_rescale_ts(q, video ? vtb : atb, video ? vs->time_base
                                                     : as->time_base);
    q->stream_index = video ? vs->index : as->index;
    q->pos = -1;
    if (av_interleaved_write_frame(o, q) < 0) return 26;
    av_packet_free(&q);
  }
  av_write_trailer(o);
  avio_closep(&o->pb);
  return 0;
}

/* remux IN OUT FORMAT OPTS AUDIO AUDIO_EXTRA_MS: the video's packets,
   renumbered in frames of its rate, and a tone through the encoder AUDIO
   ("-": none) that runs AUDIO_EXTRA_MS past the video */
static int remux(char **a) {
  const char *in = a[0], *out = a[1], *fmt = a[2], *opts = a[3];
  int extra = atoi(a[5]);
  AVFormatContext *ic = NULL;
  if (avformat_open_input(&ic, in, NULL, NULL) < 0) return 20;
  if (avformat_find_stream_info(ic, NULL) < 0) return 21;
  int vi = av_find_best_stream(ic, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
  if (vi < 0) return 22;
  AVStream *is = ic->streams[vi];
  AVFormatContext *o = open_out(out, fmt);
  AVStream *os = avformat_new_stream(o, NULL);
  avcodec_parameters_copy(os->codecpar, is->codecpar);
  os->codecpar->codec_tag = 0;
  AVRational rate = is->avg_frame_rate, src = av_inv_q(rate);
  os->avg_frame_rate = rate;
  os->time_base = src;
  AVBSFContext *annexb = NULL;
  if (is->codecpar->codec_id == AV_CODEC_ID_H264 &&
      is->codecpar->extradata_size && is->codecpar->extradata[0] == 1 &&
      strcmp(fmt, "asf")) {
    /* Annex B for the MPEG muxers, as ffmpeg's h264_mp4toannexb writes it */
    av_bsf_alloc(av_bsf_get_by_name("h264_mp4toannexb"), &annexb);
    avcodec_parameters_copy(annexb->par_in, is->codecpar);
    annexb->time_base_in = is->time_base;
    if (av_bsf_init(annexb) < 0) return 24;
    avcodec_parameters_copy(os->codecpar, annexb->par_out);
    os->codecpar->codec_tag = 0;
  }
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
  AVStream *as = NULL;
  AVCodecContext *ac = strcmp(a[4], "-") ? audio_open(o, a[4], &as) : NULL;
  start(o, out, opts);
  AVPacket *p = av_packet_alloc();
  AVPacket **vp = NULL; int nv = 0;
  AVRational ist = is->time_base;
  int64_t total = 0, first = INT64_MAX;
  while (av_read_frame(ic, p) >= 0) {
    if (p->stream_index != vi) { av_packet_unref(p); continue; }
    if (annexb) {
      if (av_bsf_send_packet(annexb, p) < 0) return 25;
      if (av_bsf_receive_packet(annexb, p) < 0) return 25;
    }
    /* to frames of the source's rate */
    int64_t pts = p->pts == AV_NOPTS_VALUE ? p->dts : p->pts;
    int64_t fp = av_rescale_q_rnd(pts, ist, src, AV_ROUND_NEAR_INF);
    int64_t fd = p->dts == AV_NOPTS_VALUE ? fp :
        av_rescale_q_rnd(p->dts, ist, src, AV_ROUND_NEAR_INF);
    if (fp + 1 > total) total = fp + 1;
    if (fd < first) first = fd;
    p->pts = fp; p->dts = fd; p->duration = 1;
    vp = realloc(vp, sizeof(*vp) * (nv + 1));
    vp[nv++] = av_packet_clone(p);
    av_packet_unref(p);
  }
  /* every time from 0 */
  for (int k = 0; k < nv; ++k) { vp[k]->pts -= first; vp[k]->dts -= first; }
  total -= first;
  int na = 0;
  AVPacket **ap = ac ? audio_packets(ac, av_q2d(src) * total + extra / 1000.0,
                                     &na) : NULL;
  return write_all(o, os, vp, nv, src, as, ap, na,
                   ac ? ac->time_base : (AVRational){1, 1});
}

/* encode ENCODER ENC_OPTS W H N RATE_NUM RATE_DEN OUT FORMAT MUX_OPTS AUDIO:
   yuv420p frames on stdin */
static int encode(char **a) {
  const AVCodec *codec = avcodec_find_encoder_by_name(a[0]);
  if (!codec) return 30;
  int w = atoi(a[2]), h = atoi(a[3]), n = atoi(a[4]);
  AVRational rate = {atoi(a[5]), atoi(a[6])};
  AVFormatContext *o = open_out(a[7], a[8]);
  AVCodecContext *c = avcodec_alloc_context3(codec);
  c->width = w; c->height = h; c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->time_base = av_inv_q(rate); c->framerate = rate;
  c->gop_size = 12; c->thread_count = 1;
  if (!strncmp(a[0], "mpeg", 4)) c->max_b_frames = 2;
  c->bit_rate = 400000;
  if (o->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  AVDictionary *d = NULL;
  if (*a[1]) av_dict_parse_string(&d, a[1], "=", ",", 0);
  if (avcodec_open2(c, codec, &d) < 0) return 31;
  AVStream *os = avformat_new_stream(o, NULL);
  avcodec_parameters_from_context(os->codecpar, c);
  os->avg_frame_rate = c->framerate;
  os->time_base = c->time_base;
  AVStream *as = NULL;
  AVCodecContext *ac = strcmp(a[10], "-") ? audio_open(o, a[10], &as) : NULL;
  start(o, a[7], a[9]);
  AVFrame *f = av_frame_alloc();
  f->width = w; f->height = h; f->format = AV_PIX_FMT_YUV420P;
  av_frame_get_buffer(f, 0);
  AVPacket *p = av_packet_alloc();
  AVPacket **vp = NULL; int nv = 0;
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
      vp = realloc(vp, sizeof(*vp) * (nv + 1));
      vp[nv++] = av_packet_clone(p);
      av_packet_unref(p);
    }
  }
  int na = 0;
  AVPacket **ap = ac ? audio_packets(ac, av_q2d(c->time_base) * n, &na) : NULL;
  return write_all(o, os, vp, nv, c->time_base, as, ap, na,
                   ac ? ac->time_base : (AVRational){1, 1});
}

int main(int argc, char **argv) {
  if (argc == 8 && !strcmp(argv[1], "remux")) return remux(argv + 2);
  if (argc == 13 && !strcmp(argv[1], "encode")) return encode(argv + 2);
  return 2;
}
"""

REMUX = [  # name, source, muxer, muxer options, audio encoder, audio ms
    ("h264_ipb_176x144_mp2.ts", "videos_h264/ipb_main_176x144.mp4", "mpegts",
     "", "mp2", 500),
    ("h264_ipb_176x144_bdav.m2ts", "videos_h264/ipb_main_176x144.mp4", "mpegts",
     "mpegts_m2ts_mode=1", "-", 0),
    ("h264_cabac_1280x720_avchd.m2ts", "videos_h264/ipb_cabac_1280x720.mp4",
     "mpegts", "mpegts_m2ts_mode=1", "-", 0),
    ("xvid_176_ts.ts", "videos_mpeg4/xvid_176.avi", "mpegts", "", "-", 0),
    ("h264_ipb_176x144_ps.mpg", "videos_h264/ipb_main_176x144.mp4", "mpeg", "",
     "-", 0),
    ("h264_ipb_176x144_vob.mpg", "videos_h264/ipb_main_176x144.mp4", "vob",
     "", "-", 0),
    ("xvid_176_ps.mpg", "videos_mpeg4/xvid_176.avi", "mpeg", "", "-", 0),
    ("xvid_176_asf.wmv", "videos_mpeg4/xvid_176.avi", "asf", "", "-", 0),
]
ENCODE = [  # name, encoder, rate, muxer, audio encoder
    ("mpeg1_176x144.mpg", "mpeg1video", (25, 1), "mpeg", "mp2"),
    ("mpeg2_176x144_ntsc.mpg", "mpeg2video", (30000, 1001), "vob", "-"),
    ("mpeg2_176x144.ts", "mpeg2video", (25, 1), "mpegts", "-"),
    ("wmv2_176x144.wmv", "wmv2", (25, 1), "asf", "wmav2"),
]


def build_tool(tmp: str) -> str:
    src, exe = os.path.join(tmp, "avtool.c"), os.path.join(tmp, "avtool")
    with open(src, "w") as f:
        f.write(AV_TOOL)
    subprocess.run(["gcc", "-O2", src, "-o", exe, "-lavformat", "-lavcodec",
                    "-lavutil", "-lm"], check=True)
    return exe


def remux(tool: str, out: str, name: str, source: str, muxer: str,
          opts: str, audio: str, audio_ms: int) -> dict:
    subprocess.run([tool, "remux", os.path.join(DATA, source),
                    os.path.join(out, name), muxer, opts, audio,
                    str(audio_ms)], check=True, capture_output=True)
    return {"writer": "libavformat 59", "source": source,
            "options": " ".join(x for x in (
                muxer, opts, f"{audio} +{audio_ms} ms" if audio_ms else (
                    audio if audio != "-" else "")) if x)}


def encode(tool: str, out: str, name: str, encoder: str, rate: tuple,
           muxer: str, audio: str, n: int = 30) -> dict:
    from make_h264_fixtures import x264_source
    raw = b"".join(p.tobytes() for t in range(n)
                   for p in x264_source(len(name), t, 144, 176))
    subprocess.run([tool, "encode", encoder, "", "176", "144", str(n),
                    str(rate[0]), str(rate[1]), os.path.join(out, name),
                    muxer, "", audio], input=raw, check=True,
                   capture_output=True)
    return {"writer": "libavformat 59", "source": None,
            "options": f"{encoder} {rate[0]}/{rate[1]}, {n} frames, {muxer}"
                       + (f", {audio}" if audio != "-" else "")}


def _units(path: str) -> tuple[dict, list[bytes]]:
    from auformer_torch.data import container
    index = container.packet_index(path)
    return index, [u for _, u in container.access_units(path, index)]


def write_own(out: str) -> dict:
    """The files of auformer_torch.data.fixtures (module docstring)."""
    from auformer_torch.data import asf
    from auformer_torch.data.fixtures import write_asf, write_mpegts
    from auformer_torch.data.mpegstream import read_es
    entries = {}
    ipb = "videos_h264/ipb_main_176x144.mp4"
    index, units = _units(os.path.join(DATA, ipb))
    scale = round(1 / index["time_base"])

    def times(base: int):
        pts = [base + p.pts * 90000 // scale for p in index["packets"]]
        dts = [base + p.dts * 90000 // scale for p in index["packets"]]
        return pts, [None if d == t else d for d, t in zip(dts, pts)]

    pts, dts = times((1 << 33) - 45000)
    write_mpegts(os.path.join(out, "h264_ipb_176x144_wrap.m2ts"), units,
                 pts, dts, m2ts=True)
    entries["h264_ipb_176x144_wrap.m2ts"] = {
        "writer": "fixtures.write_mpegts", "source": ipb,
        "options": "M2TS, PTS from 2^33 - 0.5 s, wrapping"}
    starts = [0]
    for u in units[:-1]:
        starts.append(starts[-1] + len(u))
    # units 2, 6, 10, ... share the PES of the unit before; units 4, 9,
    # 14, ... run over two
    splits = [s for k, s in enumerate(starts) if k % 4 != 2] + [
        starts[k] + len(units[k]) // 2 for k in range(len(units))
        if k % 5 == 4]
    pts, dts = times(900000)
    write_mpegts(os.path.join(out, "h264_ipb_176x144_pes.ts"), units, pts,
                 dts, splits=sorted(splits))
    entries["h264_ipb_176x144_pes.ts"] = {
        "writer": "fixtures.write_mpegts", "source": ipb,
        "options": "two units in a PES, a unit over two, stuffing, PCR"}
    xvid = "videos_mpeg4/xvid_176.avi"
    index, units = _units(os.path.join(DATA, xvid))
    starts = [0]
    for u in units[:-1]:
        starts.append(starts[-1] + len(u))
    write_mpegts(os.path.join(out, "xvid_176_pes.ts"), units,
                 [90000 + 3600 * k for k in range(len(units))],
                 [None] * len(units), stream_type=0x10,
                 splits=[s for k, s in enumerate(starts) if k % 3 != 1])
    entries["xvid_176_pes.ts"] = {
        "writer": "fixtures.write_mpegts", "source": xvid,
        "options": "stream type 0x10, every third unit in the PES before"}
    wmv = os.path.join(out, "xvid_176_asf.wmv")
    with open(wmv, "rb") as f:
        h = asf.read(f, wmv)
        objects = [read_es(f, h["chunks"], o.start, o.start + o.size)
                   for o in h["objects"]]
    keys = [o.key for o in h["objects"]]
    ms = [40 * k for k in range(len(objects))]
    for name, kw, what in (
            ("xvid_176_multi.wmv", dict(multiple=True, packet_size=700),
             "multiple payloads, objects over 700-byte packets"),
            ("xvid_176_noindex.wmv", dict(index=False), "no Simple Index"),
            ("xvid_176_broadcast.wmv", dict(broadcast=True),
             "the broadcast flag")):
        write_asf(os.path.join(out, name), objects, keys, ms, b"M4S2", 176,
                  144, extradata=h["extradata"], **kw)
        entries[name] = {"writer": "fixtures.write_asf", "source": xvid,
                         "options": what}
    return entries


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(DATA, "videos_container"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from auformer_torch.data import container
    out = args.out
    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        tool = build_tool(tmp)
        for name, *rest in REMUX:
            entries[name] = remux(tool, out, name, *rest)
        for name, *rest in ENCODE:
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
    with open(os.path.join(out, "expected.json")) as f:
        expected = json.load(f)
    expected.update(entries)
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
