"""MPEG transport streams (.ts, .m2ts, .mts) and program streams (.mpg,
.mpeg, .vob) read without a demuxer library: the first video stream's
meta, access units and their times, as ffmpeg's ``mpegts`` and ``mpeg``
demuxers, its parsers and ``avformat_find_stream_info`` give them to cv2
(the JAX package reads these files through cv2's FFMPEG backend,
auformer/data/video.py). The rules follow cv2 5.0's FFmpeg (libavformat
62); each was held against cv2 on files libavformat 59 muxes and on the
tests' writer's (tests/test_torch_video_mpegts.py).

Transport stream: the packet size (188, or 192 with the 4-byte
TP_extra_header of ``.m2ts``) from the first sync bytes; the PAT, the first
program's PMT and in it the first video elementary stream (ffmpeg makes the
streams in PMT order). Stream types 0x1B H.264, 0x10 MPEG-4 part 2,
0x01/0x02 MPEG-1/2 video and 0x24 HEVC are named; another is named by its
number. Packet headers are read with numpy over the file (PIDs,
payload_unit_start, adaptation lengths), so that an hour of 720p (about 7
GB) is indexed at disk speed; a PES runs from one payload_unit_start to the
next on its PID, whatever its PES_packet_length says. Program stream: pack
headers of MPEG-1 and MPEG-2 (with stuffing), the system header, the PSM
(its stream types name the codec), PES headers of both syntaxes;
private_stream_1/2 and padding are stepped over; the video stream is the
first of ids 0xE0-0xEF, its codec probed from its first bytes as ffmpeg's
``request_probe`` does (a sequence header: MPEG-1/2 video, with a
sequence_extension MPEG-2; an SPS: H.264; a VOS, VO or VOL: MPEG-4 part 2).

Times: PTS and DTS are 33-bit, unwrapped as ffmpeg's ``wrap_timestamp``
does from the first timestamp of the file (a stream that starts within 60
s of 2^33 counts down past the wrap, any other counts up). The time base
is 1/90000 s.

Access units: the elementary stream is cut where ffmpeg's parser cuts it
(``h264_parser``: an SEI, SPS, PPS or AUD after a slice, or a slice whose
first_mb_in_slice is not above the last one's; ``mpeg4video_parser``: the
first start code after a VOP's), and each unit takes the PTS and DTS that
``av_parser_parse2``'s ``ff_fetch_timestamp`` gives it from the PES
packets it was fed, emulated with ffmpeg's four-slot ring (a unit that
begins in a PES whose timestamp went to the unit before gets none). An
MPEG-4 part 2 unit without a PTS in a low-delay stream takes the previous
one's plus a frame (``compute_pkt_fields``); in another, it raises naming
A9.

Meta as cv2 reads it: ``fps`` is ``avg_frame_rate``, which
``avformat_find_stream_info`` sets from the probed frames' durations (the
codec's frame rate: the SPS's VUI timing, the VOL's time increment
resolution and fixed increment, the sequence header's frame_rate_code),
rounded to a standard rate within 1 % (HEVC and the other codecs, whose
rate the port does not read, raise naming A9); ``num_frames`` is
floor(duration x fps + 0.5) with the duration of
``estimate_timings_from_pts``: for every audio and video stream the
largest PTS of a PES in the file's last 250,000 bytes (read again further
back while an audio or video stream has none, at most six times), plus
that packet's duration (a video frame at the rate, an audio frame of its
codec), less the stream's first PTS; the file's duration the longest of
them, or from the earliest start to the latest end where that is longer.
``meta`` reads the head (ffmpeg's probe size, 5 MB, of a transport
stream; of a program stream as far as every stream has its first PTS) and
those tail windows only.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from . import bitstream

_A9 = "ROADMAP.md queue A9 (offline ingest from videos)"
_PROBE = 5_000_000            # ffmpeg's probesize
_TAIL = 250_000               # DURATION_MAX_READ_SIZE
_TAIL_RETRIES = 6             # DURATION_MAX_RETRY
_WRAP = 1 << 33
_HZ = 90000

# PMT stream types: the codecs the port names, the other video and the
# audio types ffmpeg knows
VIDEO_TYPES = {0x01: "mpeg1video", 0x02: "mpeg2video", 0x10: "mpeg4",
               0x1B: "h264", 0x24: "hevc", 0x42: "cavs", 0xD1: "dirac",
               0xEA: "vc1", 0x33: "vvc"}
AUDIO_TYPES = {0x03: "mp2", 0x04: "mp2", 0x0F: "aac", 0x11: "aac_latm",
               0x81: "ac3", 0x87: "eac3", 0x82: "dts", 0x80: "pcm_bluray"}


def _unsupported(path: str, what: str):
    return NotImplementedError(f"{path}: {what} is not read; {_A9} lists "
                               "it")


class Pes(NamedTuple):
    """One PES packet of a stream: the file offset of the TS packet or PES
    header where it starts, its PTS and DTS (None where absent) and the
    offsets of its payload in the stream's elementary stream."""
    pos: int
    pts: int | None
    dts: int | None
    start: int
    size: int


def _ts_value(b: bytes, at: int) -> int:
    """A 33-bit PTS or DTS of a PES header."""
    return (((b[at] >> 1) & 7) << 30 | b[at + 1] << 22
            | (b[at + 2] >> 1) << 15 | b[at + 3] << 7 | b[at + 4] >> 1)


def _pes_header(b: bytes) -> tuple[int, int | None, int | None]:
    """(header length, PTS, DTS) of a PES packet's header, MPEG-2 syntax or
    MPEG-1 (stuffing, STD buffer, PTS/DTS), from its 00 00 01 prefix."""
    if len(b) >= 9 and b[6] & 0xC0 == 0x80:
        flags, n = b[7], b[8]
        pts = dts = None
        if flags & 0x80 and len(b) >= 14:
            pts = _ts_value(b, 9)
            if flags & 0x40 and len(b) >= 19:
                dts = _ts_value(b, 14)
        return 9 + n, pts, dts
    at = 6
    while at < len(b) and b[at] == 0xFF and at < 6 + 16:
        at += 1
    if at < len(b) and b[at] & 0xC0 == 0x40:
        at += 2
    if at >= len(b):
        return at, None, None
    kind = b[at] >> 4
    if kind == 2 and len(b) >= at + 5:
        return at + 5, _ts_value(b, at), None
    if kind == 3 and len(b) >= at + 10:
        return at + 10, _ts_value(b, at), _ts_value(b, at + 5)
    return at + 1, None, None


# -- elementary stream headers ------------------------------------------------

def _starts(es: bytes) -> list[int]:
    """Offsets of the bytes after each 00 00 01 start code prefix."""
    out, at = [], es.find(b"\x00\x00\x01")
    while at >= 0:
        out.append(at + 3)
        at = es.find(b"\x00\x00\x01", at + 3)
    return out


def _h264_head(es: bytes) -> dict | None:
    for s in _starts(es):
        if s < len(es) and es[s] & 0x1F == 7:
            nxt = es.find(b"\x00\x00\x01", s)
            sps = bitstream.parse_sps(es[s:nxt if nxt >= 0 else len(es)])
            rate = None
            if sps.get("timing"):
                units, scale = sps["timing"]
                rate = _reduce(scale, 2 * units, 1 << 30) if units else None
            return {"codec": "h264", "width": sps["width"],
                    "height": sps["height"], "rate": rate, "fields": 2,
                    "low_delay": None}
    return None


def _log2(v: int) -> int:
    return max(v, 1).bit_length() - 1


def mpeg4_head(es: bytes) -> dict | None:
    """Width, height and rate of the first VOL (ISO/IEC 14496-2 6.2.3)."""
    for s in _starts(es):
        if s < len(es) and 0x20 <= es[s] <= 0x2F:
            r = bitstream.BitReader(es[s + 1:s + 64])
            r.u(1)
            r.u(8)
            verid = 1
            if r.u(1):
                verid = r.u(4)
                r.u(3)
            if r.u(4) == 15:
                r.u(16)
            low_delay = None
            if r.u(1):
                r.u(2)
                low_delay = r.u(1)
                if r.u(1):
                    r.u(79)
            shape = r.u(2)
            if shape == 3 and verid != 1:
                r.u(4)
            r.u(1)
            res = r.u(16)
            if not res:
                raise ValueError("an MPEG-4 VOL with a time increment "
                                 "resolution of 0")
            r.u(1)
            den = 1
            if r.u(1):
                den = r.u(max(_log2(res - 1) + 1, 1))
            width = height = 0
            if shape == 0:
                r.u(1)
                width = r.u(13)
                r.u(1)
                height = r.u(13)
            return {"codec": "mpeg4", "width": width, "height": height,
                    "rate": (res, den) if den else None, "fields": 0,
                    "low_delay": low_delay}
    return None


_MPEG12_RATES = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001),
                 5: (30, 1), 6: (50, 1), 7: (60000, 1001), 8: (60, 1)}


def _mpeg12_head(es: bytes) -> dict | None:
    starts = _starts(es)
    for i, s in enumerate(starts):
        if s + 7 < len(es) and es[s] == 0xB3:
            width = es[s + 1] << 4 | es[s + 2] >> 4
            height = (es[s + 2] & 15) << 8 | es[s + 3]
            rate = _MPEG12_RATES.get(es[s + 4] & 15)
            codec, fields = "mpeg1video", 0
            for t in starts[i + 1:i + 4]:
                if t + 6 < len(es) and es[t] == 0xB5 and es[t + 1] >> 4 == 1:
                    codec, fields = "mpeg2video", 2
                    width |= ((es[t + 2] & 1) << 1 | es[t + 3] >> 7) << 12
                    height |= (es[t + 3] >> 5 & 3) << 12
                    n, d = es[t + 5] >> 5 & 3, es[t + 5] & 31
                    if rate:
                        rate = (rate[0] * (n + 1), rate[1] * (d + 1))
            return {"codec": codec, "width": width, "height": height,
                    "rate": rate, "fields": fields, "low_delay": None}
    return None


def _hevc_head(es: bytes) -> dict | None:
    for s in _starts(es):
        if s + 1 < len(es) and (es[s] >> 1) & 0x3F == 33:
            return {"codec": "hevc", "width": 0, "height": 0, "rate": None,
                    "fields": 0, "low_delay": None}
    return None


_HEADS = {"h264": _h264_head, "mpeg4": mpeg4_head,
          "mpeg1video": _mpeg12_head, "mpeg2video": _mpeg12_head,
          "hevc": _hevc_head}


def probe_codec(es: bytes) -> dict | None:
    """The codec of a program stream's video, from its first bytes, as
    ffmpeg's ``request_probe`` finds it (module docstring): a VOP start
    code (0xB6) is MPEG-4 part 2's alone, a sequence header (0xB3) without
    one MPEG-1/2 video's (MPEG-4 uses 0xB3 for a GOV), and an H.264 NAL
    header is below 0x80."""
    codes = {es[s] for s in _starts(es) if s < len(es)}
    if 0xB6 in codes:
        return mpeg4_head(es)
    if 0xB3 in codes:
        return _mpeg12_head(es)
    if any(c < 0x80 and c & 0x1F == 7 for c in codes):
        return _h264_head(es)
    return None


# -- rates --------------------------------------------------------------------

def _reduce(num: int, den: int, limit: int) -> tuple[int, int]:
    from .container import _av_reduce
    return _av_reduce(num, den, limit)


def _std_rates():
    """ffmpeg's get_std_framerate(i) for every i, over 12 x 1001."""
    for i in range(30 * 12):
        yield (i + 1) * 1001
    for i in range(30):
        yield (i + 31) * 1001 * 12
    for r in (80, 120, 240):
        yield r * 1001 * 12
    for r in (24, 30, 60, 12, 15, 48):
        yield r * 1000 * 12


def frame_ticks(rate: tuple[int, int] | None, fields: int,
                hz: int = _HZ) -> int:
    """A frame's duration in 1/``hz`` s as ``ff_compute_frame_duration``
    gives it from the codec's frame rate (num, den), rounded down; 0
    where it gives none."""
    if not rate or not rate[0] or rate[1] * 1000 <= rate[0]:
        return 0
    num, den = rate[1], rate[0]
    if fields:             # a field's duration, two of them a frame
        num, den = _reduce(num, den * 2, 1 << 31)
        num, den = _reduce(num * 2, den, 1 << 31)
    return num * hz // den


def avg_frame_rate(ticks: int, hz: int = _HZ) -> tuple[int, int] | None:
    """``avg_frame_rate`` from probed frames of ``ticks`` of 1/``hz`` s
    each: their rate, rounded to a standard one within 1 %."""
    if not ticks:
        return None
    num, den = _reduce(hz, ticks, 60000)
    best, best_error = 0, 0.01
    for std in _std_rates():
        error = abs(num / den / (std / (12 * 1001)) - 1)
        if error < best_error:
            best, best_error = std, error
    if best:
        num, den = _reduce(best, 12 * 1001, (1 << 31) - 1)
    return num, den


def _rescale(a: int, b: int, c: int) -> int:
    """av_rescale: a * b / c, rounded half away from zero."""
    r = (abs(a) * b + c // 2) // c
    return r if a >= 0 else -r


# -- transport stream ---------------------------------------------------------

class _TsLayout(NamedTuple):
    first: int          # file offset of the first packet
    size: int           # 188 or 192
    head: int           # bytes before the sync byte (4 for .m2ts)


def _ts_layout(head: bytes) -> _TsLayout | None:
    for size, pre in ((188, 0), (192, 4)):
        for first in range(min(size, len(head))):
            at = first + pre
            if all(at + k * size < len(head) and head[at + k * size] == 0x47
                   for k in range(3)) and len(head) >= at + 2 * size + 1:
                return _TsLayout(first, size, pre)
    return None


def is_ts(head: bytes) -> bool:
    return _ts_layout(head) is not None


def _ts_headers(buf: np.ndarray, base: int, lay: _TsLayout, path: str):
    """(file offsets of the packets, PIDs, payload_unit_start, payload
    offsets in the packet, payload lengths) of the packets in ``buf``,
    which starts at a packet of the file at ``base``; a packet cut by the
    end of ``buf`` is left out. A packet without its sync byte raises
    ValueError (a packet cut short within the file)."""
    n = len(buf) // lay.size
    pk = buf[:n * lay.size].reshape(n, lay.size)[:, lay.head:lay.head + 188]
    bad = np.flatnonzero(pk[:, 0] != 0x47)
    if bad.size:
        raise ValueError(f"{path}: the transport stream loses its sync at "
                         f"{base + int(bad[0]) * lay.size} (a packet cut "
                         "short)")
    b1, b3 = pk[:, 1].astype(np.int64), pk[:, 3]
    pid = (b1 & 0x1F) << 8 | pk[:, 2]
    pusi = (b1 & 0x40) != 0
    afc = (b3 >> 4) & 3
    poff = 4 + np.where(afc & 2, pk[:, 4].astype(np.int64) + 1, 0)
    has = ((afc & 1) != 0) & (poff < 188)
    plen = np.where(has, 188 - poff, 0)
    offs = base + np.arange(n, dtype=np.int64) * lay.size + lay.head
    return offs, pid, pusi, np.minimum(poff, 188), plen


def _section(f, offs, pid, pusi, poff, plen, want: int) -> bytes | None:
    """The first whole PSI section on PID ``want`` of the packets."""
    at = np.flatnonzero((pid == want) & pusi & (plen > 0))
    if not at.size:
        return None
    rows = np.flatnonzero((pid == want) & (plen > 0))
    rows = rows[rows >= at[0]]
    data = b""
    for r in rows:
        f.seek(int(offs[r] + poff[r]))
        data += f.read(int(plen[r]))
        if len(data) >= 4:
            start = 1 + data[0]
            if len(data) >= start + 3:
                n = ((data[start + 1] & 15) << 8 | data[start + 2]) + 3
                if len(data) >= start + n:
                    return data[start:start + n]
    return None


def _ts_program(f, heads, path: str) -> tuple[list[tuple[int, int]], int]:
    """([(PID, stream type)] of the first program's PMT in its order, the
    PMT's PID); ValueError without a PAT, PMT or program."""
    pat = _section(f, *heads, 0)
    if pat is None or pat[0] != 0:
        raise ValueError(f"{path}: a transport stream without a PAT")
    pmt_pid = None
    for k in range(8, len(pat) - 4, 4):
        number = pat[k] << 8 | pat[k + 1]
        if number:
            pmt_pid = (pat[k + 2] & 0x1F) << 8 | pat[k + 3]
            break
    if pmt_pid is None:
        raise ValueError(f"{path}: a PAT without a program")
    pmt = _section(f, *heads, pmt_pid)
    if pmt is None or pmt[0] != 2:
        raise ValueError(f"{path}: a transport stream without the PMT of "
                         f"its program (PID {pmt_pid})")
    at = 12 + ((pmt[10] & 15) << 8 | pmt[11])
    streams = []
    while at + 5 <= len(pmt) - 4:
        kind = pmt[at]
        spid = (pmt[at + 1] & 0x1F) << 8 | pmt[at + 2]
        streams.append((spid, kind))
        at += 5 + ((pmt[at + 3] & 15) << 8 | pmt[at + 4])
    return streams, pmt_pid


def _ts_pes(f, offs, pid, pusi, poff, plen, want: int, full: bool = False):
    """The PES packets of PID ``want`` (``Pes``; each from a
    payload_unit_start on) and, with ``full``, the elementary stream's
    chunks: (ES offsets, file offsets, lengths) of every payload after the
    PES headers, in order."""
    rows = np.flatnonzero((pid == want) & (plen > 0))
    starts = rows[pusi[rows]]
    if not starts.size:
        return [], (np.zeros(0, np.int64),) * 3
    rows = rows[rows >= starts[0]]
    lens = plen[rows].copy()
    foff = offs[rows] + poff[rows]
    first = np.flatnonzero(pusi[rows])
    hdr = []
    for k in first:
        f.seek(int(foff[k]))
        b = f.read(min(int(lens[k]), 64))
        if len(b) < 6 or b[:3] != b"\x00\x00\x01":
            hdr.append((0, None, None))
            continue
        n, pts, dts = _pes_header(b)
        n = min(n, int(lens[k]))
        hdr.append((n, pts, dts))
    skip = np.array([h[0] for h in hdr], np.int64)
    foff[first] += skip
    lens[first] -= skip
    es = np.concatenate(([0], np.cumsum(lens)[:-1]))
    sizes = np.add.reduceat(lens, first) if len(first) else lens
    pes = [Pes(int(offs[rows[k]]), h[1], h[2], int(es[k]), int(z))
           for k, h, z in zip(first, hdr, sizes)]
    chunks = (es, foff, lens) if full else None
    return pes, chunks


def _read_es(f, chunks, lo: int, hi: int) -> bytes:
    """The elementary stream's bytes [lo, hi) from its chunks."""
    es, foff, lens = chunks
    if hi <= lo:
        return b""
    a = max(int(np.searchsorted(es, lo, side="right")) - 1, 0)
    b = int(np.searchsorted(es, hi, side="left"))
    out = bytearray()
    for k in range(a, b):
        s, o, n = int(es[k]), int(foff[k]), int(lens[k])
        x0, x1 = max(lo, s), min(hi, s + n)
        if x1 > x0:
            f.seek(o + x0 - s)
            out += f.read(x1 - x0)
    return bytes(out)


# -- program stream -----------------------------------------------------------

class _Window:
    """Reads of a file through a window of 1 MiB."""

    def __init__(self, f):
        f.seek(0, 2)
        self.f, self.size = f, f.tell()
        self.base, self.buf = 0, b""

    def get(self, off: int, n: int) -> bytes:
        if off < self.base or off + n > self.base + len(self.buf):
            self.f.seek(off)
            self.buf = self.f.read(max(n, 1 << 20))
            self.base = off
        return self.buf[off - self.base:off - self.base + n]

    def find(self, off: int, hi: int) -> int:
        """The offset of the next system start code (00 00 01 and a byte of
        0xB9 or above) at or after ``off`` and before ``hi``; ``hi`` where
        there is none."""
        while off + 4 <= hi:
            chunk = self.get(off, min(1 << 20, hi - off))
            at = chunk.find(b"\x00\x00\x01")
            while at >= 0 and at + 3 < len(chunk) and chunk[at + 3] < 0xB9:
                at = chunk.find(b"\x00\x00\x01", at + 1)
            if at >= 0 and at + 3 < len(chunk):
                return off + at
            if len(chunk) < 4:
                break
            off += len(chunk) - 3
        return hi


def _ps_walk(w: _Window, lo: int, hi: int, psm: dict):
    """Yield (position, stream id, PTS, DTS, payload offset, payload size)
    of the audio and video PES packets of a program stream in [lo, hi),
    from the first start code at or after ``lo``; pack headers, system
    headers, private streams and padding stepped over, a PSM's stream types
    put in ``psm``."""
    at = w.find(lo, hi)
    while at + 6 <= hi:
        b = w.get(at, 16)
        if b[:3] != b"\x00\x00\x01" or b[3] < 0xB9:
            at = w.find(at + 1, hi)
            continue
        code = b[3]
        if code == 0xBA:
            if b[4] & 0xC0 == 0x40 and len(b) >= 14:
                at += 14 + (b[13] & 7)
            elif b[4] & 0xF0 == 0x20:
                at += 12
            else:
                at = w.find(at + 1, hi)
            continue
        if code == 0xB9:
            at += 4
            continue
        end = at + 6 + (b[4] << 8 | b[5])
        if code == 0xBC:
            _psm(w.get(at, end - at), psm)
        elif 0xC0 <= code <= 0xEF:
            head = w.get(at, min(end - at, 64))
            n, pts, dts = _pes_header(head)
            n = min(n, end - at)
            yield at, code, pts, dts, at + n, min(end, hi) - at - n
        at = end


def _psm(b: bytes, psm: dict) -> None:
    """The stream types of a program stream map."""
    if len(b) < 12:
        return
    at = 10 + (b[8] << 8 | b[9])
    end = min(at + 2 + (b[at] << 8 | b[at + 1]) if at + 2 <= len(b) else 0,
              len(b) - 4)
    at += 2
    while at + 4 <= end:
        psm[b[at + 1]] = b[at]
        at += 4 + (b[at + 2] << 8 | b[at + 3])


# -- timestamps ---------------------------------------------------------------

class Wrap:
    """ffmpeg's ``wrap_timestamp`` from the file's first timestamp."""

    def __init__(self, ref: int | None):
        self.ref = None if ref is None else ref - 60 * _HZ
        self.add = ref is not None and ref < _WRAP - 60 * _HZ

    def __call__(self, t: int | None) -> int | None:
        if t is None or self.ref is None:
            return t
        if self.add and t < self.ref:
            return t + _WRAP
        if not self.add and t >= self.ref:
            return t - _WRAP
        return t


def _audio_ticks(codec: str, payload: bytes) -> int:
    """An audio frame's duration in 1/90000 s, as ``av_get_audio_frame_
    duration`` gives it, from the first frame header of ``payload``."""
    if codec == "mp2":
        at = payload.find(b"\xff")
        while 0 <= at < len(payload) - 3:
            h = payload[at:at + 4]
            if h[1] & 0xE0 == 0xE0 and (h[2] >> 2) & 3 != 3:
                version = (h[1] >> 3) & 3          # 3 MPEG-1, 2 MPEG-2
                layer = 4 - ((h[1] >> 1) & 3)
                rates = {3: (44100, 48000, 32000), 2: (22050, 24000, 16000),
                         0: (11025, 12000, 8000)}.get(version)
                if rates and layer in (1, 2, 3):
                    rate = rates[(h[2] >> 2) & 3]
                    samples = 384 if layer == 1 else (
                        576 if layer == 3 and version != 3 else 1152)
                    return samples * _HZ // rate
            at = payload.find(b"\xff", at + 1)
    elif codec == "aac":
        at = payload.find(b"\xff")
        if 0 <= at < len(payload) - 3 and payload[at + 1] & 0xF0 == 0xF0:
            rate = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                    16000, 12000, 11025, 8000, 7350)[
                        min((payload[at + 2] >> 2) & 15, 12)]
            return 1024 * _HZ // rate
    elif codec == "ac3":
        at = payload.find(b"\x0b\x77")
        if 0 <= at < len(payload) - 5:
            rate = (48000, 44100, 32000, 48000)[payload[at + 4] >> 6]
            return 1536 * _HZ // rate
    raise NotImplementedError(
        f"the duration of a {codec} audio packet, which ffmpeg's estimate "
        f"of the file's duration adds; {_A9} lists it")


# -- the file -----------------------------------------------------------------

class Streams(NamedTuple):
    """What the head of a file gives: the container (``"ts"`` or
    ``"ps"``), the video stream's id (PID or stream id) and codec head
    (``_HEADS``), the audio streams' ids with their codec names and the
    first bytes of their payloads, each stream's first PTS, the wrap and
    the layout of a transport stream."""
    kind: str
    video: int
    head: dict
    audio: dict
    audio_head: dict
    first: dict
    wrap: Wrap
    layout: _TsLayout | None


def _ts_region(f, lay: _TsLayout, lo: int, hi: int, path: str):
    """The packet headers (``_ts_headers``) of the packets in [lo, hi)."""
    k0 = max(0, -(-(lo - lay.first) // lay.size))
    start = lay.first + k0 * lay.size
    f.seek(start)
    buf = np.frombuffer(f.read(max(0, hi - start)), np.uint8)
    return _ts_headers(buf, start, lay, path)


def _codec_head(codec: str, es: bytes) -> dict:
    head = _HEADS[codec](es) if codec in _HEADS else None
    return head or {"codec": codec, "width": 0, "height": 0, "rate": None,
                    "fields": 0, "low_delay": None}


def streams(f, path: str) -> Streams:
    """The head of a transport or program stream (``Streams``); ValueError
    for a file that is neither, or without a video stream."""
    f.seek(0, 2)
    size = f.tell()
    f.seek(0)
    head = f.read(min(size, 1 << 16))
    lay = _ts_layout(head)
    if lay is not None:
        return _ts_streams(f, lay, min(size, _PROBE), path)
    if head[:4] != b"\x00\x00\x01\xba":
        raise ValueError(f"{path}: not an MPEG program or transport stream")
    return _ps_streams(f, min(size, _PROBE), path)


def _ts_streams(f, lay: _TsLayout, hi: int, path: str) -> Streams:
    heads = _ts_region(f, lay, 0, hi, path)
    program, _ = _ts_program(f, heads, path)
    video = next(((p, t) for p, t in program if t in VIDEO_TYPES), None)
    if video is None:
        raise ValueError(f"{path}: a transport stream whose program has no "
                         "video stream")
    audio = {p: AUDIO_TYPES[t] for p, t in program if t in AUDIO_TYPES}
    firsts, ref, ref_at, heads_of = {}, None, None, {}
    for p in [video[0]] + list(audio):
        pes, chunks = _ts_pes(f, *heads, p, full=True)
        got = [x for x in pes if x.pts is not None]
        if got:
            firsts[p] = got[0]
            t = got[0].dts if got[0].dts is not None else got[0].pts
            if ref_at is None or got[0].pos < ref_at:
                ref, ref_at = t, got[0].pos
        heads_of[p] = read_es(f, chunks, 0, 1 << 18 if p == video[0]
                              else 4096) if pes else b""
    codec = VIDEO_TYPES[video[1]]
    es = heads_of.pop(video[0])
    wrap = Wrap(ref)
    return Streams("ts", video[0], _codec_head(codec, es), audio, heads_of,
                   {p: wrap(x.pts) for p, x in firsts.items()}, wrap, lay)


def _ps_streams(f, hi: int, path: str) -> Streams:
    w, psm = _Window(f), {}
    firsts, video, es, ref, audio, heads_of = {}, None, b"", None, {}, {}
    for at, code, pts, dts, d0, n in _ps_walk(w, 0, hi, psm):
        if ref is None and (pts is not None or dts is not None):
            ref = dts if dts is not None else pts
        if code >= 0xE0 and video is None:
            video = code
        if code < 0xE0 and code not in audio:
            audio[code] = AUDIO_TYPES.get(psm.get(code, 0x03), "mp2")
            heads_of[code] = w.get(d0, min(n, 4096))
        if pts is not None:
            firsts.setdefault(code, pts)
        if code == video and len(es) < 1 << 18:
            es += w.get(d0, n)
        if video is not None and len(es) >= 1 << 16 and all(
                c in firsts for c in [video] + list(audio)):
            break
    if video is None:
        raise ValueError(f"{path}: a program stream without a video stream")
    codec = VIDEO_TYPES.get(psm.get(video))
    head = _codec_head(codec, es) if codec else probe_codec(es)
    if head is None:
        raise _unsupported(path, "a program stream video of a codec other "
                           "than H.264, MPEG-4 part 2 and MPEG-1/2 video")
    wrap = Wrap(ref)
    return Streams("ps", video, head, audio, heads_of,
                   {c: wrap(t) for c, t in firsts.items()}, wrap, None)


def _tail_pes(f, s: Streams, lo: int, hi: int, limit: int, path: str):
    """(stream, PTS) of the audio and video PES packets ffmpeg's
    ``estimate_timings_from_pts`` reads from ``lo``, in file order, as far
    as their payloads reach ``limit`` bytes."""
    wanted = [s.video] + list(s.audio)
    if s.kind == "ts":
        heads = _ts_region(f, s.layout, lo, hi, path)
        rows = sorted((x.pos, p, x.pts, x.size) for p in wanted
                      for x in _ts_pes(f, *heads, p)[0])
    else:
        rows = [(at, code, pts, n) for at, code, pts, _, _, n in
                _ps_walk(_Window(f), lo, hi, {}) if code in wanted]
    total = 0
    for _, sid, pts, n in rows:
        if total >= limit:
            break
        total += n
        yield sid, pts


def duration_us(f, s: Streams, path: str) -> int | None:
    """The file's duration in microseconds as ``estimate_timings_from_pts``
    and ``update_stream_timings`` give it (module docstring); None where
    no stream has one."""
    f.seek(0, 2)
    size = f.tell()
    rate = avg_frame_rate(frame_ticks(s.head["rate"], s.head["fields"]))
    vticks = _HZ * rate[1] // rate[0] if rate else 0
    durations: dict = {}
    last: dict = {}
    audio_ticks: dict = {}
    found, retry = False, 0
    while True:
        is_end = found
        lo = max(size - (_TAIL << retry), 0)
        for sid, pts in _tail_pes(f, s, lo, size,
                                  _TAIL << max(retry - 1, 0), path):
            if pts is None or sid not in s.first:
                continue
            pts = s.wrap(pts)
            if sid == s.video:
                ticks = vticks
            else:
                if sid not in audio_ticks:
                    audio_ticks[sid] = _audio_ticks(s.audio[sid],
                                                    s.audio_head[sid])
                ticks = audio_ticks[sid]
            d = pts + ticks - s.first[sid]
            found = True
            if d > 0:
                if (sid not in durations or last.get(sid, 0) <= 0 or (
                        durations[sid] < d and abs(d - last[sid]) < 60 * _HZ)):
                    durations[sid] = d
                last[sid] = d
        if not is_end:
            is_end = all(x in durations for x in [s.video] + list(s.audio))
        retry += 1
        if is_end or not lo or retry > _TAIL_RETRIES:
            break
    if not durations:
        return None
    starts = {k: _rescale(v, 1000000, _HZ) for k, v in s.first.items()}
    duration = max(_rescale(d, 1000000, _HZ) for d in durations.values())
    ends = [starts[k] + _rescale(d, 1000000, _HZ)
            for k, d in durations.items()]
    start = min(starts.values())
    return max(duration, max(ends) - start)


def meta(f, path: str) -> dict:
    """``num_frames``, ``fps``, ``width``, ``height`` and ``codec`` of the
    first video stream as cv2 reads them (module docstring), from the head
    and the tail of the file."""
    return meta_of(f, streams(f, path), path)


def meta_of(f, s: Streams, path: str) -> dict:
    head = s.head
    rate = avg_frame_rate(frame_ticks(head["rate"], head["fields"]))
    if rate is None:
        raise _unsupported(path, f"the rate of a {head['codec']} stream "
                           "without a frame rate in its headers (ffmpeg "
                           "estimates it from the timestamps)")
    fps = rate[0] / rate[1]
    dur = duration_us(f, s, path)
    sec = dur / 1e6 if dur is not None else -(1 << 63) / 1e6
    if sec < 0.000025:               # cv2's eps_zero: the stream's own
        sec = -(1 << 63) / _HZ       # (AV_NOPTS_VALUE ticks)
    return {"num_frames": math.floor(sec * fps + 0.5), "fps": fps,
            "width": head["width"], "height": head["height"],
            "codec": head["codec"]}


# -- the whole video stream ---------------------------------------------------

_BLOCK = 1 << 26              # bytes of packet headers scanned at a time


def video_pes(f, s: Streams, path: str):
    """Every PES packet of the video stream (``Pes``) and its elementary
    stream's chunks (ES offsets, file offsets, lengths)."""
    f.seek(0, 2)
    size = f.tell()
    if s.kind == "ts":
        lay = s.layout
        parts = []
        lo = lay.first
        while lo < size:
            hi = min(lo + (_BLOCK // lay.size) * lay.size, size)
            offs, pid, pusi, poff, plen = _ts_region(f, lay, lo, hi, path)
            keep = (pid == s.video) & (plen > 0)
            parts.append((offs[keep], pusi[keep], poff[keep], plen[keep]))
            lo = hi
        offs, pusi, poff, plen = (np.concatenate([p[i] for p in parts])
                                  for i in range(4))
        pid = np.full(len(offs), s.video, np.int64)
        return _ts_pes(f, offs, pid, pusi, poff, plen, s.video, full=True)
    w, pes, es = _Window(f), [], []
    at = 0
    for pos, code, pts, dts, d0, n in _ps_walk(w, 0, size, {}):
        if code == s.video and n > 0:
            pes.append(Pes(pos, pts, dts, at, n))
            es.append((at, d0, n))
            at += n
    arr = np.array(es, np.int64).reshape(-1, 3)
    return pes, (arr[:, 0], arr[:, 1], arr[:, 2])


def read_es(f, chunks, lo: int, hi: int) -> bytes:
    """``_read_es`` by one read of the file span and a gather."""
    es, foff, lens = chunks
    a = max(int(np.searchsorted(es, lo, side="right")) - 1, 0)
    b = int(np.searchsorted(es, hi, side="left"))
    if b <= a:
        return b""
    s0, o0 = foff[a:b], es[a:b]
    x0 = np.maximum(o0, lo)
    x1 = np.minimum(o0 + lens[a:b], hi)
    n = np.maximum(x1 - x0, 0)
    src = s0 + (x0 - o0)
    base, top = int(src[0]), int((src + n).max())
    if top - base > 4 * (hi - lo) + (1 << 20):
        return _read_es(f, chunks, lo, hi)
    f.seek(base)
    region = np.frombuffer(f.read(top - base), np.uint8)
    starts = np.concatenate(([0], np.cumsum(n)[:-1]))
    idx = np.repeat(src - base - starts, n) + np.arange(int(n.sum()))
    return region[idx].tobytes()


class Unit(NamedTuple):
    """An access unit as ffmpeg's parser cuts it: its offsets in the
    elementary stream, whether it is a key frame (an IDR picture, an I-VOP),
    the PTS and DTS it takes and the position of the PES it takes them
    from (-1 for none)."""
    start: int
    size: int
    key: bool
    pts: int | None
    dts: int | None
    pos: int


def _ue_bytes(b: bytes) -> tuple[int, int]:
    """How many bytes ``h264_find_frame_end`` reads of a slice header to
    decode first_mb_in_slice (at most 6), and its value."""
    for c in range(1, 7):
        v = int.from_bytes(b[:c].ljust(c, b"\0"), "big")
        bits = 8 * c
        zeros = bits - v.bit_length() if v else bits
        need = 2 * zeros + 1
        if need < bits or c == 6:
            if need > bits:
                return c, 1 << 30
            return c, (v >> (bits - need)) - 1
    return 6, 1 << 30


def _cuts(codec: str, f, chunks, total: int):
    """[(boundary, detection offset)] where the parser cuts the
    elementary stream, and each unit's key flag, read 4 MiB at a time."""
    cuts, keys = [], []
    piece = 1 << 22
    carry, base = b"", 0
    state = {"found": False, "last_mb": 0, "key": False}
    at = 0
    while at < total or carry:
        data = read_es(f, chunks, at, min(at + piece, total))
        at += len(data)
        final = at >= total
        buf = carry + data
        scs = _starts(buf)
        done = len(buf)
        for s in scs:
            if s + 8 > len(buf) and not final:
                done = max(s - 4, 0)
                break
            if s >= len(buf):
                continue
            h = base + s
            b = h - 4 if s >= 4 and buf[s - 4] == 0 else h - 3
            c = buf[s]
            if codec == "h264":
                kind = c & 0x1F
                if kind in (6, 7, 8, 9):
                    if state["found"]:
                        cuts.append((b, h))
                        keys.append(state["key"])
                        state.update(found=False, key=False)
                elif kind in (1, 2, 5):
                    n, mb = _ue_bytes(buf[s + 1:s + 7])
                    if state["found"] and mb <= state["last_mb"]:
                        cuts.append((b, h + n))
                        keys.append(state["key"])
                        state["key"] = False
                    state.update(found=True, last_mb=mb)
                    state["key"] = state["key"] or kind == 5
            else:
                b = h - 3
                if state["found"]:
                    cuts.append((b, h))
                    keys.append(state["key"])
                    state.update(found=False, key=False)
                if c == 0xB6:
                    state["found"] = True
                    state["key"] = s + 1 < len(buf) and buf[s + 1] >> 6 == 0
        if final:
            keys.append(state["key"])
            break
        carry, base = buf[done:], base + done
    return cuts, keys


def parse_units(pes: list[Pes], cuts: list, keys: list) -> list[Unit]:
    """The access units ffmpeg's parser returns for the PES packets
    ``pes`` with the cuts ``_cuts`` found, each with the timestamps
    ``av_parser_parse2`` fetches for it (module docstring)."""
    slots = [[0, 0, None, None, -1] for _ in range(4)]
    ring = 0
    cur = frame_off = next_off = 0
    fetch, got = True, (None, None, -1)
    out: list[Unit] = []
    start, ci = 0, 0

    def fetch_ts():
        nonlocal got
        got = (None, None, -1)
        for sl in slots:
            if cur >= sl[0] and (frame_off < sl[0] or (
                    not frame_off and not next_off)) and sl[1]:
                got = (sl[2], sl[3], sl[4])
                if cur < sl[1]:
                    break

    def call(size, pts, dts, pos, flush=False):
        nonlocal ring, fetch, cur, frame_off, next_off, start, ci
        if size and cur + size != slots[ring][1]:
            # a new packet (the rest of one is not)
            ring = (ring + 1) & 3
            slots[ring] = [cur, cur + size, pts, dts, pos]
        if fetch:
            fetch = False
            fetch_ts()
        if ci < len(cuts) and cuts[ci][1] < cur + size:
            b = cuts[ci][0]
            out.append(Unit(start, b - start, keys[len(out)], *got))
            start, ci = b, ci + 1
            index = b - cur
            frame_off, next_off, fetch = next_off, cur + index, True
            index = max(index, 0)
            cur += index
            return index
        if flush:
            return 0
        cur += size
        return size

    # the parser counts its offsets from the first packet's position
    shift = pes[0].pos if pes else 0
    cur = next_off = shift
    cuts = [(b + shift, d + shift) for b, d in cuts]
    start = shift
    for p in pes:
        size, pts, dts, pos = p.size, p.pts, p.dts, p.pos
        while size > 0:
            n = call(size, pts, dts, pos)
            pts = dts = None
            pos = -1
            size -= n
    call(0, None, None, -1, flush=True)
    end = shift + (pes[-1].start + pes[-1].size if pes else 0)
    if end > start:
        out.append(Unit(start, end - start, keys[len(out)]
                        if len(out) < len(keys) else False, *got))
    return [u._replace(start=u.start - shift) for u in out]


def units(f, s: Streams, path: str) -> tuple[list[Pes], list[Unit], tuple]:
    """(the video PES packets, its access units, the elementary stream's
    chunks) of a program or transport stream, the times unwrapped."""
    pes, chunks = video_pes(f, s, path)
    if s.head["codec"] not in ("h264", "mpeg4"):
        return pes, [], chunks
    pes = [p._replace(pts=s.wrap(p.pts), dts=s.wrap(p.dts)) for p in pes]
    total = pes[-1].start + pes[-1].size if pes else 0
    cuts, keys = _cuts(s.head["codec"], f, chunks, total)
    return pes, parse_units(pes, cuts, keys), chunks


def interpolate(out: list[Unit], ticks: int) -> list[Unit]:
    """``compute_pkt_fields`` on the units of a stream without B-frames (an
    MPEG-4 part 2 stream's, where ffmpeg infers them): a unit without a PTS
    takes its DTS, else the last one's PTS plus a frame, and its DTS is its
    PTS (``container`` refuses the result for a stream with B-VOPs)."""
    cur, res = None, []
    for u in out:
        pts = u.pts if u.pts is not None else u.dts
        if pts is None:
            pts = cur
        cur = None if pts is None else pts + ticks
        res.append(u._replace(pts=pts, dts=pts))
    return res
