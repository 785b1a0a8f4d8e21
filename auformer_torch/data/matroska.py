"""Matroska and WebM read without a demuxer library: the first video
track's frames, their times and key flags, as ffmpeg's ``matroskadec``
reads them (the JAX package reads these files through cv2's FFMPEG
backend, auformer/data/video.py).

``read(f, path)`` walks the file element by element through a window of
it (``_Window``): the headers of every element and the frames of the
video track are read, the frames of other tracks, ``Cues``, ``Tags`` and
the rest are stepped over by their sizes, so that the file is never held
whole. It reads the EBML header (``DocType`` ``matroska`` or ``webm``),
the ``Segment`` (also of unknown size: to the end of the file), its
``Info`` (``TimestampScale``, ``Duration``), ``Tracks`` (the first
``TrackEntry`` of ``TrackType`` 1: ``TrackNumber``, ``CodecID``,
``CodecPrivate``, ``DefaultDuration``, ``Video``'s ``PixelWidth`` and
``PixelHeight``, ``ContentEncodings``) and every ``Cluster`` (also of
unknown size: up to the next element that cannot be its child) with its
``Timestamp``, ``SimpleBlock`` and ``BlockGroup`` (``Block``,
``BlockDuration``, ``ReferenceBlock``); ``Void`` and ``CRC-32`` are
stepped over wherever they stand.

A frame's time is its cluster's ``Timestamp`` plus the block's signed
16-bit offset, in ``TimestampScale`` nanoseconds. A ``SimpleBlock`` is a
key frame when its flag says so, a ``BlockGroup`` exactly when it holds no
``ReferenceBlock``. A laced block (Xiph, EBML or fixed-size lacing) holds
several frames: the first has the block's time and key flag, each next one
the time of the one before plus its share of the block's duration
(``BlockDuration``, else ``DefaultDuration`` times the frames, in ticks),
split as ``matroska_parse_block`` splits it; none is a key frame.

``ContentEncoding``: header stripping (``ContentCompAlgo`` 3: its
``ContentCompSettings`` go ahead of every frame) and zlib (algo 0) are
undone by ``content`` on each frame as it is read; bzlib, LZO and
encryption raise NotImplementedError naming ROADMAP.md queue A9, as does
a ``TrackTimestampScale`` other than 1. A file cut short (a recording that
stopped) gives the frames that are whole, as ffmpeg does; a file that is
not Matroska, or whose elements overrun their parents within it, raises
ValueError.
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

_A9 = "ROADMAP.md queue A9 (offline ingest from videos)"
_WINDOW = 1 << 20

EBML, DOCTYPE = 0x1A45DFA3, 0x4282
SEGMENT, INFO, TRACKS, CLUSTER = 0x18538067, 0x1549A966, 0x1654AE6B, \
    0x1F43B675
TIMESTAMP_SCALE, DURATION = 0x2AD7B1, 0x4489
TRACK_ENTRY, TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = \
    0xAE, 0xD7, 0x83, 0x86, 0x63A2
DEFAULT_DURATION, TRACK_TIMESTAMP_SCALE, VIDEO = 0x23E383, 0x23314F, 0xE0
PIXEL_WIDTH, PIXEL_HEIGHT = 0xB0, 0xBA
CONTENT_ENCODINGS, CONTENT_ENCODING = 0x6D80, 0x6240
ENCODING_SCOPE, ENCODING_TYPE, COMPRESSION, ENCRYPTION = \
    0x5032, 0x5033, 0x5034, 0x5035
COMP_ALGO, COMP_SETTINGS = 0x4254, 0x4255
CLUSTER_TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP = 0xE7, 0xA3, 0xA0
BLOCK, BLOCK_DURATION, REFERENCE_BLOCK = 0xA1, 0x9B, 0xFB
VOID, CRC32 = 0xEC, 0xBF
# the children a Cluster may hold: any other ID ends one of unknown size
_CLUSTER_CHILDREN = {CLUSTER_TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, VOID,
                     CRC32, 0xA7, 0xAB, 0x5854, 0xAF}


class Frame(NamedTuple):
    """One frame of the video track: where its bytes lie in the file, its
    key flag and its time in ``TimestampScale`` ticks."""
    offset: int
    size: int
    key: bool
    time: int


def _unsupported(path: str, what: str):
    return NotImplementedError(f"{path}: {what} is not read; {_A9} lists "
                               "it")


class _Window:
    """Reads of a file through a window of ``_WINDOW`` bytes, so that a walk
    over its element headers reads each part of the file once and what it
    steps over not at all."""

    def __init__(self, f, path: str):
        f.seek(0, 2)
        self.f, self.path, self.size = f, path, f.tell()
        self.base, self.buf = 0, b""

    def get(self, off: int, n: int) -> bytes:
        if off < self.base or off + n > self.base + len(self.buf):
            self.f.seek(off)
            self.buf = self.f.read(max(n, _WINDOW))
            self.base = off
        return self.buf[off - self.base:off - self.base + n]

    def header(self, off: int) -> tuple[int, int, int | None]:
        """(ID, body offset, body size or None for an unknown size) of the
        element at ``off``."""
        head = self.get(off, 12)
        if len(head) < 2 or not head[0] or head[0] < 0x10:
            raise ValueError(f"{self.path}: no EBML element at {off}")
        n = 9 - head[0].bit_length()
        width = 9 - head[n].bit_length() if head[n] else 9
        if width > 8 or len(head) < n + width:
            raise ValueError(f"{self.path}: a bad element size at {off}")
        size = int.from_bytes(head[n:n + width], "big") & (
            (1 << 7 * width) - 1)
        return (int.from_bytes(head[:n], "big"), off + n + width,
                None if size == (1 << 7 * width) - 1 else size)


def _children(w: _Window, off: int, end: int):
    """(ID, body offset, body end) of the elements in [off, end); an
    element of unknown size runs to ``end``."""
    while off < end:
        eid, body, size = w.header(off)
        stop = end if size is None else body + size
        if stop > end:
            raise ValueError(f"{w.path}: element {eid:#x} at {off} overruns "
                             "its parent")
        yield eid, body, stop
        off = stop


def _uint(data: bytes) -> int:
    return int.from_bytes(data, "big")


def _float(data: bytes) -> float:
    if len(data) == 4:
        return struct.unpack(">f", data)[0]
    if len(data) == 8:
        return struct.unpack(">d", data)[0]
    if not data:
        return 0.0
    raise ValueError(f"a float element of {len(data)} bytes")


def _vint(data: bytes, off: int) -> tuple[int, int]:
    """(value, next offset) of the variable-size integer at ``off``."""
    if off >= len(data) or not data[off]:
        raise ValueError("a bad variable-size integer in a block")
    n = 9 - data[off].bit_length()
    return (int.from_bytes(data[off:off + n], "big") & ((1 << 7 * n) - 1),
            off + n)


def _track(w: _Window, b0: int, b1: int) -> dict:
    out: dict = {"encodings": []}
    for eid, c0, c1 in _children(w, b0, b1):
        if eid in (TRACK_NUMBER, TRACK_TYPE, DEFAULT_DURATION):
            out[eid] = _uint(w.get(c0, c1 - c0))
        elif eid == CODEC_ID:
            out[eid] = w.get(c0, c1 - c0).rstrip(b"\0").decode("latin-1")
        elif eid == CODEC_PRIVATE:
            out[eid] = w.get(c0, c1 - c0)
        elif eid == TRACK_TIMESTAMP_SCALE:
            out[eid] = _float(w.get(c0, c1 - c0))
        elif eid == VIDEO:
            for v, d0, d1 in _children(w, c0, c1):
                if v in (PIXEL_WIDTH, PIXEL_HEIGHT):
                    out[v] = _uint(w.get(d0, d1 - d0))
        elif eid == CONTENT_ENCODINGS:
            for e, d0, d1 in _children(w, c0, c1):
                if e == CONTENT_ENCODING:
                    out["encodings"].append(_encoding(w, d0, d1))
    return out


def _encoding(w: _Window, b0: int, b1: int) -> dict:
    out = {"scope": 1, "type": 0, "algo": None, "settings": b""}
    for eid, c0, c1 in _children(w, b0, b1):
        if eid == ENCODING_SCOPE:
            out["scope"] = _uint(w.get(c0, c1 - c0))
        elif eid == ENCODING_TYPE:
            out["type"] = _uint(w.get(c0, c1 - c0))
        elif eid == ENCRYPTION:
            out["type"] = 1
        elif eid == COMPRESSION:
            out["algo"] = 0
            for e, d0, d1 in _children(w, c0, c1):
                if e == COMP_ALGO:
                    out["algo"] = _uint(w.get(d0, d1 - d0))
                elif e == COMP_SETTINGS:
                    out["settings"] = w.get(d0, d1 - d0)
    return out


def content(frame: bytes, encodings: list[dict], scope: int = 1) -> bytes:
    """A frame (``scope`` 1) or the ``CodecPrivate`` (2) with the track's
    content encodings undone, the last applied first."""
    for enc in reversed(encodings):
        if not enc["scope"] & scope:
            continue
        if enc["algo"] == 3:
            frame = enc["settings"] + frame
        elif enc["algo"] == 0:
            frame = zlib.decompress(frame)
    return frame


def _check_encodings(path: str, encodings: list[dict]) -> None:
    for enc in encodings:
        if enc["type"] != 0:
            raise _unsupported(path, "an encrypted ContentEncoding")
        if enc["algo"] not in (0, 3):
            raise _unsupported(path, "a ContentCompression of algorithm "
                               f"{enc['algo']} (bzlib or LZO)")


def _laces(data: bytes, kind: int, off: int
           ) -> tuple[list[int], int, int]:
    """(the sizes of all but the last frame, the offset of the first
    frame, the number of frames) of a block laced the Xiph way (``kind``
    1) or the EBML way (3), whose lace count stands at ``off``."""
    count = data[off] + 1
    off += 1
    sizes: list[int] = []
    if kind == 1:
        for _ in range(count - 1):
            n = 0
            while True:
                n += data[off]
                off += 1
                if data[off - 1] != 255:
                    break
            sizes.append(n)
    elif kind == 3:
        n, off = _vint(data, off)
        sizes.append(n)
        for _ in range(count - 2):
            raw, nxt = _vint(data, off)
            bits = 7 * (nxt - off)
            n += raw - ((1 << bits - 1) - 1)
            sizes.append(n)
            off = nxt
    return sizes, off, count


def _block(w: _Window, b0: int, b1: int, number: int, cluster: int,
           key: bool | None, duration: int | None, default_duration: int,
           scale: int, path: str) -> list[Frame]:
    """The frames of a Block or SimpleBlock of track ``number`` (none for
    another track's); ``key`` None: the SimpleBlock's flag."""
    head = w.get(b0, min(b1 - b0, 8))
    track, off = _vint(head, 0)
    if track != number:
        return []
    rel, flags = struct.unpack(">hB", head[off:off + 3])
    off += 3
    if key is None:
        key = bool(flags & 0x80)
    time = cluster + rel
    lacing = (flags >> 1) & 3
    if not lacing:
        return [Frame(b0 + off, b1 - b0 - off, key, time)]
    # the lace sizes: at most 255 of them before the frames
    data = w.get(b0, min(b1 - b0, off + 1 + 255 * 8))
    if lacing == 2:
        count = data[off] + 1
        off += 1
        if (b1 - b0 - off) % count:
            raise ValueError(f"{path}: a fixed-size lace of {b1 - b0 - off} "
                             f"bytes in {count} frames")
        sizes = [(b1 - b0 - off) // count] * count
    else:
        sizes, off, count = _laces(data, lacing, off)
        sizes.append(b1 - b0 - off - sum(sizes))
    if min(sizes) < 0:
        raise ValueError(f"{path}: laces overrun their block")
    # ffmpeg: without a BlockDuration (or with 0), DefaultDuration for
    # each frame, in ticks
    span = duration or default_duration * count // scale
    frames, at = [], b0 + off
    for n, size in enumerate(sizes):
        share = span * (n + 1) // count - span * n // count
        if not share and n + 1 < count:
            raise _unsupported(path, "a laced video block without a "
                               "duration (its frames have no times)")
        frames.append(Frame(at, size, key and n == 0, time))
        at += size
        time += share
    return frames


def _cluster(w: _Window, b0: int, b1: int, track: dict, unknown: bool,
             out: list[Frame]) -> int:
    """Append the video track's frames of the cluster in [b0, b1); the
    offset where it ends (for one of unknown size, at the first element
    that cannot be its child)."""
    number, time = track[TRACK_NUMBER], None
    default, scale = track.get(DEFAULT_DURATION, 0), track["scale"]
    off = b0
    while off < b1:
        try:
            eid, c0, size = w.header(off)
        except ValueError:
            if off + 12 > w.size:       # a header cut by the end of file
                return w.size
            raise
        if unknown and eid not in _CLUSTER_CHILDREN:
            return off
        if size is None:
            raise ValueError(f"{w.path}: element {eid:#x} of unknown size "
                             "in a cluster")
        c1 = c0 + size
        if c1 > w.size:
            # a file cut short (a recording that stopped): ffmpeg returns
            # the frames that are whole
            return w.size
        if c1 > b1:
            raise ValueError(f"{w.path}: element {eid:#x} at {off} overruns "
                             "its cluster")
        if eid == CLUSTER_TIMESTAMP:
            time = _uint(w.get(c0, size))
        elif eid in (SIMPLE_BLOCK, BLOCK_GROUP):
            if time is None:
                raise ValueError(f"{w.path}: a block before its cluster's "
                                 "Timestamp")
            if eid == SIMPLE_BLOCK:
                out += _block(w, c0, c1, number, time, None, None, default,
                              scale, w.path)
            else:
                block, duration, key = None, None, True
                for g, d0, d1 in _children(w, c0, c1):
                    if g == BLOCK:
                        block = (d0, d1)
                    elif g == BLOCK_DURATION:
                        duration = _uint(w.get(d0, d1 - d0))
                    elif g == REFERENCE_BLOCK:
                        key = False
                if block is not None:
                    out += _block(w, *block, number, time, key, duration,
                                  default, scale, w.path)
        off = c1
    return off


def read(f, path: str) -> dict:
    """The file's ``doctype``, ``timestamp_scale`` (ns), ``duration`` (in
    ticks, None without one), the first video track's ``codec_id``,
    ``codec_private`` (its content encodings undone), ``default_duration``
    (ns, None without one), ``width``, ``height``, ``encodings`` and
    ``frames`` (a list of :class:`Frame` in file order)."""
    w = _Window(f, path)
    eid, body, size = w.header(0)
    if eid != EBML:
        raise ValueError(f"{path}: not a Matroska file")
    doctype = "matroska"
    for e, c0, c1 in _children(w, body, body + size):
        if e == DOCTYPE:
            doctype = w.get(c0, c1 - c0).rstrip(b"\0").decode("latin-1")
    if doctype not in ("matroska", "webm"):
        raise ValueError(f"{path}: an EBML file of DocType {doctype!r}")
    off = body + size
    eid, body, size = w.header(off)
    while eid in (VOID, CRC32):
        off = body + size
        eid, body, size = w.header(off)
    if eid != SEGMENT:
        raise ValueError(f"{path}: no Segment after the EBML header")
    end = w.size if size is None else min(body + size, w.size)
    scale, duration, track, frames = 1000000, None, None, []
    off = body
    while off < end:
        eid, c0, size = w.header(off)
        if eid == CLUSTER:
            if track is None:
                raise ValueError(f"{path}: a Cluster before the Tracks")
            track["scale"] = scale
            off = _cluster(w, c0, end if size is None else min(
                c0 + size, w.size), track, size is None, frames)
            continue
        if size is None:
            raise ValueError(f"{path}: element {eid:#x} of unknown size in "
                             "the Segment")
        c1 = min(c0 + size, end)
        if eid == INFO:
            for e, d0, d1 in _children(w, c0, c1):
                if e == TIMESTAMP_SCALE:
                    scale = _uint(w.get(d0, d1 - d0))
                elif e == DURATION:
                    duration = _float(w.get(d0, d1 - d0))
        elif eid == TRACKS and track is None:
            for e, d0, d1 in _children(w, c0, c1):
                if e == TRACK_ENTRY:
                    t = _track(w, d0, d1)
                    if t.get(TRACK_TYPE) == 1:
                        track = t
                        break
            if track is None:
                raise ValueError(f"{path}: no video track")
            if TRACK_NUMBER not in track or CODEC_ID not in track:
                raise ValueError(f"{path}: a video track without its "
                                 "TrackNumber or CodecID")
            if track.get(TRACK_TIMESTAMP_SCALE, 1.0) != 1.0:
                raise _unsupported(path, "a TrackTimestampScale other than 1")
            _check_encodings(path, track["encodings"])
        off = c0 + size
    if track is None:
        raise ValueError(f"{path}: no Tracks")
    return {"doctype": doctype, "timestamp_scale": scale,
            "duration": duration, "codec_id": track[CODEC_ID],
            "codec_private": content(track.get(CODEC_PRIVATE, b""),
                                     track["encodings"], 2),
            "default_duration": track.get(DEFAULT_DURATION),
            "width": track.get(PIXEL_WIDTH, 0),
            "height": track.get(PIXEL_HEIGHT, 0),
            "encodings": track["encodings"], "frames": frames}
