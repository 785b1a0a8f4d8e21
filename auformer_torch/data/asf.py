"""ASF (.wmv, .asf) read without a demuxer library: the first video
stream's meta, media objects and their times, as ffmpeg's ``asf`` demuxer
(asfdec_f.c) gives them to cv2 (the JAX package reads these files through
cv2's FFMPEG backend, auformer/data/video.py).

``read(f, path)`` walks the Header Object: File Properties (play
duration, preroll, the broadcast flag, the file and packet sizes), Stream
Properties (the video stream's number and BITMAPINFOHEADER: fourcc, width,
height, extradata; the other streams' numbers), the Header Extension's
Extended Stream Properties (AvgTimePerFrame, which ffmpeg reads past) and
the Stream Bitrate Properties; then the Data Object's packets, of the
fixed size the header gives: error correction data, payload parsing
information, single and multiple payloads, replicated data (the media
object's size and presentation time in ms), compressed payloads (whole
objects of one byte's size each, their times from the payload's and its
delta) and padding. The video stream's fragments are rebuilt into media
objects in order; a key frame is an object whose stream number byte has
bit 7. The Simple Index Object gives ffmpeg's seek points. ``objects``
False reads the header and the first packets only (what ``meta`` needs).

Times are in ms, the preroll taken out (ffmpeg's ``pts = presentation time
- preroll``). A file whose objects do not fit together, or that is not
ASF, raises ValueError.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

_A9 = "ROADMAP.md queue A9 (offline ingest from videos)"
HEADER = bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c")
FILE_PROPERTIES = bytes.fromhex("a1dcab8c47a9cf118ee400c00c205365")
STREAM_PROPERTIES = bytes.fromhex("9107dcb7b7a9cf118ee600c00c205365")
HEADER_EXTENSION = bytes.fromhex("b503bf5f2ea9cf118ee300c00c205365")
EXT_STREAM_PROPERTIES = bytes.fromhex("cba5e61472c632438399a96952065b5a")
STREAM_BITRATES = bytes.fromhex("ce75f87b8d46d1118d82006097c9a2b2")
DATA = bytes.fromhex("3626b2758e66cf11a6d900aa0062ce6c")
SIMPLE_INDEX = bytes.fromhex("90080033b1e5cf1189f400a0c90349cb")
VIDEO_MEDIA = bytes.fromhex("c0ef19bc4d5bcf11a8fd00805f5c442b")
AUDIO_MEDIA = bytes.fromhex("409e69f84d5bcf11a8fd00805f5c442b")
_HEAD_PACKETS = 64            # data packets ``objects=False`` reads


class Object(NamedTuple):
    """A media object of the video stream: its offset and size in the
    stream of its fragments (``chunks``), key flag, presentation time (ms,
    less the preroll) and the number of the data packet it begins in."""
    start: int
    size: int
    key: bool
    pts: int
    packet: int


def _objects(data: bytes, off: int, end: int):
    """(GUID, body offset, object end) of the ASF objects in [off, end)."""
    while off + 24 <= end:
        guid = data[off:off + 16]
        size, = struct.unpack("<Q", data[off + 16:off + 24])
        if size < 24 or off + size > end:
            raise ValueError(f"an ASF object of {size} bytes overruns its "
                             "parent")
        yield guid, off + 24, off + size
        off += size


def _varlen(b: bytes, at: int, kind: int) -> tuple[int, int]:
    """ffmpeg's DO_2BITS: a field of 0, 1, 2 or 4 bytes by ``kind``."""
    n = (0, 1, 2, 4)[kind & 3]
    return int.from_bytes(b[at:at + n], "little"), at + n


def _header(f, path: str) -> dict:
    f.seek(0, 2)
    file_size = f.tell()
    f.seek(0)
    head = f.read(30)
    if len(head) < 30 or head[:16] != HEADER:
        raise ValueError(f"{path}: not an ASF file")
    size, = struct.unpack("<Q", head[16:24])
    f.seek(0)
    data = f.read(size)
    if len(data) < size:
        raise ValueError(f"{path}: an ASF Header Object cut short")
    out = {"video": None, "streams": {}, "bitrates": {},
           "header_size": size, "file_size": file_size}
    for guid, b0, b1 in _objects(data, 30, size):
        body = data[b0:b1]
        if guid == FILE_PROPERTIES:
            (out["declared_size"], _, out["packet_count"], out["play"],
             _, out["preroll"], out["flags"], out["min_packet"],
             out["max_packet"], _) = struct.unpack("<QQQQQQIIII",
                                                   body[16:80])
        elif guid == STREAM_PROPERTIES:
            _stream(body, out, path)
        elif guid == HEADER_EXTENSION:
            n, = struct.unpack("<I", body[18:22])
            for g, c0, c1 in _objects(body, 22, min(22 + n, len(body))):
                if g == EXT_STREAM_PROPERTIES:
                    # AvgTimePerFrame (ffmpeg reads past it); a Stream
                    # Properties Object may follow the stream's names and
                    # payload extension systems
                    names, exts = struct.unpack("<HH", body[c0 + 60:c0 + 64])
                    at = c0 + 64
                    for _ in range(names):
                        at += 4 + struct.unpack("<H", body[at + 2:at + 4])[0]
                    for _ in range(exts):
                        at += 22 + struct.unpack("<I",
                                                 body[at + 18:at + 22])[0]
                    for g2, d0, d1 in _objects(body, at, c1):
                        if g2 == STREAM_PROPERTIES:
                            _stream(body[d0:d1], out, path)
        elif guid == STREAM_BITRATES:
            n, = struct.unpack("<H", body[:2])
            for k in range(n):
                flags, rate = struct.unpack("<HI", body[2 + 6 * k:8 + 6 * k])
                out["bitrates"][flags & 0x7F] = rate
    if "preroll" not in out:
        raise ValueError(f"{path}: an ASF file without File Properties")
    if out["video"] is None:
        raise ValueError(f"{path}: an ASF file without a video stream")
    f.seek(size)
    d = f.read(50)
    if len(d) < 50 or d[:16] != DATA:
        raise ValueError(f"{path}: no Data Object after the ASF header")
    out["data_size"], = struct.unpack("<Q", d[16:24])
    out["data_offset"] = size + 50
    out["index"] = _simple_index(f, size + out["data_size"], file_size)
    return out


def _stream(body: bytes, out: dict, path: str) -> None:
    kind = body[:16]
    tsize, _ = struct.unpack("<II", body[40:48])
    flags, = struct.unpack("<H", body[48:50])
    number = flags & 0x7F
    out["streams"][number] = ("video" if kind == VIDEO_MEDIA else
                              "audio" if kind == AUDIO_MEDIA else "other")
    if kind != VIDEO_MEDIA or out["video"] is not None:
        return
    t = body[54:54 + tsize]
    if len(t) < 11 + 40:
        raise ValueError(f"{path}: an ASF video stream without its "
                         "BITMAPINFOHEADER")
    bih = t[11:]
    size, width, height = struct.unpack("<Iii", bih[:12])
    out["video"] = number
    out["width"], out["height"] = width, abs(height)
    out["fourcc"] = bih[16:20].decode("latin-1")
    out["extradata"] = bih[40:size] if size > 40 else b""


def _simple_index(f, at: int, file_size: int) -> tuple | None:
    """(entry interval in 100 ns, [packet number of each entry]) of the
    first Simple Index Object after the Data Object, None without one."""
    while at + 24 <= file_size:
        f.seek(at)
        head = f.read(24)
        size, = struct.unpack("<Q", head[16:24])
        if size < 24:
            return None
        if head[:16] == SIMPLE_INDEX:
            body = f.read(size - 24)
            interval, _, count = struct.unpack("<QII", body[16:32])
            entries = [struct.unpack("<IH", body[32 + 6 * k:38 + 6 * k])[0]
                       for k in range(count)]
            return interval, entries
        at += size
    return None


def read(f, path: str, objects: bool = True) -> dict:
    """The header (``_header``), each stream's first presentation time
    (``first``, ms less the preroll), the video stream's objects' times in
    the packets read (``times``) and, with ``objects``, the video
    stream's media objects (``Object``) and its fragments' ``chunks``
    (offsets in the stream of fragments, file offsets, lengths); without,
    only the first packets are read."""
    h = _header(f, path)
    size = h["max_packet"]
    if not size or size != h["min_packet"]:
        raise ValueError(f"{path}: ASF data packets of no fixed size")
    total = max(0, (h["file_size"] - h["data_offset"]) // size)
    if h["data_size"] > 50:
        total = min(total, (h["data_size"] - 50) // size)
    h["first"], h["times"] = {}, []
    objs, chunks = [], []
    building = None          # [start, size wanted, got, key, pts, packet]
    es = 0
    last = total if objects else min(total, _HEAD_PACKETS)
    for k in range(last):
        pos = h["data_offset"] + k * size
        f.seek(pos)
        pkt = f.read(size)
        if len(pkt) < size:
            break
        for number, key, obj_size, offset, pts, d0, n in _payloads(
                pkt, h["preroll"], path):
            h["first"].setdefault(number, pts)
            if number == h["video"] and not offset:
                h["times"].append(pts)
            if number != h["video"] or not objects:
                continue
            if building is None or offset == 0:
                if building is not None and building[2] != building[1]:
                    raise ValueError(f"{path}: an ASF media object of "
                                     f"{building[1]} bytes holds "
                                     f"{building[2]}")
                if offset:
                    continue        # the rest of an object begun before
                building = [es, obj_size, 0, key, pts, k]
            elif offset != building[2]:
                raise ValueError(f"{path}: an ASF fragment at {offset} of an "
                                 f"object holding {building[2]} bytes")
            chunks.append((es, pos + d0, n))
            es += n
            building[2] += n
            if building[2] == building[1]:
                objs.append(Object(building[0], building[1], building[3],
                                   building[4], building[5]))
                building = None
    h["objects"] = objs
    arr = np.array(chunks, np.int64).reshape(-1, 3)
    h["chunks"] = (arr[:, 0], arr[:, 1], arr[:, 2])
    return h


def _payloads(pkt: bytes, preroll: int, path: str):
    """(stream number, key flag, object size, offset in the object,
    presentation time less the preroll, data offset in the packet, data
    length) of each payload of a data packet, as asfdec_f reads them (a
    compressed payload's sub-payloads each a whole object)."""
    at = 0
    c = pkt[0]
    if c & 0x80:                       # error correction data
        at = 1 + (c & 0x0F)
        c = pkt[at]
    d = pkt[at + 1]
    at += 2
    length, at = _varlen(pkt, at, c >> 5)
    _, at = _varlen(pkt, at, c >> 1)   # sequence
    pad, at = _varlen(pkt, at, c >> 3)
    send, = struct.unpack("<I", pkt[at:at + 4])
    at += 6                            # send time, duration
    if not length:
        length = len(pkt)
    elif length < len(pkt):
        pad += len(pkt) - length
    end = len(pkt) - pad
    count, seg = 1, 0x80
    if c & 1:
        seg = pkt[at]
        count = seg & 0x3F
        at += 1
    for _ in range(count):
        if at >= end:
            break
        num = pkt[at]
        at += 1
        _, at = _varlen(pkt, at, d >> 4)             # media object number
        offset, at = _varlen(pkt, at, d >> 2)
        rep, at = _varlen(pkt, at, d)
        obj_size = pts = 0
        delta = None
        if rep >= 8:
            obj_size, pts = struct.unpack("<II", pkt[at:at + 8])
            at += rep
        elif rep == 1:
            delta = pkt[at]
            at += 1
        elif rep:
            raise ValueError(f"{path}: ASF replicated data of {rep} bytes")
        if c & 1:
            n, at = _varlen(pkt, at, seg >> 6)
        else:
            n = end - at
        if at + n > end:
            raise ValueError(f"{path}: an ASF payload overruns its packet")
        if delta is None:
            yield num & 0x7F, bool(num & 0x80), obj_size, offset, \
                pts - preroll, at, n
        else:
            t, sub, stop = offset, at, at + n
            while sub < stop:
                m = pkt[sub]
                if sub + 1 + m > stop:
                    break
                yield num & 0x7F, bool(num & 0x80), m, 0, t - preroll, \
                    sub + 1, m
                t += delta
                sub += 1 + m
        at += n
