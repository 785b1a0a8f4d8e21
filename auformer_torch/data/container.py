"""A video's frame index read from its container, without a decoder (the
JAX package asks cv2's FFMPEG backend, auformer/data/video.py:30-48).

``probe(path)`` gives what cv2 reports of the first video stream:
``num_frames`` (``CAP_PROP_FRAME_COUNT``), ``fps`` (``CAP_PROP_FPS``),
``width``, ``height``, ``packets`` (the frames a decode loop of ``grab()``
returns) and ``timestamps_ms`` (``CAP_PROP_POS_MSEC`` after each
``grab()``), for MP4/MOV (fragmented too), AVI and Matroska/WebM, and
for ASF (``data/asf.py``) and MPEG program and transport streams
(``data/mpegstream.py``, whose module docstring has their rules). cv2
computes them from ffmpeg's demuxer state; the rules below follow
ffmpeg's code and were each held against cv2 on files written by cv2, by
libavformat or by the tests' writers, some edited box by box
(tests/test_torch_video_ingest.py, test_torch_video_matroska.py,
test_torch_video_fragmented.py, test_torch_video_mpegts.py,
test_torch_video_asf.py). ``meta(path)`` gives the first four; for ASF
and MPEG streams it reads the head and the tail of the file only, as
ffmpeg's open does, where ``probe`` and ``packet_index`` read it all:

  ``num_frames``  ``AVStream.nb_frames``: for MP4/MOV the sum of the
                  ``stts`` run counts (``mov_read_stts``), for AVI the
                  stream header's ``dwLength`` (``avi_read_header``). An
                  edit list does not change it. A fragmented MP4 whose
                  ``moov`` holds samples keeps their count; one whose
                  ``stts`` is empty counts every fragment's samples.
                  Matroska has none, so cv2 takes ``floor(duration * fps
                  + 0.5)``: the Segment's ``Duration`` (ffmpeg's whole
                  microseconds; with an audio track longer than the
                  video, the longer), else the stream's unknown duration
                  (``AV_NOPTS_VALUE`` ticks: a large negative count, as a
                  live file written to a pipe gives).
  ``fps``         ``AVStream.avg_frame_rate``, which cv2 reads in place of
                  ``av_guess_frame_rate``: for MP4/MOV the sample count
                  times the ``mdhd`` timescale over the sum of the ``stts``
                  durations (``mov_read_trak``; a track whose samples are
                  all in fragments: the same over their durations, where
                  they are all one), for AVI ``dwRate / dwScale``, for
                  Matroska ``av_reduce(1e9, DefaultDuration, 30000)``
                  (``matroska_read_header``); 1 / time base where that is
                  zero.
  timestamps      ``(pts - start_time) * time_base * 1000`` in f64
                  (``dts_to_sec`` of cv2's ffmpeg backend). MP4/MOV: the
                  time base is 1 / timescale; the pts are the ``stts``
                  running sums; an edit list (``mov_fix_index``) keeps the
                  samples whose time lies in [media_time, media_time +
                  segment duration in the media timescale), leading empty
                  edits delay them all, and ``start_time`` is the first
                  kept sample's pts, so both shifts cancel. A fragment's
                  samples take their decode times from its ``tfdt``, else
                  from where the fragment before ended, and the edit list
                  shifts them without cutting any. AVI: the time base is
                  dwScale / dwRate, frame k of the stream's chunks has pts
                  ``dwStart + k``, and ``start_time`` is 0. Matroska: the
                  time base is ``TimestampScale`` ns, each frame's pts its
                  block time, ``start_time`` the earliest.
  ``packets``     the kept samples (MP4) or the stream's chunks in every
                  ``movi`` list, through OpenDML's ``AVIX`` parts (AVI),
                  that hold data: an empty one decodes to no frame; the
                  frames of the track's blocks (Matroska).

The edit window compares each sample's presentation time (decode time
plus its ``ctts`` offset), as ``mov_fix_index`` does: on a track with
reordering offsets it keeps the samples cv2 returns
(tests/data/videos/ctts_reorder.mp4 and ctts_cut.mp4). On such a track,
and on any Matroska track, the timestamps follow the order in which the
decoder returns the frames, as cv2 reports them: ``output_order`` reads
it from the stream's headers (``data/bitstream.py``: H.264 picture order
counts), and the times count from the smallest kept presentation time. An
MPEG-4 part 2 stream's timestamps are those of the frames its decoder
returns (``mpeg4.output_frames``, the decoder reading the headers alone;
none for a VOP with vop_coded 0), as cv2 reports them (ROADMAP.md C12): a
frame's presentation time, which is that of the packet whose properties
ffmpeg gives it (its own, or the last one's for a frame returned at the
end of a stream after a VOP of vop_coded 0); where there is none, as in
an AVI or a Matroska ``V_MS/VFW/FOURCC`` track (whose block times are
decode times, ffmpeg's ``ms_compat``) whose stream is not low delay, the
decode time of the packet whose decoding returned the frame (0 for one
returned at the end of the stream). An H.264 stream in AVI takes that
rule too, with the frames ffmpeg's decoder returns
(``bitstream.h264_output_frames``): a stream with B frames has its
timestamps one or more chunks late and 0 for the last.

``packet_index(path)`` lists the stream's packets in decode order (file
offset, size, sync flag from ``stss``, the fragments' sample flags, the
AVI index or the Matroska block, decode and presentation time, whether
the edit list keeps it) with the codec and its setup data (``avcC``'s SPS
and PPS, the ``esds`` VOL header, a Matroska track's CodecPrivate), and
``access_units`` reads each packet as a decoder takes it: H.264 in MP4 or
Matroska as Annex B, as ffmpeg's h264_mp4toannexb writes it, MPEG-4 part
2 in MP4 or Matroska with its VOL ahead of the first, a Matroska frame
with its content encoding (header stripping, zlib) undone; each equals
cv2's raw packet (``CAP_PROP_FORMAT`` -1) byte for byte
(tests/test_torch_video_decode.py). Matroska itself is read by
``data/matroska.py``.

What raises ``NotImplementedError`` naming ROADMAP.md queue A9: an edit
list of more than one media edit or a rate other than 1, the rate of a
fragmented track whose samples last different times, a second ``trun``
of a ``traf`` without its data offset, a Matroska track without
DefaultDuration, encrypted or bzlib/LZO content, the timestamps of a
Matroska track whose codec the port does not decode (VP9, AV1, HEVC:
meta is read), the timestamps of a track with ``ctts`` whose codec is
neither H.264 (with ``avcC``) nor MPEG-4 part 2 (HEVC, for one), whose
output order the port does not read, the frames and timestamps of the
other codecs (MPEG-1/2 video, WMV/VC-1: meta is read), and what
``_stream_stamps`` and ``_asf_meta`` do not follow. A file that is none
of these formats, or malformed, raises ValueError.

In an ASF file or an MPEG program or transport stream a frame's time is
its PTS where it has one other than 0, else the DTS of the packet whose
decoding returned it (``_stream_stamps``), as cv2 reads ``pkt_dts`` for a
frame without one; a unit of an MPEG stream that takes no PTS from its
PES has none, and cv2 gives it 0.
"""
from __future__ import annotations

import math
import struct
from typing import Iterator, NamedTuple

from . import bitstream

_A9 = "ROADMAP.md queue A9 (offline ingest from videos)"


class Packet(NamedTuple):
    """One sample (MP4) or chunk (AVI) of the video stream. Times are in
    the stream's time base; ``kept`` is False for an empty chunk and for a
    sample outside the edit list."""
    offset: int
    size: int
    sync: bool
    dts: int
    pts: int
    kept: bool


_MP4_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts",
                   b"mvex", b"traf"}


def _unsupported(path: str, what: str):
    return NotImplementedError(f"{path}: {what} is not read without a video "
                               f"decoder; {_A9} lists it")


# -- ISO BMFF (MP4/MOV) -------------------------------------------------------

def _boxes(buf: bytes, off: int = 0, end: int | None = None):
    """Yield (type, body offset, body end) of the boxes in buf[off:end]."""
    end = len(buf) if end is None else end
    while off + 8 <= end:
        size, kind = struct.unpack(">I4s", buf[off:off + 8])
        head = 8
        if size == 1:
            size, = struct.unpack(">Q", buf[off + 8:off + 16])
            head = 16
        elif size == 0:
            size = end - off
        if size < head or off + size > end:
            raise ValueError(f"box {kind!r} of {size} bytes overruns its "
                             "parent")
        yield kind, off + head, off + size
        off += size


def _tree(buf: bytes, off: int = 0, end: int | None = None) -> dict:
    """type -> list of children (container boxes) or bodies (leaves)."""
    out: dict = {}
    for kind, b0, b1 in _boxes(buf, off, end):
        out.setdefault(kind, []).append(
            _tree(buf, b0, b1) if kind in _MP4_CONTAINERS else buf[b0:b1])
    return out


def _top_level_mp4(f, path: str) -> tuple[bytes, list[tuple[int, bytes]]]:
    """The ``moov`` body of the file and (offset, body) of each ``moof``
    after it, read box header by box header (``mdat``, ``sidx``, ``mfra``
    and the rest are stepped over, 64-bit and to-the-end sizes
    included)."""
    f.seek(0, 2)
    size_of_file = f.tell()
    off, moov, moofs = 0, None, []
    while off + 8 <= size_of_file:
        f.seek(off)
        size, kind = struct.unpack(">I4s", f.read(8))
        head = 8
        if size == 1:
            size, = struct.unpack(">Q", f.read(8))
            head = 16
        elif size == 0:
            size = size_of_file - off
        if size < head:
            raise ValueError(f"{path}: box {kind!r} has size {size}")
        if kind == b"moov":
            moov = f.read(size - head)
        elif kind == b"moof":
            moofs.append((off, f.read(size - head)))
        off += size
    if moov is None:
        raise ValueError(f"{path}: an MP4 without a moov box")
    return moov, moofs


def _video_trak(moov: dict, path: str) -> dict:
    for trak in moov.get(b"trak", []):
        mdia = trak.get(b"mdia", [{}])[0]
        hdlr = mdia.get(b"hdlr", [b""])[0]
        if hdlr[8:12] == b"vide":
            return trak
    raise ValueError(f"{path}: no video track")


def _mp4_track(f, path: str) -> dict:
    """The first video track's sample table: each sample's file offset,
    size, sync flag, decode and presentation time, whether the edit list
    keeps it, and the codec with its setup data; the samples of a
    fragmented file's ``moof`` boxes after those of its ``moov``."""
    moov_body, moofs = _top_level_mp4(f, path)
    moov = _tree(moov_body)
    movie_scale = _timescale(moov[b"mvhd"][0])
    trak = _video_trak(moov, path)
    mdia = trak[b"mdia"][0]
    stbl = mdia[b"minf"][0][b"stbl"][0]
    scale = _timescale(mdia[b"mdhd"][0])
    entry = stbl[b"stsd"][0][8:]          # the first sample entry
    width, height = struct.unpack(">HH", entry[32:36])

    body = stbl[b"stts"][0]
    n, = struct.unpack(">I", body[4:8])
    runs = [struct.unpack(">II", body[8 + 8 * i:16 + 8 * i])
            for i in range(n)]
    num_frames = sum(c for c, _ in runs)
    duration = sum(c * d for c, d in runs)
    sizes = _sample_sizes(stbl, path)
    # decode times: the stts runs, the last delta repeated for samples
    # past them
    dts = []
    t = 0
    for count, delta in runs + [(len(sizes), runs[-1][1] if runs else 0)]:
        for _ in range(min(count, len(sizes) - len(dts))):
            dts.append(t)
            t += delta
    cts = dts
    if b"ctts" in stbl:
        body = stbl[b"ctts"][0]
        n, = struct.unpack(">I", body[4:8])
        offsets = []
        for k in range(n):
            count, off = struct.unpack(">Ii", body[8 + 8 * k:16 + 8 * k])
            offsets += [off] * count
        cts = [d + o for d, o in zip(dts, offsets + [0] * len(dts))]
    sync = [True] * len(sizes)
    if b"stss" in stbl:
        body = stbl[b"stss"][0]
        n, = struct.unpack(">I", body[4:8])
        sync = [False] * len(sizes)
        for number in struct.unpack(f">{n}I", body[8:8 + 4 * n]):
            if 0 < number <= len(sizes):
                sync[number - 1] = True
    lo, hi = _edit_window(trak, movie_scale, scale, path)
    codec, setup = _mp4_codec(entry, path)
    packets = [Packet(o, z, y, d, c, lo <= c < hi and z > 0)
               for o, z, y, d, c in zip(_sample_offsets(stbl, sizes, path),
                                        sizes, sync, dts, cts)]
    ctts = b"ctts" in stbl
    if b"mvex" in moov:
        # a fragmented file: the edit list shifts the fragments' times
        # alone (ffmpeg's time_offset), which the timestamps take back out
        frag = _fragments(moov, trak, moofs, t, path)
        ctts = ctts or frag["ctts"]
        packets += [Packet(o, z, y, d, c, z > 0)
                    for o, z, y, d, c in frag["samples"]]
        if not num_frames:
            # an empty stts: ffmpeg's rate and count from the fragments'
            # sample durations, where they are all one
            durations = set(frag["durations"])
            if len(durations) > 1:
                raise _unsupported(path, "the rate of a fragmented track "
                                   "whose samples last different times")
            num_frames = len(frag["samples"])
            duration = num_frames * durations.pop() if durations else 0
    fps = (num_frames * scale / duration if num_frames and duration
           else float(scale))
    return {"num_frames": num_frames, "fps": fps, "width": width,
            "height": height, "time_base": 1 / scale, "ctts": ctts,
            "codec": codec, "setup": setup, "packets": packets}


def _fragments(moov: dict, trak: dict, moofs: list[tuple[int, bytes]],
               start: int, path: str) -> dict:
    """The track's samples in the ``moof`` boxes, as ffmpeg's
    ``mov_read_tfhd`` and ``mov_read_trun`` read them: ``samples`` as
    (offset, size, sync, dts, cts), each one's ``durations``, and whether
    any ``trun`` has composition offsets (``ctts``). Each field falls back
    from the ``trun`` to the ``tfhd`` to the ``trex`` of ``mvex``; the
    data of a ``traf`` starts at its explicit base offset, else at the
    ``moof`` under ``default-base-is-moof``, else where the previous
    ``traf``'s data ended (the ``moof`` for the first); decode times at
    the ``tfdt``, else where the previous fragment ended (``start`` for
    the first)."""
    track_id, = struct.unpack(">I", trak[b"tkhd"][0][
        20:24] if trak[b"tkhd"][0][0] == 1 else trak[b"tkhd"][0][12:16])
    trex = (0, 0, 0)
    for body in moov[b"mvex"][0].get(b"trex", []):
        tid, _, dur, size, flags = struct.unpack(">IIIII", body[4:24])
        if tid == track_id:
            trex = (dur, size, flags)
    out: dict = {"samples": [], "durations": [], "ctts": False}
    dts = start
    for moof_off, body in moofs:
        implicit = moof_off
        for kind, b0, b1 in _boxes(body):
            if kind != b"traf":
                continue
            traf = _tree(body, b0, b1)
            tfhd = traf[b"tfhd"][0]
            flags, tid = struct.unpack(">II", tfhd[:8])
            flags &= 0xFFFFFF
            if tid != track_id:
                continue
            at, (dur, size, sflags) = 8, trex
            if flags & 0x1:
                base, = struct.unpack(">Q", tfhd[at:at + 8])
                at += 8
            else:
                base = moof_off if flags & 0x20000 else implicit
            if flags & 0x2:
                at += 4
            for bit in (0x8, 0x10, 0x20):
                if flags & bit:
                    value, = struct.unpack(">I", tfhd[at:at + 4])
                    at += 4
                    if bit == 0x8:
                        dur = value
                    elif bit == 0x10:
                        size = value
                    else:
                        sflags = value
            if b"tfdt" in traf:
                tfdt = traf[b"tfdt"][0]
                dts, = struct.unpack(">Q", tfdt[4:12]) if tfdt[0] == 1 \
                    else struct.unpack(">I", tfdt[4:8])
            for k, trun in enumerate(traf.get(b"trun", [])):
                implicit, dts = _trun(trun, k, base, dts, (dur, size, sflags),
                                      out, path)
    return out


def _trun(trun: bytes, k: int, base: int, dts: int, defaults: tuple,
          out: dict, path: str) -> tuple[int, int]:
    """Append the samples of the ``k``-th ``trun`` of a ``traf`` to
    ``out`` (``_fragments``); (where its data ends, the decode time after
    it)."""
    version, flags = trun[0], int.from_bytes(trun[1:4], "big")
    count, = struct.unpack(">I", trun[4:8])
    at, offset = 8, base
    if flags & 0x1:
        rel, = struct.unpack(">i", trun[at:at + 4])
        offset, at = base + rel, at + 4
    elif k:
        raise _unsupported(path, "a second trun in a traf without its data "
                           "offset")
    first = None
    if flags & 0x4:
        first, = struct.unpack(">I", trun[at:at + 4])
        at += 4
    fields = [bit for bit in (0x100, 0x200, 0x400, 0x800) if flags & bit]
    out["ctts"] = out["ctts"] or bool(flags & 0x800)
    row = struct.Struct(">" + "".join("i" if b == 0x800 else "I"
                                      for b in fields))
    if at + row.size * count > len(trun):
        raise ValueError(f"{path}: a trun of {count} samples overruns its "
                         "box")
    for i in range(count):
        values = dict(zip(fields, row.unpack_from(trun, at + row.size * i)))
        dur = values.get(0x100, defaults[0])
        size = values.get(0x200, defaults[1])
        sflags = values.get(0x400, first if i == 0 and first is not None
                            else defaults[2])
        # ffmpeg: a key frame unless non-sync or depending on others
        sync = not sflags & 0x01010000
        out["samples"].append((offset, size, sync, dts,
                               dts + values.get(0x800, 0)))
        out["durations"].append(dur)
        offset += size
        dts += dur
    return offset, dts


def _mp4(f, path: str, timestamps: bool) -> dict:
    track = _mp4_track(f, path)
    kept = [p for p in track["packets"] if p.kept]
    out = {k: track[k] for k in ("num_frames", "fps", "width", "height")}
    out["packets"] = len(kept)
    if timestamps:
        first = min((p.pts for p in kept), default=0)
        if track["codec"] == "mpeg4":
            kept = [track["packets"][props]
                    for _, props, _ in _mpeg4_frames(path, track)[0]]
        elif track["ctts"]:
            order = output_order(path, track)
            kept = [track["packets"][k] for k in order]
        out["timestamps_ms"] = [(p.pts - first) * track["time_base"] * 1000.0
                                for p in kept]
    return out


def _mpeg4_frames(path: str, track: dict) -> tuple[list, bool]:
    """``mpeg4.output_frames`` in packet positions, the frames of kept
    packets only: an MPEG-4 part 2 stream's frames as ffmpeg's decoder
    returns them (a VOP of vop_coded 0 returns none), and whether the
    stream is low delay."""
    from . import mpeg4           # here: mpeg4 imports this module
    ks, units = [], []
    for k, unit in access_units(path, track, kept_only=False):
        ks.append(k)
        units.append(unit)
    frames, low_delay = mpeg4.output_frames(units)
    return [(ks[own], ks[props], None if trigger is None else ks[trigger])
            for own, props, trigger in frames
            if track["packets"][ks[own]].kept], low_delay


def _descriptor(body: bytes, off: int) -> tuple[int, int, int]:
    """(tag, payload offset, payload end) of an MPEG-4 descriptor."""
    tag, size, off = body[off], 0, off + 1
    for _ in range(4):
        b = body[off]
        off += 1
        size = size << 7 | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, off, off + size


def _esds_setup(esds: bytes) -> tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an ``esds`` body."""
    tag, off, end = _descriptor(esds, 4)
    if tag != 0x03:
        raise ValueError("an esds without its ES_Descriptor")
    flags = esds[off + 2]
    off += 3 + (2 if flags & 0x80 else 0) + (2 if flags & 0x20 else 0)
    if flags & 0x40:
        off += 1 + esds[off]
    tag, off, end = _descriptor(esds, off)
    if tag != 0x04:
        raise ValueError("an esds without its DecoderConfigDescriptor")
    oti, info = esds[off], b""
    if off + 13 < end:
        tag, b0, b1 = _descriptor(esds, off + 13)
        if tag == 0x05:
            info = esds[b0:b1]
    return oti, info


def _mp4_codec(entry: bytes, path: str) -> tuple[str, dict]:
    """(codec, setup) of a visual sample entry: ``"h264"`` with the SPS,
    PPS and NAL length size of its ``avcC``, ``"mpeg4"`` (part 2) with the
    VOL header of its ``esds``, ``"mjpeg"``, else the entry's fourcc."""
    kind = entry[4:8]
    boxes = dict((k, entry[b0:b1]) for k, b0, b1 in
                 _boxes(entry, 86, struct.unpack(">I", entry[:4])[0]))
    if kind in (b"avc1", b"avc3") and b"avcC" in boxes:
        return "h264", _avcc(boxes[b"avcC"])
    if kind == b"mp4v" and b"esds" in boxes:
        oti, info = _esds_setup(boxes[b"esds"])
        if oti == 0x20:
            return "mpeg4", {"vol": info}
        if oti == 0x6C:
            return "mjpeg", {}
    if kind in (b"jpeg", b"mjpa", b"mjpg"):
        return "mjpeg", {}
    return kind.decode("latin-1"), {}


def _avcc(c: bytes) -> dict:
    """The SPS, PPS and NAL length size of an ``avcC`` record (an MP4
    sample entry's box, a Matroska ``V_MPEG4/ISO/AVC`` CodecPrivate)."""
    off, sets = 6, {"nal_length_size": (c[4] & 3) + 1}
    for name, count in (("sps", c[5] & 0x1F), ("pps", None)):
        if count is None:
            count, off = c[off], off + 1
        sets[name] = []
        for _ in range(count):
            n, = struct.unpack(">H", c[off:off + 2])
            sets[name].append(c[off + 2:off + 2 + n])
            off += 2 + n
    return sets


def _sample_offsets(stbl: dict, sizes: list[int], path: str) -> list[int]:
    """Each sample's file offset from ``stsc`` and ``stco``/``co64``."""
    if b"stco" in stbl:
        body = stbl[b"stco"][0]
        n, = struct.unpack(">I", body[4:8])
        chunks = struct.unpack(f">{n}I", body[8:8 + 4 * n])
    elif b"co64" in stbl:
        body = stbl[b"co64"][0]
        n, = struct.unpack(">I", body[4:8])
        chunks = struct.unpack(f">{n}Q", body[8:8 + 8 * n])
    else:
        raise ValueError(f"{path}: a video track without stco or co64")
    body = stbl[b"stsc"][0]
    n, = struct.unpack(">I", body[4:8])
    runs = [struct.unpack(">III", body[8 + 12 * i:20 + 12 * i])
            for i in range(n)]
    out = []
    for i, (first, per_chunk, _) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else len(chunks)
        for c in range(first - 1, min(last, len(chunks))):
            off = chunks[c]
            for _ in range(per_chunk):
                if len(out) == len(sizes):
                    return out
                out.append(off)
                off += sizes[len(out) - 1]
    if len(out) < len(sizes):
        raise ValueError(f"{path}: stsc and stco place {len(out)} of "
                         f"{len(sizes)} samples")
    return out


def _timescale(body: bytes) -> int:
    """The timescale of an ``mvhd`` or ``mdhd`` box, version 0 or 1."""
    return struct.unpack(">I", body[20:24] if body[0] == 1 else body[12:16])[0]


def _sample_sizes(stbl: dict, path: str) -> list[int]:
    if b"stsz" not in stbl:
        raise ValueError(f"{path}: a video track without stsz")
    body = stbl[b"stsz"][0]
    size, count = struct.unpack(">II", body[4:12])
    if size:
        return [size] * count
    return list(struct.unpack(f">{count}I", body[12:12 + 4 * count]))


def _edit_window(trak: dict, movie_scale: int, scale: int, path: str
                 ) -> tuple[float, float]:
    """[media_time, media_time + duration) of the track's one media edit in
    its timescale (ffmpeg's ``mov_fix_index``); the whole track without an
    edit list. Leading empty edits delay every sample alike, which the
    timestamps' ``start_time`` takes back out."""
    edts = trak.get(b"edts")
    if not edts or b"elst" not in edts[0]:
        return float("-inf"), float("inf")
    body = edts[0][b"elst"][0]
    version, n = body[0], struct.unpack(">I", body[4:8])[0]
    fmt, step = (">QqhH", 20) if version == 1 else (">IihH", 12)
    media = []
    for k in range(n):
        seg, start, rate, frac = struct.unpack(
            fmt, body[8 + step * k:8 + step * (k + 1)])
        if start == -1:
            continue
        if rate != 1 or frac != 0:
            raise _unsupported(path, f"an edit at rate {rate}.{frac}")
        media.append((seg, start))
    if len(media) > 1:
        raise _unsupported(path, f"an edit list of {len(media)} media edits")
    if not media:
        return float("-inf"), float("inf")
    seg, start = media[0]
    # av_rescale: round half away from zero
    length = (seg * scale * 2 + movie_scale) // (2 * movie_scale)
    return start, start + length


# -- RIFF (AVI) ---------------------------------------------------------------

def _chunks(f, off: int, end: int):
    """Yield (fourcc, data offset, size, list type or None) of the RIFF
    chunks in [off, end), each padded to an even size."""
    while off + 8 <= end:
        f.seek(off)
        head = f.read(12)
        if len(head) < 8:
            return
        fourcc, size = struct.unpack("<4sI", head[:8])
        kind = head[8:12] if fourcc in (b"RIFF", b"LIST") else None
        yield fourcc, off + 8, size, kind
        off += 8 + size + (size & 1)


_AVI_CODECS = {b"H264": "h264", b"X264": "h264", b"AVC1": "h264",
               b"XVID": "mpeg4", b"DIVX": "mpeg4", b"DX50": "mpeg4",
               b"FMP4": "mpeg4", b"MP4V": "mpeg4", b"M4S2": "mpeg4",
               b"MP4S": "mpeg4",
               b"MJPG": "mjpeg"}


def _avi_stream(f, path: str) -> dict:
    """The first video stream's chunks: each one's file offset, size and
    key-frame flag (from the OpenDML ``ix##`` indexes, else ``idx1``, else
    all key frames), and its codec from the BITMAPINFOHEADER."""
    f.seek(0, 2)
    size_of_file = f.tell()
    stream = strh = strf = None
    movis, idx1 = [], None
    for fourcc, data, size, kind in _chunks(f, 0, size_of_file):
        if fourcc != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            continue
        end = min(data + size, size_of_file)
        for c4, d, s, k in _chunks(f, data + 4, end):
            if c4 == b"LIST" and k == b"movi":
                movis.append((d + 4, min(d + s, end)))
            elif c4 == b"LIST" and k == b"hdrl" and stream is None:
                stream, strh, strf = _avi_video_stream(f, d + 4, d + s, path)
            elif c4 == b"idx1" and idx1 is None:
                f.seek(d)
                idx1 = f.read(s)
    if stream is None:
        raise ValueError(f"{path}: an AVI without a video stream")
    scale, rate, start, length = struct.unpack("<IIII", strh[20:36])
    if not (scale and rate):
        scale, rate = 1, 25          # avi_read_header's fallback
    width, height = struct.unpack("<ii", strf[4:12])
    ids = (f"{stream:02d}dc".encode(), f"{stream:02d}db".encode())
    chunks, odml = [], {}             # (offset, size) of each, empty too
    for lo, hi in movis:
        for c4, d, s in _movi_chunks(f, lo, hi):
            if c4 in ids:
                chunks.append((d, s))
            elif c4 == f"ix{stream:02d}".encode():
                f.seek(d)
                odml.update(_odml_key_flags(f.read(s)))
    if odml:
        sync = [odml.get(d, True) for d, _ in chunks]
    elif idx1 is not None:
        flags = [struct.unpack("<I", idx1[k + 4:k + 8])[0] & 0x10 != 0
                 for k in range(0, len(idx1) - 15, 16)
                 if idx1[k:k + 4] in ids]
        sync = flags[:len(chunks)] + [True] * (len(chunks) - len(flags))
    else:
        sync = [True] * len(chunks)
    tb = scale / rate
    return {"num_frames": length, "fps": rate / scale, "width": width,
            "height": abs(height), "time_base": tb,
            "codec": _AVI_CODECS.get(strf[16:20].upper(),
                                     strf[16:20].decode("latin-1")),
            "fourcc": strf[16:20].decode("latin-1"),
            "setup": {},
            "packets": [Packet(d, s, y, start + k, start + k, s > 0)
                        for k, ((d, s), y) in enumerate(zip(chunks, sync))]}


def _movi_chunks(f, lo: int, hi: int):
    """(fourcc, data offset, size) of the chunks of a ``movi`` list in file
    order, those of its ``rec `` lists in place."""
    for c4, d, s, k in _chunks(f, lo, hi):
        if c4 == b"LIST" and k == b"rec ":
            yield from _movi_chunks(f, d + 4, d + s)
        else:
            yield c4, d, s


def _odml_key_flags(ix: bytes) -> dict[int, bool]:
    """{chunk data offset: key frame} of an OpenDML standard index chunk
    (AVISTDINDEX: dwSize's bit 31 marks a delta frame)."""
    per, _, kind, n = struct.unpack("<HBBI", ix[:8])
    if kind != 1 or per != 2:           # AVI_INDEX_OF_CHUNKS, 2 dwords
        return {}
    base, = struct.unpack("<Q", ix[12:20])
    out = {}
    for k in range(n):
        off, size = struct.unpack("<II", ix[24 + 8 * k:32 + 8 * k])
        out[base + off] = not size & 0x80000000
    return out


def _avi(f, path: str, timestamps: bool) -> dict:
    track = _avi_stream(f, path)
    out = {k: track[k] for k in ("num_frames", "fps", "width", "height")}
    kept = [p for p in track["packets"] if p.kept]
    out["packets"] = len(kept)
    if timestamps:
        out["timestamps_ms"] = _decode_time_stamps(path, track, kept)
    return out


def _decode_time_stamps(path: str, track: dict, kept: list[Packet]
                        ) -> list[float]:
    """The timestamps of a stream whose container stores decode times only
    (AVI, Matroska's ``V_MS/VFW/FOURCC``), ``kept`` its kept packets."""
    if track["codec"] == "mpeg4":
        # ffmpeg infers the presentation times (the decode times) for a
        # low-delay stream only; otherwise each frame carries the decode
        # time of the chunk whose decoding returned it (0 at the end of
        # the stream)
        frames, low_delay = _mpeg4_frames(path, track)
        kept = [track["packets"][props] if low_delay else
                None if trigger is None else track["packets"][trigger]
                for _, props, trigger in frames]
    elif track["codec"] == "h264":
        # the same for H.264: the chunk whose decoding returned each
        # frame, in the output ffmpeg's decoder gives (bitstream.py)
        kept = [None if trigger is None else track["packets"][trigger]
                for k, trigger in _h264_frames(path, track)
                if track["packets"][k].kept]
    return [0.0 if p is None else p.dts * track["time_base"] * 1000.0
            for p in kept]


def _avi_video_stream(f, off: int, end: int, path: str):
    """(stream number, strh, strf) of the first ``vids`` stream."""
    number = 0
    for c4, d, s, k in _chunks(f, off, end):
        if c4 != b"LIST" or k != b"strl":
            continue
        strh = strf = None
        for c, dd, ss, _ in _chunks(f, d + 4, d + s):
            if c in (b"strh", b"strf"):
                f.seek(dd)
                body = f.read(ss)
                if c == b"strh":
                    strh = body
                else:
                    strf = body
        if strh is not None and strh[:4] == b"vids":
            if strf is None or len(strf) < 12 or len(strh) < 36:
                raise ValueError(f"{path}: a video stream without its "
                                 "strh or BITMAPINFOHEADER")
            return number, strh, strf
        number += 1
    raise ValueError(f"{path}: an AVI without a video stream")


# -- entry point --------------------------------------------------------------

# -- Matroska/WebM ------------------------------------------------------------

_EPS_ZERO = 0.000025          # cv2's eps_zero (cap_ffmpeg_impl.hpp)
_NOPTS = -(1 << 63)           # AV_NOPTS_VALUE


def _av_reduce(num: int, den: int, limit: int) -> tuple[int, int]:
    """ffmpeg's ``av_reduce``: num/den as the nearest fraction whose terms
    are at most ``limit`` (num, den > 0)."""
    g = math.gcd(num, den)
    num, den = num // g, den // g
    if num <= limit and den <= limit:
        return num, den
    a0, a1 = (0, 1), (1, 0)
    while den:
        x = num // den
        nxt = num - den * x
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, a2
        num, den = den, nxt
    return a1


_MKV_MPEG4 = ("V_MPEG4/ISO/ASP", "V_MPEG4/ISO/SP", "V_MPEG4/ISO/AP")


def _mkv_codec(m: dict, path: str) -> tuple[str, dict, str | None]:
    """(codec, setup, fourcc or None) of a Matroska video track:
    ``V_MPEG4/ISO/AVC`` with its ``avcC`` CodecPrivate, MPEG-4 part 2 with
    its VOL as CodecPrivate, ``V_MJPEG``, and ``V_MS/VFW/FOURCC`` by its
    BITMAPINFOHEADER's fourcc, mapped as an AVI's is; else the CodecID."""
    cid, private = m["codec_id"], m["codec_private"]
    if cid == "V_MPEG4/ISO/AVC":
        if len(private) < 7:
            raise ValueError(f"{path}: an AVC track without its avcC")
        return "h264", _avcc(private), None
    if cid in _MKV_MPEG4:
        return "mpeg4", {"vol": private}, None
    if cid == "V_MJPEG":
        return "mjpeg", {}, None
    if cid == "V_MS/VFW/FOURCC":
        if len(private) < 40:
            raise ValueError(f"{path}: a V_MS/VFW/FOURCC track without its "
                             "BITMAPINFOHEADER")
        fourcc = private[16:20]
        codec = _AVI_CODECS.get(fourcc.upper(), fourcc.decode("latin-1"))
        setup = {"vol": private[40:]} if codec == "mpeg4" else {}
        return codec, setup, fourcc.decode("latin-1")
    return cid, {}, None


def _mkv_track(f, path: str) -> dict:
    """The first video track of a Matroska/WebM file as ``packet_index``
    gives it (module docstring): the blocks' frames in file order, which
    is decode order, each with its block time as pts and dts."""
    from . import matroska
    m = matroska.read(f, path)
    codec, setup, fourcc = _mkv_codec(m, path)
    scale = m["timestamp_scale"]
    tb = scale / 1e9
    if not m["default_duration"]:
        raise _unsupported(path, "the rate of a Matroska video track "
                           "without DefaultDuration (ffmpeg estimates it "
                           "from the first packets)")
    num, den = _av_reduce(1000000000, m["default_duration"], 30000)
    fps = num / den
    # cv2's get_total_frames: ffmpeg has no nb_frames for Matroska, so
    # floor(duration * fps + 0.5), the duration the Segment's (ffmpeg's
    # integer microseconds), else the stream's, which is unknown
    sec = (int(m["duration"] * float(scale) * 1000 / 1000000) / 1e6
           if m["duration"] else _NOPTS / 1e6)
    if sec < _EPS_ZERO:
        sec = _NOPTS * tb
    out = {"num_frames": math.floor(sec * fps + 0.5), "fps": fps,
           "width": m["width"], "height": m["height"], "time_base": tb,
           "codec": codec, "setup": setup,
           "packets": [Packet(fr.offset, fr.size, fr.key, fr.time, fr.time,
                              fr.size > 0) for fr in m["frames"]]}
    if m["encodings"]:
        out["encodings"] = m["encodings"]
    if fourcc is not None:
        out["fourcc"] = fourcc
    return out


def _mkv(f, path: str, timestamps: bool) -> dict:
    track = _mkv_track(f, path)
    kept = [p for p in track["packets"] if p.kept]
    out = {k: track[k] for k in ("num_frames", "fps", "width", "height")}
    out["packets"] = len(kept)
    if timestamps:
        out["timestamps_ms"] = _mkv_stamps(path, track, kept)
    return out


def _mkv_stamps(path: str, track: dict, kept: list[Packet]) -> list[float]:
    """A Matroska track's timestamps: in the decoder's output order from
    the block times (presentation times), relative to the earliest; a
    ``V_MS/VFW/FOURCC`` track's block times are decode times (ffmpeg's
    ``ms_compat``), read as an AVI's are."""
    codec = track["codec"]
    if codec not in ("h264", "mpeg4", "mjpeg"):
        raise _unsupported(path, f"the frames of a {codec} track (a block "
                           "can hold frames its decoder does not return)")
    if "fourcc" in track:
        return _decode_time_stamps(path, track, kept)
    first = min((p.pts for p in kept), default=0)
    if codec == "mpeg4":
        kept = [track["packets"][props]
                for _, props, _ in _mpeg4_frames(path, track)[0]]
    elif codec == "h264":
        kept = [track["packets"][k] for k in output_order(path, track)]
    return [(p.pts - first) * track["time_base"] * 1000.0 for p in kept]


# -- MPEG program and transport streams ---------------------------------------

def _mpeg_track(f, path: str) -> dict:
    """The first video stream of an MPEG program or transport stream
    (``data/mpegstream.py``): its access units as ffmpeg's parser cuts
    them, each a packet of offsets in the elementary stream (``chunks``
    maps them to the file), with the PTS and DTS it takes (None where it
    takes none)."""
    from . import mpegstream
    s = mpegstream.streams(f, path)
    out = mpegstream.meta_of(f, s, path)
    pes, units, chunks = mpegstream.units(f, s, path)
    inferred = any(u.pts is None for u in units)
    if out["codec"] == "mpeg4":
        units = mpegstream.interpolate(
            units, mpegstream.frame_ticks(s.head["rate"], 0))
    out.update(time_base=1 / 90000, setup={}, chunks=chunks, kind=s.kind,
               inferred=inferred, pes=pes,
               wraps_down=s.wrap.ref is not None and not s.wrap.add,
               packets=[Packet(u.start, u.size, u.key, u.dts, u.pts, True)
                        for u in units], unit_pos=[u.pos for u in units])
    out["start_time"] = next((u.pts for u in units if u.pts is not None),
                             None)
    return out


def _stream(read_track):
    """``probe`` of a container whose packets carry their own times (MPEG
    program and transport streams, ASF), from its track reader."""
    def read(f, path: str, timestamps: bool) -> dict:
        track = read_track(f, path)
        out = {k: track[k] for k in ("num_frames", "fps", "width",
                                     "height")}
        out["packets"] = len(track["packets"])
        if timestamps:
            out["timestamps_ms"] = _stream_stamps(path, track)
        return out
    return read


def _stream_stamps(path: str, track: dict) -> list[float]:
    """The timestamps cv2 reports of a stream whose packets carry their
    own times (MPEG program and transport streams, ASF): each frame's PTS
    where it has one other than 0, else the DTS of the packet whose
    decoding returned it (cv2 takes ``pkt_dts`` for a frame without a
    PTS), less the stream's start time; 0 where neither is known."""
    codec, packets = track["codec"], track["packets"]
    if codec not in ("h264", "mpeg4"):
        raise _unsupported(path, f"the frames of a {codec} stream")
    if codec == "mpeg4":
        frames, low_delay = _mpeg4_frames(path, track)
        if track.get("inferred") and not low_delay:
            raise _unsupported(path, "the times of an MPEG-4 part 2 stream "
                               "with B-VOPs whose units lack a PTS (ffmpeg "
                               "guesses them from the last I- or P-VOP)")
        pairs = [(props, trigger) for _, props, trigger in frames]
    else:
        pairs = _h264_frames(path, track)
    start, tb = track["start_time"], track["time_base"]
    out = []
    for own, trigger in pairs:
        t = packets[own].pts
        if not t:
            t = None
            if trigger is not None:
                p = packets[trigger]
                if p.dts is None and p.pts is not None:
                    raise _unsupported(path, "the time of a frame without a "
                                       "PTS returned by a packet without a "
                                       "DTS (ffmpeg guesses it from the "
                                       "PTS before)")
                t = p.dts
        out.append(0.0 if t is None or start is None
                   else (t - start) * tb * 1000.0)
    return out


# -- ASF ----------------------------------------------------------------------

def _asf_meta(h: dict, path: str) -> dict:
    """``num_frames``, ``fps``, ``width``, ``height`` and ``codec`` of an
    ASF file's video stream from its header and first packets
    (``data/asf.py``), as ffmpeg's ``asf`` demuxer and
    ``avformat_find_stream_info`` give them to cv2. ``avg_frame_rate`` is
    the probed frames' rate in the 1 ms time base, rounded to a standard
    rate within 1 %: for MPEG-4 part 2 from the VOL (its parser gives each
    frame its duration, whatever the times), for the rest from the
    objects' times (AvgTimePerFrame is read past). Every stream lasts the
    play duration less the preroll, where the file is not broadcast and
    its size is within 5 % of the header's; the file from the earliest
    stream start to the latest end where that is longer. A broadcast file
    has none, and cv2 counts floor(AV_NOPTS_VALUE ms x fps + 0.5)."""
    from . import mpegstream
    fourcc = h["fourcc"]
    codec = _AVI_CODECS.get(fourcc.upper().encode("latin-1"), fourcc)
    if codec == "mpeg4":
        head = mpegstream.mpeg4_head(h["extradata"]) or {}
        ticks = mpegstream.frame_ticks(head.get("rate"), 0, 1000)
    else:
        times = h["times"][:40]
        steps = {b - a for a, b in zip(times, times[1:])}
        if len(steps) != 1:
            raise _unsupported(path, "the rate of an ASF video stream whose "
                               "first frames are not evenly spaced (ffmpeg "
                               "averages their durations)")
        ticks = steps.pop()
    rate = mpegstream.avg_frame_rate(ticks, 1000)
    if rate is None:
        raise _unsupported(path, "the rate of an ASF video stream without "
                           "one in its headers or times")
    fps = rate[0] / rate[1]
    size, declared = h["file_size"], h["declared_size"]
    known = not h["flags"] & 1 and (
        declared <= 0 or abs(size - declared) < min(size, declared) / 20)
    if known:
        dur = h["play"] // 10000 - h["preroll"]
        starts = {k: t * 1000 for k, t in h["first"].items()}
        sec = max(dur * 1000, max(starts.values(), default=0) + dur * 1000
                  - min(starts.values(), default=0)) / 1e6
    elif all(h["bitrates"].get(k) for k in h["streams"]):
        raise _unsupported(path, "the duration of a broadcast ASF file from "
                           "its streams' bit rates")
    else:
        sec = _NOPTS / 1e6
    if sec < _EPS_ZERO:
        sec = _NOPTS * 0.001
    return {"num_frames": math.floor(sec * fps + 0.5), "fps": fps,
            "width": h["width"], "height": h["height"], "codec": codec}


def _asf_track(f, path: str) -> dict:
    """The video stream of an ASF file: its media objects as packets of
    offsets in the stream of their fragments (``chunks``), their
    presentation times (ms) as PTS and DTS, the VOL of an MPEG-4 part 2
    stream's BITMAPINFOHEADER as its setup."""
    from . import asf
    h = asf.read(f, path)
    out = _asf_meta(h, path)
    objs = h["objects"]
    out.update(time_base=1 / 1000, chunks=h["chunks"], kind="asf",
               fourcc=h["fourcc"],
               setup={"vol": h["extradata"]} if out["codec"] == "mpeg4"
               and h["extradata"] else {},
               packets=[Packet(o.start, o.size, o.key, o.pts, o.pts, True)
                        for o in objs],
               object_packet=[o.packet for o in objs],
               start_time=objs[0].pts if objs else None,
               simple_index=h["index"], preroll=h["preroll"])
    return out


# -- entry point --------------------------------------------------------------

_ASF = bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c")


def _kind(f, path: str) -> str:
    from . import mpegstream
    head = f.read(1024)
    f.seek(0)
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "mkv"
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide",
                     b"pnot"):
        return "mp4"
    if head[:16] == _ASF:
        return "asf"
    if head[:4] == b"\x00\x00\x01\xba":
        return "ps"
    if mpegstream.is_ts(head):
        return "ts"
    raise ValueError(f"{path}: not an MP4/MOV, AVI or Matroska/WebM file, "
                     "nor ASF or an MPEG program or transport stream")


_READERS = {"mp4": (_mp4, _mp4_track), "avi": (_avi, _avi_stream),
            "mkv": (_mkv, _mkv_track),
            "ps": (_stream(_mpeg_track), _mpeg_track),
            "ts": (_stream(_mpeg_track), _mpeg_track),
            "asf": (_stream(_asf_track), _asf_track)}


def probe(path: str, timestamps: bool = True) -> dict:
    """The first video stream's index (module docstring); without
    ``timestamps`` the ``timestamps_ms`` key is left out, and a track whose
    timestamps cannot be read still gives the rest."""
    with open(path, "rb") as f:
        return _READERS[_kind(f, path)][0](f, path, timestamps)


def meta(path: str) -> dict:
    """``num_frames``, ``fps``, ``width``, ``height`` and ``codec`` of the
    first video stream, as ``probe`` gives the first four; for MPEG program
    and transport streams and ASF from the head and the tail of the file
    alone, as ffmpeg's open reads them, for the other containers from
    their index."""
    with open(path, "rb") as f:
        kind = _kind(f, path)
        if kind in ("ts", "ps"):
            from . import mpegstream
            return mpegstream.meta(f, path)
        if kind == "asf":
            from . import asf
            return _asf_meta(asf.read(f, path, objects=False), path)
        track = _READERS[kind][1](f, path)
    return {k: track[k] for k in ("num_frames", "fps", "width", "height",
                                  "codec")}


def packet_index(path: str) -> dict:
    """The first video stream's packets in decode order (``packets``, a
    list of :class:`Packet`), ``codec`` (``"h264"``, ``"mpeg4"``,
    ``"mjpeg"``, else the fourcc or Matroska CodecID), its ``setup``
    (H.264: ``sps``, ``pps``, ``nal_length_size``; MPEG-4 part 2 in MP4 or
    Matroska: ``vol``), ``time_base`` (s), ``fps``, ``num_frames``,
    ``width`` and ``height``, as ``probe`` reads them; an AVI's and a
    Matroska ``V_MS/VFW/FOURCC`` track's also its ``fourcc``, a Matroska
    track's with content encodings its ``encodings``. In an MPEG program
    or transport stream (``kind`` ``"ps"``, ``"ts"``) a packet is an
    access unit, its offset one in the elementary stream, whose ``chunks``
    map it to the file."""
    with open(path, "rb") as f:
        return _READERS[_kind(f, path)][1](f, path)


def _length_prefixed(sample: bytes, n: int) -> Iterator[bytes]:
    off = 0
    while off + n <= len(sample):
        size = int.from_bytes(sample[off:off + n], "big")
        yield sample[off + n:off + n + size]
        off += n + size


def _annexb(sample: bytes, setup: dict, state: dict) -> bytes:
    """An MP4 H.264 sample as Annex B, as ffmpeg's h264_mp4toannexb writes
    it: a start code before each NAL unit (4 bytes for the first one and
    for parameter sets, else 3), and the ``avcC`` SPS and PPS ahead of the
    first slice of an IDR picture that does not carry them.
    ``state["new_idr"]`` carries over from one sample to the next."""
    sps = b"".join(b"\x00\x00\x00\x01" + x for x in setup["sps"])
    pps = b"".join(b"\x00\x00\x00\x01" + x for x in setup["pps"])
    out = bytearray()
    sps_seen = pps_seen = False
    for nal in _length_prefixed(sample, setup["nal_length_size"]):
        if not nal:
            continue
        kind = nal[0] & 0x1F
        if kind == 7:
            sps_seen = state["new_idr"] = True
        elif kind == 8:
            pps_seen = state["new_idr"] = True
            if not sps_seen:
                out += sps
                sps_seen = True
        if (not state["new_idr"] and kind == 5 and len(nal) > 1
                and nal[1] & 0x80):
            state["new_idr"] = True
        if state["new_idr"] and kind == 5 and not sps_seen and not pps_seen:
            out += sps + pps
            state["new_idr"] = False
        elif state["new_idr"] and kind == 5 and sps_seen and not pps_seen:
            out += pps
        out += (b"\x00\x00\x00\x01" if not out or kind in (7, 8)
                else b"\x00\x00\x01") + nal
        if not state["new_idr"] and kind == 1:
            state["new_idr"] = True
            sps_seen = pps_seen = False
    return bytes(out)


def access_units(path: str, index: dict | None = None, start: int = 0,
                 kept_only: bool = True) -> Iterator[tuple[int, bytes]]:
    """Yield ``(k, unit)`` for the packets of ``index`` (default:
    ``packet_index(path)``) from position ``start`` in decode order, the
    kept ones only unless ``kept_only`` is False: each packet as a decoder
    takes it. H.264 in MP4 becomes Annex B (``_annexb``); MPEG-4 part 2 in
    MP4 gets the ``esds`` VOL header ahead of the first unit; an AVI's
    chunks (whose H.264 is Annex B already, and whose MPEG-4 carries its
    VOL in band) and MJPEG frames are as stored."""
    from . import matroska
    index = index or packet_index(path)
    setup, state = index["setup"], {"new_idr": True}
    first = True
    chunks = index.get("chunks")
    if chunks is not None:
        from .mpegstream import read_es
    with open(path, "rb") as f:
        for k in range(start, len(index["packets"])):
            p = index["packets"][k]
            if kept_only and not p.kept:
                continue
            if chunks is not None:
                unit = read_es(f, chunks, p.offset, p.offset + p.size)
            else:
                f.seek(p.offset)
                unit = f.read(p.size)
            if len(unit) != p.size:
                raise ValueError(f"{path}: packet {k} runs past the end of "
                                 "the file")
            if "encodings" in index:
                unit = matroska.content(unit, index["encodings"])
            if "nal_length_size" in setup:
                unit = _annexb(unit, setup, state)
            elif first and setup.get("vol"):
                unit = setup["vol"] + unit
            first = False
            yield k, unit


def _h264_frames(path: str, index: dict) -> list[tuple[int, int | None]]:
    """``bitstream.h264_output_frames`` in packet positions: (the packet
    of each frame, the packet whose decoding returns it or None at the end
    of the stream), every packet from the first read."""
    ks, units = [], []
    for k, unit in access_units(path, index, kept_only=False):
        ks.append(k)
        units.append(unit)
    return [(ks[i], None if t is None else ks[t])
            for i, t in bitstream.h264_output_frames(units)]


def output_order(path: str, index: dict | None = None) -> list[int]:
    """Positions in ``index["packets"]`` of the kept packets in the order
    a decoder returns their frames: the presentation order that an H.264
    stream's headers give (``data/bitstream.py``; every packet from the
    first is read, since a picture's order count can depend on the ones
    before it). Other codecs raise naming A9 (MPEG-4 part 2's order is
    ``mpeg4.output_frames``'s)."""
    index = index or packet_index(path)
    packets = index["packets"]
    if index["codec"] != "h264":
        raise _unsupported(path, f"the output order of a {index['codec']} "
                           "stream")
    return [k for k, _ in _h264_frames(path, index) if packets[k].kept]
