"""A video's frame index read from its container, without a decoder (the
JAX package asks cv2's FFMPEG backend, auformer/data/video.py:30-48).

``probe(path)`` gives what cv2 reports of the first video stream:
``num_frames`` (``CAP_PROP_FRAME_COUNT``), ``fps`` (``CAP_PROP_FPS``),
``width``, ``height``, ``packets`` (the frames a decode loop of ``grab()``
returns) and ``timestamps_ms`` (``CAP_PROP_POS_MSEC`` after each
``grab()``). cv2 computes them from ffmpeg's demuxer state; the rules below
follow ffmpeg's code and were each held against cv2 on files written by
cv2 and then edited box by box (tests/test_torch_video_ingest.py):

  ``num_frames``  ``AVStream.nb_frames``: for MP4/MOV the sum of the
                  ``stts`` run counts (``mov_read_stts``), for AVI the
                  stream header's ``dwLength`` (``avi_read_header``). An
                  edit list does not change it.
  ``fps``         ``AVStream.avg_frame_rate``, which cv2 reads in place of
                  ``av_guess_frame_rate``: for MP4/MOV the sample count
                  times the ``mdhd`` timescale over the sum of the ``stts``
                  durations (``mov_read_trak``), for AVI
                  ``dwRate / dwScale``; 1 / time base where that is zero.
  timestamps      ``(pts - start_time) * time_base * 1000`` in f64
                  (``dts_to_sec`` of cv2's ffmpeg backend). MP4/MOV: the
                  time base is 1 / timescale; the pts are the ``stts``
                  running sums; an edit list (``mov_fix_index``) keeps the
                  samples whose time lies in [media_time, media_time +
                  segment duration in the media timescale), leading empty
                  edits delay them all, and ``start_time`` is the first
                  kept sample's pts, so both shifts cancel. AVI: the time
                  base is dwScale / dwRate, frame k of the stream's chunks
                  has pts ``dwStart + k``, and ``start_time`` is 0.
  ``packets``     the kept samples (MP4) or the stream's chunks in every
                  ``movi`` list, through OpenDML's ``AVIX`` parts (AVI),
                  that hold data: an empty one decodes to no frame.

The edit window compares each sample's presentation time (decode time
plus its ``ctts`` offset), as ``mov_fix_index`` does: on a track with
reordering offsets it keeps the samples cv2 returns
(tests/data/videos/ctts_reorder.mp4 and ctts_cut.mp4).

What raises ``NotImplementedError`` naming ROADMAP.md queue A9: the
timestamps of an MP4 track with ``ctts`` (B-frames: cv2 reports them in
the order its decoder returns the frames, which only a decoder knows; its
count, fps and size still read), an edit list of more
than one media edit or a rate other than 1, fragmented MP4 (``moof``),
and Matroska/WebM. A file that is none of these formats raises
ValueError.
"""
from __future__ import annotations

import struct

_A9 = "ROADMAP.md queue A9 (offline ingest from videos)"
_MP4_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts"}


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


def _top_level_mp4(f, path: str) -> bytes:
    """The ``moov`` body of the file, read box header by box header (an
    ``mdat`` before or after it is skipped, 64-bit and to-the-end sizes
    included); fragmented files raise."""
    f.seek(0, 2)
    size_of_file = f.tell()
    off, moov = 0, None
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
        if kind == b"moof":
            raise _unsupported(path, "a fragmented MP4 (moof)")
        if kind == b"moov":
            moov = f.read(size - head)
        off += size
    if moov is None:
        raise ValueError(f"{path}: an MP4 without a moov box")
    return moov


def _video_trak(moov: dict, path: str) -> dict:
    for trak in moov.get(b"trak", []):
        mdia = trak.get(b"mdia", [{}])[0]
        hdlr = mdia.get(b"hdlr", [b""])[0]
        if hdlr[8:12] == b"vide":
            return trak
    raise ValueError(f"{path}: no video track")


def _mp4(f, path: str, timestamps: bool) -> dict:
    moov = _tree(_top_level_mp4(f, path))
    if b"mvex" in moov:
        raise _unsupported(path, "a fragmented MP4 (mvex)")
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
    fps = (num_frames * scale / duration if num_frames and duration
           else float(scale))
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
    lo, hi = _edit_window(trak, movie_scale, scale, path)
    kept = [k for k in range(len(sizes))
            if lo <= cts[k] < hi and sizes[k] > 0]
    out = {"num_frames": num_frames, "fps": fps, "width": width,
           "height": height, "packets": len(kept)}
    if timestamps:
        if b"ctts" in stbl:
            raise _unsupported(path, "the presentation order of a track "
                                     "with composition offsets (ctts)")
        tb = 1 / scale
        first = cts[kept[0]] if kept else 0
        out["timestamps_ms"] = [(cts[k] - first) * tb * 1000.0
                                for k in kept]
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


def _avi(f, path: str, timestamps: bool) -> dict:
    f.seek(0, 2)
    size_of_file = f.tell()
    stream = strh = strf = None
    movis = []
    for fourcc, data, size, kind in _chunks(f, 0, size_of_file):
        if fourcc != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            continue
        end = min(data + size, size_of_file)
        for c4, d, s, k in _chunks(f, data + 4, end):
            if c4 == b"LIST" and k == b"movi":
                movis.append((d + 4, min(d + s, end)))
            elif c4 == b"LIST" and k == b"hdrl" and stream is None:
                stream, strh, strf = _avi_video_stream(f, d + 4, d + s, path)
    if stream is None:
        raise ValueError(f"{path}: an AVI without a video stream")
    scale, rate, start, length = struct.unpack("<IIII", strh[20:36])
    if not (scale and rate):
        scale, rate = 1, 25          # avi_read_header's fallback
    width, height = struct.unpack("<ii", strf[4:12])
    ids = (f"{stream:02d}dc".encode(), f"{stream:02d}db".encode())
    frames = []                       # each chunk's size, empty ones too
    pending = list(movis)
    while pending:
        lo, hi = pending.pop(0)
        for c4, d, s, k in _chunks(f, lo, hi):
            if c4 == b"LIST" and k == b"rec ":
                pending.insert(0, (d + 4, d + s))
            elif c4 in ids:
                frames.append(s)
    out = {"num_frames": length, "fps": rate / scale, "width": width,
           "height": abs(height), "packets": sum(s > 0 for s in frames)}
    if timestamps:
        tb = scale / rate
        out["timestamps_ms"] = [(start + k) * tb * 1000.0
                                for k, s in enumerate(frames) if s > 0]
    return out


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

def probe(path: str, timestamps: bool = True) -> dict:
    """The first video stream's index (module docstring); without
    ``timestamps`` the ``timestamps_ms`` key is left out, and a track whose
    timestamps cannot be read still gives the rest."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] == b"\x1a\x45\xdf\xa3":
            raise _unsupported(path, "a Matroska/WebM file")
        if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
            return _avi(f, path, timestamps)
        if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"skip",
                         b"wide", b"pnot"):
            return _mp4(f, path, timestamps)
    raise ValueError(f"{path}: not an MP4/MOV or AVI file")
