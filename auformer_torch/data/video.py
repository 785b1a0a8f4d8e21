"""A video file's frame count, rate and size, and its frames (counterpart
of auformer/data/video.py; reference dataloader/video.py:14-94).

``Video(path).meta`` loads the ``<video.ext>meta.json`` side cache, or the
legacy ``<video>meta.json``, else probes the container (``container.meta``)
and, with ``write``, saves the cache as ``<video>meta.json``, where the JAX
package saves it (tests/test_ingest.py checks that name). The keys and the
``fps or 30.0`` rule are the JAX package's; the meta comes from
``data/container.py``, with no video decoder, for MP4/MOV (fragmented
too), AVI and Matroska/WebM (``data/matroska.py``) from their index, and
for ASF (``data/asf.py``) and MPEG program and transport streams
(``data/mpegstream.py``) from the head and the tail of the file, as
ffmpeg's open reads them; a file of VP9, AV1, HEVC, MPEG-1/2 video or
WMV/VC-1 gives its meta and nothing more.

Frames (``read_RGB``, ``frames``, ``frame_tensors``) come out on the card
unless the caller passes ``device="cpu"``, for three codecs in AVI, MP4
(fragmented too), Matroska/WebM, ASF and MPEG program and transport
streams:

  MJPEG          each frame's JPEG goes to its Y, Cb and Cr planes
                 (nvJPEG in the card's memory for a CUDA device, libjpeg on
                 the host for the CPU, each raising where its library is
                 missing: ``data/native``); a frame differs from the JAX
                 package's cv2 frame only where the two decoders' inverse
                 DCTs round apart.
  MPEG-4 part 2  the port's own software decoder (``data/mpeg4.py``)
                 decodes on the host, as cv2's ffmpeg does, to planes equal
                 to ffmpeg's bit for bit (XviD's streams with XviD's
                 inverse DCT, packed B-VOPs and quarter-pel among them);
                 the frames in ffmpeg's output order, the planes copied to
                 the card for a CUDA device.
  H.264          the port's own software decoder (``data/h264.py``: CAVLC
                 and CABAC, any scaling lists, 4:2:0, 4:2:2, 4:4:4 and
                 monochrome at 8 bits and at 9, 10, 12 and 14 (High 10,
                 High 4:2:2, High 4:4:4: int16 planes), lossless;
                 progressive, and MBAFF for 4:2:0) the same way.

``ops/colour.py``'s ``yuv_rgb`` converts the planes as cv2's swscale does
(full range for a JPEG's; for MPEG-4's and H.264's, the range and
matrix_coefficients that the stream's headers give: the visual object's
video_signal_type, the SPS's VUI; limited range BT.601 where they give
none; swscale's full-chroma route for 4:4:4 planes, and its scaler's
route for H.264 planes deeper than 8 bits, with the bit depth the SPS
gives), on the card with its kernel for a CUDA device, from every entry
point. NVDEC, the card's video decoder, is refused by the container the
card runs in (``data/nvdec.py``) and is not tried. JPEG frames that are
not 4:2:0 or 4:2:2, and the MPEG-4 and H.264 tools the decoders refuse
(MPEG-4's interlacing, GMC and the streams ffmpeg decodes with an
encoder's bug workarounds, such as XviD builds of 32 and below; H.264's
field pictures, bit depths of 11 and 13 and the rest), raise naming
ROADMAP.md queue A9, as do other codecs.

``read_RGB(k)`` seeks as cv2's ``CAP_PROP_POS_FRAMES`` does for MPEG-4 and
H.264: from the sync packet at or before the display position 16 frames
before ``k``, counting the frames the decoder returns from the number cv2
gives the first one (``_seek_key``). Where no MPEG-4 VOP with vop_coded 0
lies between them, that is ``frames()``'s frame ``k``. In an MPEG program
or transport stream ffmpeg's seek is a binary search on DTS that can land
on a packet that is not a key frame, and ffmpeg's decoder returns nothing
before the next one; in ASF it goes by the Simple Index; cv2 then numbers
the first frame by its timestamp and seeks again from further back where
that lies past ``k`` (``_stream_seek``: read_RGB(0) of a B-pyramid stream
in a transport stream is frame 12, as cv2 gives it). Where cv2 knows no
frame count (a live Matroska or broadcast ASF file's) it does not seek:
``read_RGB(k)`` reads on, as cv2 does after flushing its decoder.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Iterator

import numpy as np
import torch

from . import container, h264, mpeg4

_A9 = "ROADMAP.md queue A9 (frame decoding)"
_SEEK_BACK = 16      # cv2's seek: from 16 frames before the one asked for


def decode_mjpeg_frame(unit: bytes, device: torch.device) -> torch.Tensor:
    """One MJPEG frame as an (H, W, 3) uint8 RGB tensor on ``device``, as
    cv2 converts it (module docstring). On a CUDA device nvJPEG decodes the
    planes into its memory on its current stream; on the CPU libjpeg
    decodes them on the host. Either raises where its library is
    missing."""
    from . import native
    from ..ops.colour import yuv_rgb
    on_card = device.type == "cuda"
    name = "nvjpeg" if on_card else "libjpeg"
    with torch.cuda.device(device) if on_card else contextlib.nullcontext():
        h, w, layout = native.jpeg_info(unit, name)
        if layout not in (420, 422):
            raise NotImplementedError(
                f"a JPEG frame of chroma layout {layout or 'other'}: only "
                "4:2:0 and 4:2:2 are converted as cv2 converts them; "
                f"{_A9} lists the rest")
        ch = (h + 1) // 2 if layout == 420 else h
        y = torch.empty((h, w), dtype=torch.uint8, device=device)
        cb = torch.empty((ch, (w + 1) // 2), dtype=torch.uint8,
                         device=device)
        cr = torch.empty_like(cb)
        native.decode_jpeg_yuv(
            unit, y.data_ptr(), cb.data_ptr(), cr.data_ptr(), h, w, layout,
            torch.cuda.current_stream(device).cuda_stream if on_card
            else None, name)
        return yuv_rgb(y, cb, cr)


def _resolve_device(device) -> torch.device:
    from ..infer import resolve_device   # not at import: infer is heavy
    return resolve_device(device)


class Video:
    def __init__(self, path: str, write: bool = True):
        self.path = path
        self.filename = os.path.splitext(os.path.basename(path))[0]
        self.meta = self._load_or_probe_meta(write)
        self._next = 0
        self._session = None
        self._read_to = 0

    def _meta_path(self) -> str:
        # the reference's cache name keeps the extension: <video.mp4>meta.json
        return self.path + "meta.json"

    def _load_or_probe_meta(self, write: bool) -> dict:
        legacy = os.path.splitext(self.path)[0] + "meta.json"
        for mp in (self._meta_path(), legacy):
            if os.path.isfile(mp):
                with open(mp) as f:
                    return json.load(f)
        index = container.meta(self.path)
        meta = {"num_frames": int(index["num_frames"]),
                "fps": float(index["fps"]) or 30.0,
                "width": int(index["width"]),
                "height": int(index["height"])}
        meta["duration"] = (meta["num_frames"] / meta["fps"]
                            if meta["fps"] else 0.0)
        if write:
            with open(legacy, "w") as f:
                json.dump(meta, f)
        return meta

    @property
    def num_frames(self) -> int:
        return self.meta["num_frames"]

    @property
    def fps(self) -> float:
        return self.meta["fps"]

    def count_frames(self) -> int:
        """What a decode loop of cv2's ``grab()`` returns. MJPEG, H.264 and
        the rest: the video packets of the container's index that hold data
        (the samples an edit list keeps, or the stream's AVI chunks), which
        is the count where each packet decodes to one frame. MPEG-4 part
        2: the frames its decoder returns, from the VOP headers
        (``mpeg4.frame_count``): a VOP with vop_coded 0 returns none, and
        at the end of a low-delay stream the last frame once more
        (ROADMAP.md C12). Other codecs raise naming A9, as ``frames`` does:
        what cv2 counts is what its decoder returns (none for AV1, which
        cv2's ffmpeg does not decode; a WebM VP8 stream's hidden frames
        are packets of their own)."""
        index, kept = self._decodable
        if index["codec"] != "mpeg4":
            return len(kept)
        units = [u for _, u in container.access_units(self.path, index,
                                                      kept_only=False)]
        return mpeg4.frame_count(units, [p.kept for p in index["packets"]])

    @functools.cached_property
    def _decodable(self) -> tuple[dict, list[int]]:
        """(the packet index, the positions of its kept packets: the frames
        in display order), parsed once per ``Video``; raises for a codec
        the port does not decode."""
        index = container.packet_index(self.path)
        if index["codec"] not in ("mjpeg", "mpeg4", "h264"):
            raise NotImplementedError(
                f"decoding the {index['codec']} frames of {self.path} needs "
                "a software decoder of the port's own, which auformer_torch "
                "has for MJPEG, MPEG-4 part 2 and H.264 only (in MP4, AVI, "
                "Matroska/WebM, ASF and MPEG program and transport "
                "streams; not MPEG-1/2 video, WMV/VC-1, HEVC, VP9 or AV1), "
                "and the card's NVDEC is refused by its container: "
                f"{_A9} lists it")
        return index, [k for k, p in enumerate(index["packets"]) if p.kept]

    def frame_tensors(self, device=None) -> Iterator[torch.Tensor]:
        """Every frame in display order as an (H, W, 3) uint8 RGB tensor on
        ``device`` (default the GPU)."""
        index, _ = self._decodable
        device = _resolve_device(device)
        if index["codec"] in _SOFTWARE:
            return _planes_rgb(_SOFTWARE[index["codec"]](self.path, index,
                                                         device=device))
        return (decode_mjpeg_frame(unit, device)
                for _, unit in container.access_units(self.path, index))

    def frames(self, device=None) -> Iterator[np.ndarray]:
        """Every frame in display order as (H, W, 3) uint8 RGB, as the JAX
        package's ``frames()`` gives them; decoded on ``device``."""
        return (t.cpu().numpy() for t in self.frame_tensors(device))

    def read_RGB(self, frame_idx: int | None = None,
                 device=None) -> np.ndarray | None:
        """Frame ``frame_idx`` (cv2's seek to ``CAP_PROP_POS_FRAMES`` and
        ``read``), or with None the frame after the one read last (cv2's
        ``read``), as (H, W, 3) uint8 RGB; None past the last frame. Every
        MJPEG frame is a sync sample, so frame k decodes from its own
        packet; MPEG-4 and H.264 seek as the module docstring says."""
        index, kept = self._decodable
        device = _resolve_device(device)
        if index["codec"] in _SOFTWARE:
            return self._read_decoded(index, frame_idx, device)
        k = self._next if frame_idx is None else int(frame_idx)
        if k < 0:
            raise ValueError(f"read_RGB: frame {k} of {self.path}")
        if index["num_frames"] < 1:       # cv2 does not seek: it reads on
            k = self._next
        if k >= len(kept):
            self._next = len(kept)
            return None
        self._next = k + 1
        _, unit = next(container.access_units(self.path, index, kept[k]))
        return decode_mjpeg_frame(unit, device).cpu().numpy()

    def _read_decoded(self, index: dict, frame_idx, device):
        """cv2's seek and read on an MPEG-4 or H.264 stream: a decode from
        the sync packet of ``_seek_key`` that stays open for the reads
        after it; the frames passed over are not converted. Where cv2
        knows no frame count (``num_frames`` below 1, a live Matroska
        file's) it does not seek: it flushes its decoder and reads on from
        the packet after those it has read (``_read_on``)."""
        if frame_idx is not None or self._session is None:
            k = 0 if frame_idx is None else int(frame_idx)
            if k < 0:
                raise ValueError(f"read_RGB: frame {k} of {self.path}")
            self._close_session()
            if index["num_frames"] < 1:
                key, skip = self._read_on(index), 0
                if key is None:
                    return None
            elif index.get("kind") in ("ts", "ps", "asf"):
                key, skip = _stream_seek(index, k, self.path)
            else:
                key, skip = _seek_key(index, min(k, index["num_frames"]),
                                      self.path)
            # a seek that finds no sync packet after it decodes nothing
            self._session = _SOFTWARE[index["codec"]](
                self.path, index, key, device=device) if key < len(
                    index["packets"]) else (x for x in ())
            if index["num_frames"] < 1:
                self._session = self._reading_on(self._session, index, key)
            for _ in range(skip):
                if next(self._session, None) is None:
                    break
        frame = next(self._session, None)
        return None if frame is None else _rgb(frame).cpu().numpy()

    def _read_on(self, index: dict) -> int | None:
        """The packet cv2's H.264 decoder returns a frame of first after a
        flush: the first sync packet from the one after those it has read
        (after a flush ffmpeg's decoder drops the pictures before the next
        key frame); None past the last. An MPEG-4 decoder flushed mid
        stream decodes its next VOPs from a grey picture, which the port
        does not follow."""
        if self._read_to and index["codec"] != "h264":
            raise NotImplementedError(
                f"{self.path}: cv2 does not seek in a file whose frame count "
                f"it does not know, and flushes its {index['codec']} decoder "
                f"mid stream; {_A9} lists following it")
        packets = index["packets"]
        return next((j for j in range(self._read_to, len(packets))
                     if packets[j].sync and packets[j].kept), None)

    def _reading_on(self, session, index: dict, key: int):
        """``session``'s frames, keeping ``_read_to``, the packets cv2's
        demuxer has handed out when each is returned: those up to the one
        whose decoding returns it (``bitstream.h264_output_frames``)."""
        from . import bitstream
        triggers = None
        try:
            for j, frame in enumerate(session):
                if triggers is None and index["codec"] != "h264":
                    triggers = []           # _read_on refuses to go on
                elif triggers is None:      # once the stream decodes
                    units = (u for _, u in container.access_units(
                        self.path, index, key, kept_only=False))
                    triggers = [t for _, t in
                                bitstream.h264_output_frames(units)]
                t = triggers[j] if j < len(triggers) else None
                self._read_to = (len(index["packets"]) if t is None
                                 else key + t + 1)
                yield frame
        finally:
            session.close()

    def _close_session(self) -> None:
        if self._session is not None:
            self._session.close()
            self._session = None

    def release(self) -> None:
        """Back to the first frame, closing an open MPEG-4 or H.264
        decode."""
        self._next = 0
        self._read_to = 0
        self._close_session()


# the codecs the port's host decoders read: decode_range by codec
_SOFTWARE = {"mpeg4": mpeg4.decode_range, "h264": h264.decode_range}


def _rgb(frame) -> torch.Tensor:
    """The RGB frame of a host decoder's ``(k, planes, colour)``, converted
    with the stream's colour matrix and range, and its samples' bit depth
    and chroma siting (an H.264 ``Colour``'s; MPEG-4 part 2's are 8-bit)."""
    from ..ops.colour import yuv_rgb
    _, (y, u, v), colour = frame
    matrix, full_range = colour
    return yuv_rgb(y, u, v, limited=not full_range, matrix=matrix,
                   bit_depth=getattr(colour, "bit_depth", 8),
                   chroma_loc=getattr(colour, "chroma_loc", 1))


def _planes_rgb(planes) -> Iterator[torch.Tensor]:
    """RGB frames of a host decoder's ``decode_range``."""
    try:
        for frame in planes:
            yield _rgb(frame)
    finally:
        planes.close()


def _seek_key(index: dict, k: int, path: str | None = None
              ) -> tuple[int, int]:
    """(sync packet, frames to pass over) of cv2's seek to frame ``k``
    (cap_ffmpeg_impl.hpp ``seek``): ffmpeg seeks back from the display
    position ``k - 16`` to a sync packet, and cv2 numbers the first frame
    it decodes there by its timestamp (``dts_to_frame_number``) less the
    first frame's of the file, then counts the frames it reads. That is
    the sync VOP's display position, but for an MPEG-4 part 2 stream in
    AVI that is not low delay (``path`` given), whose frames carry the
    decode time of the chunk whose decoding returned them (``container``):
    there it is that chunk's position less the one that returned the
    file's first frame (a packed stream drops the B-VOPs packed with the
    sync VOP after a seek, so the two differ)."""
    packets = index["packets"]
    kept = [p.pts for p in packets if p.kept]
    if not kept:
        return 0, k
    fps, tb, start = index["fps"], index["time_base"], min(kept)

    def position(p) -> int:             # cv2's dts_to_frame_number
        return int(fps * (p.pts - start) * tb + 0.5)

    target = max(k - _SEEK_BACK, 0)
    key = 0
    for j, p in enumerate(packets):
        if p.sync and position(p) <= target and position(p) >= position(
                packets[key]):
            key = j
    # the first frame out of a closed GOP is its sync VOP's
    first = max(position(packets[key]), 0)
    if key and path is not None and index["codec"] == "mpeg4" \
            and "fourcc" in index:
        def units(start: int):
            return (u for _, u in container.access_units(
                path, index, start, kept_only=False))
        returned, low_delay = mpeg4.first_returned(units(key))
        file_first, _ = mpeg4.first_returned(units(0))
        if not low_delay and returned is not None and file_first is not None:
            first = (position(packets[key + returned])
                     - position(packets[file_first]))
    return key, k - first


def _number(index: dict, key: int, path: str) -> int:
    """cv2's ``dts_to_frame_number`` of the first frame ffmpeg's decoder
    returns from the sync packet ``key``: its PTS less the stream's start,
    in frames, where it has a PTS other than 0; else the DTS of the packet
    whose decoding returns it (an MPEG-4 part 2 stream's, low delay: its
    own), far below 0 where that has none."""
    import itertools
    from . import bitstream
    packets = index["packets"]
    t = packets[key].pts
    if not t:
        if index["codec"] == "mpeg4":
            t = packets[key].dts
        else:
            units = (u for _, u in container.access_units(
                path, index, key, kept_only=False))
            frames = bitstream.h264_output_frames(itertools.islice(units, 40))
            trigger = frames[0][1] if frames else None
            t = None if trigger is None else packets[key + trigger].dts
    if t is None:
        return -(1 << 62)
    return int(index["fps"] * (t - index["start_time"])
               * index["time_base"] + 0.5)


def _landing(index: dict, ts: int, path: str) -> int:
    """The first packet ffmpeg reads after ``av_seek_frame`` to ``ts`` in
    an MPEG program or transport stream: ``ff_gen_search``'s binary search
    on the demuxer's ``read_timestamp`` finds the last PES packet (program
    stream) or the last access unit that took a PES's times (transport
    stream) whose DTS (its PTS where it has none) is at or before ``ts``,
    and reading goes on from that PES; the result is the position of the
    first access unit that begins in it or after it."""
    packets = index["packets"]
    if index["kind"] == "asf":
        return _asf_landing(index, ts)
    if index.get("wraps_down"):
        # the file starts within 60 s of 2^33, so its times count down
        # past the wrap (mpegstream.Wrap): cv2's seeks to a time before the
        # wrap return to the first packet (held on the tests' writer's
        # files); past it, the port does not follow them
        if ts >= 0:
            raise NotImplementedError(
                f"{path}: cv2's seek past the 2^33 wrap of a file "
                f"whose times start before it; {_A9} lists following it")
        return 0
    def stamp(x) -> int | None:
        return x.dts if x.dts is not None else x.pts

    if index["kind"] == "ps":
        starts = [x.start for x in index["pes"]
                  if stamp(x) is not None and stamp(x) <= ts]
    else:
        pes_at = {x.pos: x.start for x in index["pes"]}
        starts = [pes_at[pos] for p, pos in zip(packets, index["unit_pos"])
                  if pos >= 0 and stamp(p) is not None and stamp(p) <= ts]
    start = starts[-1] if starts else 0
    return next((j for j, p in enumerate(packets) if p.offset >= start),
                len(packets))


def _asf_landing(index: dict, ts: int) -> int:
    """The first media object ffmpeg's ``asf_read_seek`` reads after a seek
    to ``ts`` (ms): the first of the file for 0; else the first that
    begins in or after the data packet of the Simple Index's last entry at
    or before ``ts`` (entry i at i x interval less the preroll, 0 at
    least; an entry at the packet of the one before is not added, one at
    the time of the one before replaces it); without an index (ffmpeg's
    binary search on the key frames' times) the last key object at or
    before ``ts``."""
    packets = index["packets"]
    if ts == 0:
        return 0
    if index["simple_index"] is None:
        return max([j for j, p in enumerate(packets)
                    if p.sync and p.pts <= ts] or [0])
    interval, entries = index["simple_index"]
    table: list[list[int]] = []
    for i, number in enumerate(entries):
        if table and number == table[-1][1]:
            continue
        t = max((interval * i + 5000) // 10000 - index["preroll"], 0)
        if table and table[-1][0] == t:
            table[-1][1] = number
        else:
            table.append([t, number])
    found = [number for t, number in table if t <= ts]
    if not found:
        return max([j for j, p in enumerate(packets)
                    if p.sync and p.pts <= ts] or [0])
    return next((j for j, at in enumerate(index["object_packet"])
                 if at >= found[-1]), len(packets))


def _stream_seek(index: dict, k: int, path: str) -> tuple[int, int]:
    """(sync packet, frames to pass over) of cv2's seek to frame ``k`` in
    an MPEG program or transport stream or an ASF file
    (cap_ffmpeg_impl.hpp ``seek``):
    from the display position 16 frames before ``k`` (more, where the
    first frame decoded lies past ``k - 1``), ``av_seek_frame`` lands on
    the packet of ``_landing``, ffmpeg's decoder returns nothing before
    the first sync packet from there, and cv2 numbers that frame by its
    timestamp."""
    packets = index["packets"]
    k = min(k, index["num_frames"])
    tb, fps = index["time_base"], index["fps"]
    first = _number(index, 0, path) if packets else 0
    delta = 16
    while True:
        t = max(k - delta, 0)
        ts = index["start_time"] + int(t / fps / tb + 0.5)
        land = _landing(index, ts, path)
        key = next((j for j in range(land, len(packets))
                    if packets[j].sync), None)
        if key is None:
            return len(packets), 0
        if k <= 1:
            return key, k
        n = _number(index, key, path) - first
        if 0 <= n <= k - 1:
            return key, k - n
        if t == 0:
            return key, 1
        delta = delta * 2 if delta < 16 else delta * 3 // 2
