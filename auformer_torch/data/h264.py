"""H.264 frames through the port's own decoder (counterpart of the cv2
decode behind auformer/data/video.py for H.264 videos).

cv2's FFMPEG capture decodes H.264 (``avc1`` in MP4, ``H264`` and its
fourccs in AVI) with ffmpeg's software ``h264`` decoder on the host. The
port decodes them on the host too, with ``data/native/h264_decode.cpp``,
built with the C++ compiler into ``.cache/native`` at first use
(``data/native``): streams of frame pictures with CAVLC or CABAC
entropy coding (the Baseline, Main, High, High 10, High 4:2:2 and High
4:4:4 Predictive profiles) and any scaling lists, in every chroma format
(4:2:0, 4:2:2, 4:4:4 and monochrome) at 8 bits and at the deeper ones
libavcodec decodes (9, 10, 12 and 14 bits, luma and chroma alike), and
lossless (transform bypass); progressive, or for 4:2:0 interlaced too
(MBAFF frames, as x264's ``--interlaced`` writes them); their Y, U and V
planes are ffmpeg's bit for bit: chroma planes of the stream's chroma size
(``planes_shape``), a monochrome stream's as ffmpeg puts them out, 4:2:0
planes of 1 << (bit depth - 1); uint8 planes for 8-bit streams, int16 ones
holding the samples as they are for deeper ones (no shift to 8 bits: that
belongs to the colour conversion, as in swscale). An interlaced frame
comes out as ffmpeg outputs it, its two fields woven and not
deinterlaced. ``ops/colour.py``'s ``yuv_rgb``, with the range, the colour
matrix the stream's VUI names and the bit depth (``Colour``), turns them
into cv2's RGB frames. There is no fallback: a decoder that does not
build, a stream that does not decode and a tool the decoder refuses (field
pictures, 11 and 13 bits, luma and chroma depths apart and the rest:
``NotImplementedError`` naming ROADMAP.md queue A9) all raise; NVDEC is
not tried. ``cabac_tables``, ``cavlc_tables`` and
``Decoder.counts`` / ``scaling_lists`` read the decoder's tables and
state for tests.

``decode_range(path, index, start_key, stop, device)`` feeds the packets
of ``container.access_units`` from the sync packet ``start_key`` in
decode order and yields ``(k, (y, u, v), colour)`` for each frame the
decoder outputs, in ffmpeg's output order (picture order count order,
``bitstream.h264_output_order``), that comes from a packet the container
keeps: an edit list's leading samples are decoded as references and
dropped, as ffmpeg drops them. ``colour`` is a ``Colour``:
(matrix_coefficients, video_full_range_flag) of the SPS's VUI ((2, 0)
where it gives none), the arguments of ``yuv_rgb``'s ``matrix`` and,
negated, ``limited``, with the samples' ``bit_depth`` and the chroma
siting, ``chroma_loc``, beside. The planes
land in host tensors; for a CUDA device in pinned ones, copied to the
card on the current stream.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator

import torch

from . import container
from .mpeg4 import Staging, planes_shape


@functools.cache
def _library() -> ctypes.CDLL:
    from . import native
    lib = ctypes.CDLL(str(native.build("h264")))
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.h264_open.argtypes = []
    lib.h264_open.restype = ptr
    lib.h264_close.argtypes = [ptr]
    lib.h264_close.restype = None
    lib.h264_send.argtypes = [ptr, ctypes.c_char_p, ctypes.c_long, ll, ip,
                              ctypes.c_char_p, i]
    lib.h264_send.restype = i
    lib.h264_flush.argtypes = [ptr, ip, ctypes.c_char_p, i]
    lib.h264_flush.restype = i
    lib.h264_size.argtypes = [ptr, ip, ip, ip, ip]
    lib.h264_size.restype = i
    lib.h264_chroma.argtypes = [ptr]
    lib.h264_chroma.restype = i
    lib.h264_depth.argtypes = [ptr]
    lib.h264_depth.restype = i
    lib.h264_chroma_loc.argtypes = [ptr]
    lib.h264_chroma_loc.restype = i
    lib.h264_receive.argtypes = [ptr, ptr, i, ptr, ptr, i,
                                 ctypes.POINTER(ll)]
    lib.h264_receive.restype = i
    lib.h264_counts.argtypes = [ptr, ctypes.POINTER(ll)]
    lib.h264_counts.restype = None
    lib.h264_scaling.argtypes = [ptr, ptr, ptr]
    lib.h264_scaling.restype = None
    lib.h264_cabac_tables.argtypes = [ptr] * 5
    lib.h264_cabac_tables.restype = None
    lib.h264_cabac_init_444.argtypes = [ptr]
    lib.h264_cabac_init_444.restype = None
    lib.h264_cavlc_tables.argtypes = [ptr]
    lib.h264_cavlc_tables.restype = None
    return lib


class Colour(tuple):
    """A frame's (matrix_coefficients, video_full_range_flag), the pair
    that ``yuv_rgb`` takes as ``matrix`` and ``not limited``, with its
    samples' ``bit_depth`` (8 to 14) and its ``chroma_loc`` (the chroma
    siting as libavcodec reports it: ``Decoder.chroma_loc``) as
    attributes, which ``yuv_rgb`` takes too: it equals the pair, so that
    a caller that reads two values reads them as before."""

    def __new__(cls, matrix: int, full_range: int, bit_depth: int = 8,
                chroma_loc: int = 1):
        out = super().__new__(cls, (matrix, full_range))
        out.bit_depth, out.chroma_loc = bit_depth, chroma_loc
        return out


def cabac_tables() -> dict:
    """The decoder's CABAC tables (``h264_cabac_tables``): ``init`` (4, 460,
    2) int8, the (m, n) of ctxIdx 0-459 for cabac_init_idc 0, 1, 2 and I
    slices; ``range_lps`` (64, 4) uint8, rangeTabLPS; ``trans`` (2, 64),
    transIdxLPS and transIdxMPS; ``ctx8x8`` (2, 63), the 8x8 block's frame
    ctxIdxInc of significant_coeff_flag and last_significant_coeff_flag;
    ``ctx8x8_field`` (63,), a field macroblock's of significant_coeff_flag
    (its last_significant_coeff_flag takes the frame one's); ``defaults``
    the four default scaling lists in raster order (4x4 intra and inter,
    8x8 intra and inter); ``init_444`` (4, 564, 2), the (m, n) of ctxIdx
    460-1023, the Cb and Cr contexts of 4:4:4 streams."""
    import numpy as np
    init_444 = np.zeros((4, 564, 2), np.int8)
    _library().h264_cabac_init_444(init_444.ctypes.data)
    out = {"init": np.zeros((4, 460, 2), np.int8),
           "range_lps": np.zeros((64, 4), np.uint8),
           "trans": np.zeros((2, 64), np.uint8),
           "ctx8x8": np.zeros((3, 63), np.uint8),
           "defaults": np.zeros(160, np.uint8)}
    _library().h264_cabac_tables(*(a.ctypes.data for a in out.values()))
    d = out.pop("defaults")
    out["defaults"] = (d[:16], d[16:32], d[32:96], d[96:])
    out["ctx8x8"], out["ctx8x8_field"] = out["ctx8x8"][:2], out["ctx8x8"][2]
    out["init_444"] = init_444
    return out


def cavlc_tables() -> dict:
    """The decoder's CAVLC tables of the chroma formats other than 4:2:0
    (``h264_cavlc_tables``): ``cbp_gray`` (2, 16) uint8, Table 9-4's
    coded_block_pattern by codeNum for ChromaArrayType 0 and 3, Intra_4x4 /
    Intra_8x8 then Inter; ``dc422_token`` (2, 9, 4), the length and code
    of Table 9-5's nC == -2 coeff_token by TotalCoeff and TrailingOnes
    (length 0 where there is none); ``dc422_zeros`` (2, 7, 8), of Table
    9-9 (b)'s total_zeros by TotalCoeff 1-7 and total_zeros."""
    import numpy as np
    raw = np.zeros(216, np.uint8)
    _library().h264_cavlc_tables(raw.ctypes.data)
    return {"cbp_gray": raw[:32].reshape(2, 16),
            "dc422_token": raw[32:104].reshape(2, 9, 4),
            "dc422_zeros": raw[104:].reshape(2, 7, 8)}


class Decoder:
    """One stream's decoder state (``h264_decode.cpp``): ``send`` an access
    unit, then ``receive`` each frame it made ready."""

    def __init__(self):
        self._h = None
        self._lib = _library()
        self._h = self._lib.h264_open()
        if not self._h:
            raise MemoryError("the H.264 decoder did not open")
        self._err = ctypes.create_string_buffer(512)

    def _check(self, rc: int) -> None:
        if rc == 2:
            raise NotImplementedError(self._err.value.decode())
        if rc:
            raise ValueError(f"H.264 decode: {self._err.value.decode()}")

    def send(self, unit: bytes, tag: int) -> int:
        """Decode one access unit; returns the frames now ready. Raises
        ValueError on a malformed stream and NotImplementedError, naming
        A9, on a tool the decoder refuses."""
        ready = ctypes.c_int()
        self._check(self._lib.h264_send(self._h, unit, len(unit), tag,
                                        ctypes.byref(ready), self._err, 512))
        return ready.value

    def flush(self) -> int:
        """End of stream: the frames still held."""
        ready = ctypes.c_int()
        self._check(self._lib.h264_flush(self._h, ctypes.byref(ready),
                                         self._err, 512))
        return ready.value

    def size(self) -> tuple[int, int, tuple[int, int]]:
        """(height, width, (matrix_coefficients, video_full_range_flag)) of
        the next ready frame."""
        w, h = ctypes.c_int(), ctypes.c_int()
        m, r = ctypes.c_int(), ctypes.c_int()
        if self._lib.h264_size(self._h, ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(m), ctypes.byref(r)):
            raise RuntimeError("H.264 decode: no frame is ready")
        return h.value, w.value, (m.value, r.value)

    def depth(self) -> int:
        """The next ready frame's bit depth: 8, or 9, 10, 12 or 14."""
        d = self._lib.h264_depth(self._h)
        if not d:
            raise RuntimeError("H.264 decode: no frame is ready")
        return d

    def chroma_loc(self) -> int:
        """The next ready frame's chroma siting as libavcodec reports it
        (AVChromaLocation): 0 unspecified (an SPS without a VUI), 1 left
        (a VUI without chroma_loc_info), else 1 +
        chroma_sample_loc_type_top_field."""
        loc = self._lib.h264_chroma_loc(self._h)
        if loc < 0:
            raise RuntimeError("H.264 decode: no frame is ready")
        return loc

    def chroma(self) -> int:
        """The next ready frame's chroma format as ``planes_shape`` takes
        it."""
        c = self._lib.h264_chroma(self._h)
        if not c:
            raise RuntimeError("H.264 decode: no frame is ready")
        return c

    def receive(self, y: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> int:
        """Copy the ready frame into host planes (row-contiguous tensors of
        ``planes_shape``, uint8 at 8 bits, int16 deeper); returns the tag
        of its unit."""
        tag = ctypes.c_longlong()
        if self._lib.h264_receive(self._h, y.data_ptr(), y.stride(0),
                                  u.data_ptr(), v.data_ptr(), u.stride(0),
                                  ctypes.byref(tag)):
            raise RuntimeError("H.264 decode: no frame is ready")
        return tag.value

    def counts(self) -> dict:
        """What the decoder has seen so far: slices, CABAC slices, I_PCM
        macroblocks, slices with scaling lists, and the macroblock pairs of
        MBAFF frames coded as fields and as frames."""
        out = (ctypes.c_longlong * 6)()
        self._lib.h264_counts(self._h, out)
        return dict(zip(("slices", "cabac_slices", "pcm_macroblocks",
                         "scaled_slices", "field_pairs", "frame_pairs"),
                        out))

    def scaling_lists(self) -> tuple:
        """The last slice's scaling lists in force, raster order: (6, 16)
        uint8, Intra Y, Cb, Cr and Inter Y, Cb, Cr 4x4, and (6, 64), Intra
        Y, Inter Y, Intra Cb, Inter Cb, Intra Cr and Inter Cr 8x8 (the
        chroma ones used by 4:4:4 streams only)."""
        import numpy as np
        w4, w8 = np.zeros((6, 16), np.uint8), np.zeros((6, 64), np.uint8)
        self._lib.h264_scaling(self._h, w4.ctypes.data, w8.ctypes.data)
        return w4, w8

    def close(self) -> None:
        if self._h:
            self._lib.h264_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def decode_range(path: str, index: dict | None = None, start_key: int = 0,
                 stop: int | None = None, device="cpu"
                 ) -> Iterator[tuple[int, tuple, tuple[int, int]]]:
    """Yield ``(k, (y, u, v), colour)`` for the frames decoded from the sync
    packet ``start_key`` (module docstring), at most ``stop`` of them; the
    planes on ``device``."""
    index = index or container.packet_index(path)
    if index["codec"] != "h264":
        raise ValueError(f"{path}: a {index['codec']} stream, not H.264")
    packets = index["packets"]
    if start_key and not packets[start_key].sync:
        raise ValueError(f"{path}: packet {start_key} is not a sync packet")
    device = torch.device(device)
    on_card = device.type == "cuda"
    dec = Decoder()
    staging: dict = {}
    shown = 0

    def frame():
        h, w, (matrix, full) = dec.size()
        chroma, depth = dec.chroma(), dec.depth()
        # int16 holds the deeper samples (at most 14 bits) as they are
        colour = Colour(matrix, full, depth, dec.chroma_loc())
        dtype = torch.uint8 if depth == 8 else torch.int16
        ys, cs = planes_shape(h, w, chroma)
        if on_card:
            st = staging.get((h, w, chroma, dtype))
            if st is None:
                st = staging[(h, w, chroma, dtype)] = Staging(
                    h, w, chroma=chroma, dtype=dtype)
            k, planes = st.take()
            tag = dec.receive(*planes)
            return tag, (lambda: st.upload(k, device)), colour
        planes = tuple(torch.empty(s, dtype=dtype) for s in (ys, cs, cs))
        tag = dec.receive(*planes)
        return tag, (lambda: planes), colour

    try:
        def drain(n):
            nonlocal shown
            for _ in range(n):
                tag, planes, colour = frame()
                if packets[tag].kept:
                    yield tag, planes(), colour
                    shown += 1
                    if stop is not None and shown >= stop:
                        return

        for k, unit in container.access_units(path, index, start_key,
                                              kept_only=False):
            yield from drain(dec.send(unit, k))
            if stop is not None and shown >= stop:
                return
        yield from drain(dec.flush())
    finally:
        dec.close()
