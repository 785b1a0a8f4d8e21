"""H.264 frames through the port's own decoder (counterpart of the cv2
decode behind auformer/data/video.py for H.264 videos).

cv2's FFMPEG capture decodes H.264 (``avc1`` in MP4, ``H264`` and its
fourccs in AVI) with ffmpeg's software ``h264`` decoder on the host. The
port decodes them on the host too, with ``data/native/h264_decode.cpp``,
built with the C++ compiler into ``.cache/native`` at first use
(``data/native``): progressive 8-bit 4:2:0 streams with CAVLC entropy
coding and flat scaling, whose Y, U and V planes are ffmpeg's bit for bit.
``ops/colour.py``'s ``yuv_rgb``, with the range and the colour matrix the
stream's VUI names, turns them into cv2's RGB frames. There is no
fallback: a decoder that does not build, a stream that does not decode and
a tool the decoder refuses (CABAC, scaling matrices, field pictures and the
rest: ``NotImplementedError`` naming ROADMAP.md queue A9) all raise; NVDEC
is not tried.

``decode_range(path, index, start_key, stop, device)`` feeds the packets
of ``container.access_units`` from the sync packet ``start_key`` in
decode order and yields ``(k, (y, u, v), colour)`` for each frame the
decoder outputs, in ffmpeg's output order (picture order count order,
``bitstream.h264_output_order``), that comes from a packet the container
keeps: an edit list's leading samples are decoded as references and
dropped, as ffmpeg drops them. ``colour`` is (matrix_coefficients,
video_full_range_flag) of the SPS's VUI ((2, 0) where it gives none): the
arguments of ``yuv_rgb``'s ``matrix`` and, negated, ``limited``. The
planes land in host
tensors; for a CUDA device in pinned ones, copied to the card on the
current stream.
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
    lib.h264_receive.argtypes = [ptr, ptr, i, ptr, ptr, i,
                                 ctypes.POINTER(ll)]
    lib.h264_receive.restype = i
    return lib


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

    def receive(self, y: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> int:
        """Copy the ready frame into host planes (row-contiguous uint8
        tensors of ``planes_shape``); returns the tag of its unit."""
        tag = ctypes.c_longlong()
        if self._lib.h264_receive(self._h, y.data_ptr(), y.stride(0),
                                  u.data_ptr(), v.data_ptr(), u.stride(0),
                                  ctypes.byref(tag)):
            raise RuntimeError("H.264 decode: no frame is ready")
        return tag.value

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
        h, w, colour = dec.size()
        if on_card:
            st = staging.get((h, w))
            if st is None:
                st = staging[(h, w)] = Staging(h, w)
            k, planes = st.take()
            tag = dec.receive(*planes)
            return tag, (lambda: st.upload(k, device)), colour
        ys, cs = planes_shape(h, w)
        planes = tuple(torch.empty(s, dtype=torch.uint8) for s in (ys, cs,
                                                                    cs))
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
