"""MPEG-4 part 2 frames through the port's own decoder (counterpart of the
cv2 decode behind auformer/data/video.py for MPEG-4 videos).

cv2's FFMPEG capture decodes MPEG-4 part 2 (``mp4v`` in MP4, ``XVID``,
``DIVX``, ``FMP4`` in AVI) with ffmpeg's software ``mpeg4`` decoder on the
host. The port decodes them on the host too, with
``data/native/mpeg4_decode.cpp``, built with the C++ compiler into
``.cache/native`` at first use (``data/native``): its Y, U and V planes
are ffmpeg's bit for bit, and ``ops/colour.py``'s limited-range
``yuv_rgb`` turns them into cv2's RGB frames. That holds for the streams
XviD writes too (its signature "XviD..." in the user data): ffmpeg, and
the decoder, take XviD's inverse DCT for them (``inverse_dct``), and
read their packed B-VOPs and quarter-pel vectors. There is no fallback: a
decoder that does not build, a stream that does not decode and a tool the
decoder refuses (``NotImplementedError`` naming ROADMAP.md queue A9:
interlacing, GMC and sprites, data partitioning, the short video header,
and the streams ffmpeg decodes with an encoder's bug workarounds, such as
XviD builds of 32 and below, a bare XVID fourcc, DivX 4 and quarter-pel
DivX) all raise.

``decode_range(path, index, start_key, stop, device)`` feeds the packets
of ``container.access_units`` from the sync packet ``start_key`` in
decode order and yields ``(k, (y, u, v), colour)`` for each frame the
decoder outputs, in ffmpeg's output order (display order), that comes from a
packet the container keeps (an edit list's leading samples are decoded as
references and dropped, as ffmpeg drops them). The planes land in host
tensors; for a CUDA device in pinned ones, copied to the card on the
current stream. ``colour`` is (matrix_coefficients, video_range) of the
visual object header's video_signal_type ((2, 0) where there is none), as
ffmpeg gives them to the frames and cv2 converts by them (ROADMAP.md C13):
the arguments of ``yuv_rgb``'s ``matrix`` and, negated, ``limited``.

``output_frames(units)`` gives the frames the decoder returns for a
stream's access units, in its order, without their pixels: the same
decoder opened to read each VOP only as far as vop_coded, so that the
frame count (``frame_count``: what a decode loop of cv2's ``grab()``
counts) and the timestamps (``container``) follow the rule the frames
follow. No frame for a VOP of vop_coded 0 or a B-VOP ffmpeg drops, and
the last frame once more where a low-delay stream ends with a VOP of
vop_coded 0. It refuses only what leaves the VOP headers unread (the
short video header, scalable layers), none of the pixel tools. Both read
a packed bitstream (two VOPs in one AVI chunk) as ffmpeg does, and skip
the one-byte chunks XviD's and DivX's codecs store for a frame they hold
back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Iterator

import numpy as np
import torch

from . import container


@functools.cache
def _library() -> ctypes.CDLL:
    from . import native
    lib = ctypes.CDLL(str(native.build("mpeg4")))
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.m4v_open.argtypes = [ctypes.c_char_p, i]
    lib.m4v_open.restype = ptr
    lib.m4v_close.argtypes = [ptr]
    lib.m4v_close.restype = None
    lib.m4v_send.argtypes = [ptr, ctypes.c_char_p, ctypes.c_long, ll, ip,
                             ctypes.c_char_p, i]
    lib.m4v_send.restype = i
    lib.m4v_flush.argtypes = [ptr, ip]
    lib.m4v_flush.restype = i
    lib.m4v_size.argtypes = [ptr, ip, ip]
    lib.m4v_size.restype = i
    lib.m4v_receive.argtypes = [ptr, ptr, i, ptr, ptr, i,
                                ctypes.POINTER(ll), ctypes.POINTER(ll)]
    lib.m4v_receive.restype = i
    lib.m4v_low_delay.argtypes = [ptr]
    lib.m4v_low_delay.restype = i
    lib.m4v_colour.argtypes = [ptr, ip, ip]
    lib.m4v_colour.restype = None
    lib.m4v_idct.argtypes = [i, ptr, ptr]
    lib.m4v_idct.restype = None
    return lib


def inverse_dct(coefs, xvid: bool):
    """The decoder's inverse DCT of an 8x8 block of int16 coefficients in
    raster order (a numpy array), before clipping: XviD's, which it uses
    for a stream with XviD's signature, or ffmpeg's simple one."""
    block = np.ascontiguousarray(coefs, dtype=np.int16).reshape(64)
    out = np.empty(64, np.int32)
    _library().m4v_idct(int(xvid), block.ctypes.data, out.ctypes.data)
    return out.reshape(8, 8)


class Decoder:
    """One stream's decoder state (``mpeg4_decode.cpp``): ``send`` an
    access unit, then ``receive`` each frame it made ready. With
    ``headers_only`` it decodes no pixels: ``receive_tag`` instead."""

    def __init__(self, fourcc: str = "", headers_only: bool = False):
        self._h = None
        self._lib = _library()
        self._h = self._lib.m4v_open(fourcc.encode("latin-1")[:4],
                                     int(headers_only))
        if not self._h:
            raise MemoryError("the MPEG-4 decoder did not open")
        self._err = ctypes.create_string_buffer(512)

    def send(self, unit: bytes, tag: int) -> int:
        """Decode one access unit; returns the frames now ready (0 or 1).
        Raises ValueError on a malformed stream and NotImplementedError,
        naming A9, on a tool the decoder refuses."""
        ready = ctypes.c_int()
        rc = self._lib.m4v_send(self._h, unit, len(unit), tag,
                                ctypes.byref(ready), self._err, 512)
        if rc == 2:
            raise NotImplementedError(self._err.value.decode())
        if rc:
            raise ValueError(f"MPEG-4 decode: {self._err.value.decode()}")
        return ready.value

    def flush(self) -> int:
        """End of stream: the frames still held (0 or 1)."""
        ready = ctypes.c_int()
        self._lib.m4v_flush(self._h, ctypes.byref(ready))
        return ready.value

    def size(self) -> tuple[int, int]:
        """(height, width) of the stream's frames."""
        w, h = ctypes.c_int(), ctypes.c_int()
        if self._lib.m4v_size(self._h, ctypes.byref(w), ctypes.byref(h)):
            raise ValueError("MPEG-4 decode: no VOL header yet")
        return h.value, w.value

    def receive(self, y: torch.Tensor, u: torch.Tensor,
                v: torch.Tensor) -> int:
        """Copy the ready frame into host planes (row-contiguous uint8
        tensors of ``planes_shape``); returns the tag of its unit."""
        return self._receive(y.data_ptr(), y.stride(0), u.data_ptr(),
                             v.data_ptr(), u.stride(0))[0]

    def receive_tag(self) -> tuple[int, int]:
        """(the tag of the ready frame's unit, the tag of the unit whose
        packet properties it carries), without its planes."""
        return self._receive(None, 0, None, None, 0)

    def _receive(self, y, y_pitch, u, v, c_pitch) -> tuple[int, int]:
        tag, props = ctypes.c_longlong(), ctypes.c_longlong()
        if self._lib.m4v_receive(self._h, y, y_pitch, u, v, c_pitch,
                                 ctypes.byref(tag), ctypes.byref(props)):
            raise RuntimeError("MPEG-4 decode: no frame is ready")
        return tag.value, props.value

    def low_delay(self) -> bool:
        """Whether the stream returns each VOP when it is decoded."""
        return bool(self._lib.m4v_low_delay(self._h))

    def colour(self) -> tuple[int, int]:
        """(matrix_coefficients, video_range) the frames carry."""
        m, r = ctypes.c_int(), ctypes.c_int()
        self._lib.m4v_colour(self._h, ctypes.byref(m), ctypes.byref(r))
        return m.value, r.value

    def close(self) -> None:
        if self._h:
            self._lib.m4v_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def planes_shape(height: int, width: int, chroma: int = 1
                 ) -> tuple[tuple, tuple]:
    """Shapes of a frame's Y and of its U and V planes for the chroma
    format ``chroma``: 1 4:2:0 (MPEG-4 part 2's; and H.264's monochrome,
    whose planes are 128), 2 4:2:2, 3 4:4:4."""
    ch = height if chroma > 1 else (height + 1) // 2
    cw = width if chroma == 3 else (width + 1) // 2
    return (height, width), (ch, cw)


class Staging:
    """Pinned host planes in turn for the copies to a CUDA device: a set
    is written again only once its last copy has finished. ``dtype``: the
    samples' tensor type (uint8, or int16 for H.264's deeper samples)."""

    def __init__(self, height: int, width: int, n: int = 3, chroma: int = 1,
                 dtype: torch.dtype = torch.uint8):
        ys, cs = planes_shape(height, width, chroma)
        self.sets = [tuple(torch.empty(s, dtype=dtype, pin_memory=True)
                           for s in (ys, cs, cs)) for _ in range(n)]
        self.events: list = [None] * n
        self.at = 0

    def take(self):
        k = self.at
        self.at = (k + 1) % len(self.sets)
        if self.events[k] is not None:
            self.events[k].synchronize()
        return k, self.sets[k]

    def upload(self, k: int, device: torch.device):
        out = tuple(p.to(device, non_blocking=True) for p in self.sets[k])
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self.events[k] = event
        return out


def decode_range(path: str, index: dict | None = None, start_key: int = 0,
                 stop: int | None = None, device="cpu"
                 ) -> Iterator[tuple[int, tuple, tuple[int, int]]]:
    """Yield ``(k, (y, u, v), colour)`` for the frames decoded from the sync
    packet ``start_key`` (module docstring), at most ``stop`` of them; the
    planes on ``device``."""
    index = index or container.packet_index(path)
    if index["codec"] != "mpeg4":
        raise ValueError(f"{path}: a {index['codec']} stream, not MPEG-4 "
                         "part 2")
    packets = index["packets"]
    if start_key and not packets[start_key].sync:
        raise ValueError(f"{path}: packet {start_key} is not a sync packet")
    device = torch.device(device)
    on_card = device.type == "cuda"
    dec = Decoder(index.get("fourcc", ""))
    staging, shown = None, 0

    def frame():
        nonlocal staging
        h, w = dec.size()
        if on_card:
            if staging is None:
                staging = Staging(h, w)
            k, planes = staging.take()
            tag = dec.receive(*planes)
            return tag, (lambda: staging.upload(k, device))
        ys, cs = planes_shape(h, w)
        planes = tuple(torch.empty(s, dtype=torch.uint8) for s in (ys, cs,
                                                                    cs))
        tag = dec.receive(*planes)
        return tag, (lambda: planes)

    try:
        for k, unit in container.access_units(path, index, start_key,
                                              kept_only=False):
            if dec.send(unit, k):
                tag, planes = frame()
                if packets[tag].kept:
                    yield tag, planes(), dec.colour()
                    shown += 1
                    if stop is not None and shown >= stop:
                        return
        if dec.flush():
            tag, planes = frame()
            if packets[tag].kept:
                yield tag, planes(), dec.colour()
    finally:
        dec.close()


def _returned(dec: Decoder, units) -> Iterator[tuple[int, int, int | None]]:
    """The frames ``dec`` (a headers-only decoder) returns for ``units`` as
    ``output_frames`` lists them, each as soon as it is returned."""
    for k, unit in enumerate(units):
        if dec.send(unit, k):
            yield dec.receive_tag() + (k,)
    if dec.flush():
        yield dec.receive_tag() + (None,)


def output_frames(units) -> tuple[list[tuple[int, int, int | None]], bool]:
    """The frames the decoder returns for ``units`` (MPEG-4 part 2 access
    units in decode order), in the order it returns them (module
    docstring), and whether the stream is low delay. A frame is (position
    of its unit, position of the unit whose packet properties ffmpeg gives
    it: its own, but the last unit's for a frame returned at the end after
    a VOP of vop_coded 0, position of the unit whose decoding returned it
    or None at the end of the stream)."""
    dec = Decoder(headers_only=True)
    try:
        return list(_returned(dec, units)), dec.low_delay()
    finally:
        dec.close()


def first_returned(units) -> tuple[int | None, bool]:
    """(the position in ``units`` of the unit whose decoding returns the
    first frame, or None where only the end of the stream returns one;
    whether the stream is low delay so far), reading ``units`` only as far
    as that unit (``output_frames``)."""
    dec = Decoder(headers_only=True)
    try:
        first = next(_returned(dec, units), None)
        return (None if first is None else first[2]), dec.low_delay()
    finally:
        dec.close()


def frame_count(units, kept=None) -> int:
    """The frames a decode loop returns for ``units`` (``output_frames``),
    counting only those of the units that ``kept`` (a flag per unit)
    marks, where it is given."""
    return sum(1 for k, _, _ in output_frames(units)[0]
               if kept is None or kept[k])
