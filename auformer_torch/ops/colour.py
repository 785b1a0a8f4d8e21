"""YUV -> RGB conversion of decoded video frames (``csrc/yuv_rgb.cu``).

The JAX package reads frames through cv2, whose FFMPEG capture converts
each decoded frame with swscale to BGR24 and then to RGB: full-range
planes (MJPEG's yuvj420p and yuvj422p, and a video stream that says it is
full range) as they are, a video decoder's limited-range planes (MPEG-4
part 2, H.264) with luma offset 16 and wider coefficients
(``limited=True``); the chroma coefficients from the row of swscale's
ff_yuv2rgb_coeffs that the stream's colour matrix selects (``matrix``: the
matrix_coefficients of H.264's VUI or of MPEG-4 part 2's colour
description; BT.601 where there is none: ``coefficients``). swscale takes
one of two routes by the chroma layout:

  4:2:0, 4:2:2   its unscaled yuv2rgb converter: nearest chroma, 16-bit
                 fixed point (a monochrome H.264 stream's frames come as
                 4:2:0 planes whose chroma is 128, and go this way too);
  4:4:4          chroma that is not subsampled makes swscale interpolate
                 chroma in full (SWS_FULL_CHR_H_INT) and leave the unscaled
                 converter for its scaler at scale 1 and yuv2rgb_write_full:
                 30-bit fixed point with rounding, whose 32-bit sums wrap
                 before the clip (``full_chroma``).

``yuv_rgb_plain`` is that arithmetic in PyTorch, bit for bit on every (Y,
U, V) input that the tests sweep (tests/test_torch_video_decode.py,
tests/test_torch_video_mpeg4.py, tests/test_torch_video_h264.py,
tests/test_torch_video_h264_chroma.py); ``yuv_rgb`` takes it for CPU planes
and launches the CUDA kernel for CUDA ones.

The planes: ``y`` (H, W); ``u`` and ``v`` (ceil(H / 2) or H, ceil(W / 2) or
W: 4:2:0, 4:2:2 or 4:4:4), each a 2-D uint8 view whose rows may be pitched
but whose columns are contiguous; ``u`` and ``v`` share their strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import check, library

# swscale's luma term (ff_yuv2rgb_c_init_tables: yCoeff, yOffset): full
# range (8 Y * 8192) >> 16, which is Y itself; limited range, the offset
# 16: ((8 Y - 128) * 9539) >> 16
LIMITED_CY = 9539

# swscale's ff_yuv2rgb_coeffs rows (crv, cbu, -cgu, -cgv in 16.16) by the
# matrix_coefficients value that cv2 passes to sws_getCoefficients, which
# takes BT.601's row for every value it does not list
_SWS_ROWS = {1: (117489, 138438, 13975, 34925),     # BT.709
             4: (104448, 132798, 24759, 53109),     # FCC
             7: (117579, 136230, 16907, 35559),     # SMPTE 240M
             9: (110013, 140363, 12277, 42626),     # BT.2020 NCL
             10: (110013, 140363, 12277, 42626)}    # BT.2020 CL
_BT601_ROW = (104597, 132201, 25675, 53279)


def coefficients(matrix: int = 2, limited: bool = True
                 ) -> tuple[int, int, int, int]:
    """(crv, cgu, cgv, cbu) of the conversion for a stream's
    matrix_coefficients: ff_yuv2rgb_c_init_tables' 13-bit rounding of the
    row, (c * 8192 + 32768) >> 16, each first scaled by 224 / 255
    (truncated) for full range. BT.601 gives (11485, -2819, -5850, 14516)
    in full range and (13075, -3209, -6660, 16525) in limited range."""
    crv, cbu, cgu, cgv = _SWS_ROWS.get(int(matrix), _BT601_ROW)
    row = (crv, -cgu, -cgv, cbu)
    if not limited:     # C's division, truncated toward zero
        row = tuple((abs(c) * 224 // 255) * (1 if c >= 0 else -1)
                    for c in row)
    return tuple((c * 8192 + 32768) >> 16 for c in row)


def _check_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> tuple[int, int]:
    """The chroma's vertical and horizontal shifts ((1, 1) for 4:2:0, (0,
    1) for 4:2:2, (0, 0) for 4:4:4); raises on planes that do not fit each
    other."""
    for p in (y, u, v):
        if p.dtype != torch.uint8 or p.dim() != 2:
            raise ValueError(f"yuv_rgb: 2-D uint8 planes, not {p.dtype} "
                             f"{tuple(p.shape)}")
        if p.stride(1) != 1:
            raise ValueError("yuv_rgb: each plane's columns must be "
                             "contiguous")
    h, w = y.shape
    if h < 1 or w < 1:
        raise ValueError(f"yuv_rgb: an empty {h}x{w} frame")
    if u.shape != v.shape or u.stride() != v.stride():
        raise ValueError("yuv_rgb: U and V must share their shape and "
                         "strides")
    for shifts in ((1, 1), (0, 1), (0, 0)):
        if u.shape == (-(-h >> shifts[0]), -(-w >> shifts[1])):
            return shifts
    raise ValueError(f"yuv_rgb: chroma {tuple(u.shape)} is not 4:2:0, "
                     f"4:2:2 or 4:4:4 of a {h}x{w} frame")


def full_chroma(y: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
                limited: bool, crv: int, cgu: int, cgv: int, cbu: int
                ) -> torch.Tensor:
    """swscale's yuv2rgb_write_full on samples that its scaler carried at
    scale 1 (Y << 9, (U - 128) << 9): the luma coefficient and offset of
    ff_yuv2rgb_c_init_tables (9539 and 16 << 9 limited, 8192 and 0 full),
    the rounding 1 << 21, each sum as its 32 bits hold it (the C code adds
    in unsigned arithmetic, and a wrapped sum clips to 0), >> 22."""
    cy, oy = (LIMITED_CY, 16 << 9) if limited else (8192, 0)
    yt = (y.to(torch.int64) * 512 - oy) * cy + (1 << 21)
    u9 = (cu.to(torch.int64) - 128) * 512
    v9 = (cv.to(torch.int64) - 128) * 512

    def out(x):
        x = ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        return (x >> 22).clamp_(0, 255)

    return torch.stack([out(yt + v9 * crv), out(yt + v9 * cgv + u9 * cgu),
                        out(yt + u9 * cbu)], -1).to(torch.uint8)


def yuv_rgb_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  limited: bool = False, matrix: int = 2) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the planes, as cv2 converts them: full range
    (a JPEG's), or limited range with ``limited`` and the colour matrix
    ``matrix``, by the route of the planes' chroma layout (module
    docstring)."""
    v_shift, h_shift = _check_planes(y, u, v)
    h, w = y.shape
    crv, cgu, cgv, cbu = coefficients(matrix, limited)
    if not h_shift:
        return full_chroma(y, u, v, limited, crv, cgu, cgv, cbu)
    rows = torch.arange(h, device=y.device) >> v_shift
    cols = torch.arange(w, device=y.device) >> h_shift
    cu = u.to(torch.int32)[rows][:, cols] * 8 - 1024
    cv = v.to(torch.int32)[rows][:, cols] * 8 - 1024
    yt = y.to(torch.int32)
    if limited:
        yt = ((yt * 8 - 128) * LIMITED_CY) >> 16
    r = yt + ((cv * crv) >> 16)
    g = yt + ((cu * cgu) >> 16) + ((cv * cgv) >> 16)
    b = yt + ((cu * cbu) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("yuv_rgb")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.yuv_rgb.argtypes = [ptr, i, ptr, ptr, i, i, i, i, i, i, i, i, i,
                            i, ptr, ptr]
    lib.yuv_rgb.restype = ctypes.c_int
    return lib


def yuv_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            limited: bool = False, matrix: int = 2) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the planes (module docstring), full or
    ``limited`` range with the colour ``matrix``: ``yuv_rgb_plain`` for CPU
    planes, the kernel on the current stream for CUDA ones (or an error).
    ``yuv_rgb.launches`` counts kernel launches."""
    v_shift, h_shift = _check_planes(y, u, v)
    if all(p.device.type == "cpu" for p in (y, u, v)):
        return yuv_rgb_plain(y, u, v, limited, matrix)
    if not (y.device.type == "cuda" and u.device == y.device
            and v.device == y.device):
        raise ValueError(f"yuv_rgb: planes on {y.device}, {u.device}, "
                         f"{v.device}")
    h, w = y.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    crv, cgu, cgv, cbu = coefficients(matrix, limited)
    with torch.cuda.device(y.device):
        err = _library().yuv_rgb(y.data_ptr(), y.stride(0), u.data_ptr(),
                                 v.data_ptr(), u.stride(0), v_shift, h_shift,
                                 h, w, int(limited), crv, cgu, cgv, cbu,
                                 out.data_ptr(), stream)
    check(err, "yuv_rgb kernel")
    yuv_rgb.launches += 1
    return out


yuv_rgb.launches = 0
