"""YUV -> RGB conversion of decoded video frames (``csrc/yuv_rgb.cu``).

The JAX package reads frames through cv2, whose FFMPEG capture converts
each decoded frame with swscale's yuv2rgb (BT.601, nearest chroma, 16-bit
fixed point) to BGR24 and then to RGB: a JPEG's full-range 4:2:0 or 4:2:2
planes (yuvj420p, yuvj422p: MJPEG) as they are, a video decoder's
limited-range yuv420p planes (MPEG-4 part 2, H.264) with luma offset 16
and wider coefficients (``limited=True``). ``yuv_rgb_plain`` is that
arithmetic in PyTorch, bit for bit on every (Y, U, V) input that the tests
sweep (tests/test_torch_video_decode.py, tests/test_torch_video_mpeg4.py);
``yuv_rgb`` takes it for CPU planes and launches the CUDA kernel for CUDA
ones.

The planes: ``y`` (H, W); ``u`` and ``v`` (ceil(H / 2) or H, ceil(W / 2)),
each a 2-D uint8 view whose rows may be pitched but whose columns are
contiguous; ``u`` and ``v`` share their strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import check, library

# swscale's 13-bit full-range BT.601 coefficients (ff_yuv2rgb_c_init_tables:
# vrCoeff, ugCoeff, vgCoeff, ubCoeff); its luma term, (8 Y * 8192) >> 16
# with yCoeff 8192 and no offset, is Y itself
CRV, CGU, CGV, CBU = 11485, -2819, -5850, 14516
# and its limited-range (MPEG) ones: luma ((8 Y - 128) * 9539) >> 16
LIMITED_CY, LIMITED_CRV, LIMITED_CGU, LIMITED_CGV, LIMITED_CBU = (
    9539, 13075, -3209, -6660, 16525)


def _check_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> int:
    """The chroma's vertical shift (1 for 4:2:0, 0 for 4:2:2); raises on
    planes that do not fit each other."""
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
    if u.shape == ((h + 1) // 2, (w + 1) // 2):
        return 1
    if u.shape == (h, (w + 1) // 2):
        return 0
    raise ValueError(f"yuv_rgb: chroma {tuple(u.shape)} is neither 4:2:0 "
                     f"nor 4:2:2 of a {h}x{w} frame")


def yuv_rgb_plain(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  limited: bool = False) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the planes, as cv2 converts them: full range
    (a JPEG's), or limited range with ``limited``."""
    shift = _check_planes(y, u, v)
    h, w = y.shape
    rows = torch.arange(h, device=y.device) >> shift
    cols = torch.arange(w, device=y.device) >> 1
    cu = u.to(torch.int32)[rows][:, cols] * 8 - 1024
    cv = v.to(torch.int32)[rows][:, cols] * 8 - 1024
    yt = y.to(torch.int32)
    crv, cgu, cgv, cbu = CRV, CGU, CGV, CBU
    if limited:
        yt = ((yt * 8 - 128) * LIMITED_CY) >> 16
        crv, cgu, cgv, cbu = (LIMITED_CRV, LIMITED_CGU, LIMITED_CGV,
                              LIMITED_CBU)
    r = yt + ((cv * crv) >> 16)
    g = yt + ((cu * cgu) >> 16) + ((cv * cgv) >> 16)
    b = yt + ((cu * cbu) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = library("yuv_rgb")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.yuv_rgb.argtypes = [ptr, i, ptr, ptr, i, i, i, i, i, ptr, ptr]
    lib.yuv_rgb.restype = ctypes.c_int
    return lib


def yuv_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            limited: bool = False) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of the planes (module docstring), full or
    ``limited`` range: ``yuv_rgb_plain`` for CPU planes, the kernel on the
    current stream for CUDA ones (or an error). ``yuv_rgb.launches``
    counts kernel launches."""
    shift = _check_planes(y, u, v)
    if all(p.device.type == "cpu" for p in (y, u, v)):
        return yuv_rgb_plain(y, u, v, limited)
    if not (y.device.type == "cuda" and u.device == y.device
            and v.device == y.device):
        raise ValueError(f"yuv_rgb: planes on {y.device}, {u.device}, "
                         f"{v.device}")
    h, w = y.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = _library().yuv_rgb(y.data_ptr(), y.stride(0), u.data_ptr(),
                                 v.data_ptr(), u.stride(0), shift, h, w,
                                 int(limited), out.data_ptr(), stream)
    check(err, "yuv_rgb kernel")
    yuv_rgb.launches += 1
    return out


yuv_rgb.launches = 0
