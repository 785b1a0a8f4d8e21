"""The card's NVDEC video decoder capabilities (``data/native/nvdec.cpp``).

``caps(codec)`` is what the driver's ``cuvidGetDecoderCaps`` reports for
``"h264"`` or ``"mpeg4"`` (part 2) in 8-bit 4:2:0, or a RuntimeError with
the CUresult it returned. The port decodes those codecs only where NVDEC
answers; on the H100 machines this repository is measured on, the container
grants no video capability and the call returns CUDA_ERROR_OUT_OF_MEMORY
(ROADMAP.md queue A9). chip_smoke.py's decode line records the answer.
"""
from __future__ import annotations

import ctypes
import functools

# cudaVideoCodec (nvcuvid_api.h)
CODECS = {"mpeg4": 2, "h264": 4}
CAPS_KEYS = ("supported", "nvdecs", "output_formats", "max_width",
             "max_height", "max_macroblocks", "min_width", "min_height")


@functools.cache
def _library() -> ctypes.CDLL:
    from . import native
    lib = ctypes.CDLL(str(native.build("nvdec")))
    lib.nvdec_caps.argtypes = [ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_uint),
                               ctypes.c_char_p, ctypes.c_int]
    lib.nvdec_caps.restype = ctypes.c_int
    return lib


def caps(codec: str, device: int = 0) -> dict:
    """The card's caps for ``codec`` in 8-bit 4:2:0 (``CAPS_KEYS``;
    ``output_formats`` bit k is cudaVideoSurfaceFormat k, bit 0 NV12)."""
    if codec not in CODECS:
        raise ValueError(f"NVDEC caps: no codec {codec!r}")
    out = (ctypes.c_uint * 8)()
    err = ctypes.create_string_buffer(512)
    if _library().nvdec_caps(device, CODECS[codec], out, err, 512) != 0:
        raise RuntimeError(err.value.decode())
    return dict(zip(CAPS_KEYS, list(out)))
