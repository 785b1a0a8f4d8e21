"""ctypes binding + on-demand build of the native FrameStore reader
(counterpart of auformer/data/native) and of the port's zstd decoder.

Two sources share one C interface (``fs_open``, ``fs_close``,
``fs_num_entries``, ``fs_get_raw``, ``fs_decode_batch``,
``fs_encode_jpeg``, ``fs_decode_jpeg``; ``framestore.h`` holds the store
format both mmap):

  ``framestore_reader.cpp``  libjpeg, decode on a host thread pool
  ``framestore_nvjpeg.cpp``  nvJPEG from the CUDA toolkit, decode and
                             encode on the card

:func:`decoder` chooses by the library that is found: libjpeg when its
header is (``jpeglib.h`` preprocesses with the C++ compiler), else nvJPEG
when the CUDA toolkit holds ``nvjpeg.h``; with neither it raises. The chosen
source is compiled with ``g++`` at first use into ``.cache/native`` at the
root of the checkout, the library named by a hash of the sources and the
command. A failed build raises with the compiler's output: nothing falls
back to another decoder or to black frames. Nothing here runs at import
time.

``zstd_decode.cpp`` is a second library, built the same way: the port's own
RFC 8878 decoder, with the CRC-32C that OCDBT files carry, for the JAX
package's orbax checkpoints (``core/ocdbt.py``, ``core/orbax_reader.py``).
It needs only the C++ compiler; there is no fallback to a Python package or
to a system libzstd.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..framestore import first_key

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / ".cache" / "native"
SOURCES = {"libjpeg": "framestore_reader.cpp",
           "nvjpeg": "framestore_nvjpeg.cpp",
           "zstd": "zstd_decode.cpp"}
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def cuda_home() -> Path | None:
    """The CUDA toolkit: ``CUDA_HOME``/``CUDA_PATH``, else the directory
    above ``nvcc`` on PATH, else ``/usr/local/cuda``; None where none of
    them holds ``include/nvjpeg.h``."""
    nvcc = shutil.which("nvcc")
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 nvcc and str(Path(nvcc).resolve().parents[1]),
                 "/usr/local/cuda"):
        if cand and Path(cand, "include", "nvjpeg.h").is_file():
            return Path(cand)
    return None


def _has_libjpeg() -> bool:
    """Whether ``jpeglib.h`` preprocesses with the C++ compiler."""
    try:
        r = subprocess.run([_cxx(), "-E", "-x", "c++", "-", "-o", os.devnull],
                           input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return r.returncode == 0


@functools.lru_cache(maxsize=None)
def decoder() -> str:
    """``"libjpeg"`` or ``"nvjpeg"``: the JPEG library found on this host
    (libjpeg first). Raises RuntimeError when neither is found."""
    if _has_libjpeg():
        return "libjpeg"
    if cuda_home() is not None:
        return "nvjpeg"
    raise RuntimeError(
        "no JPEG decoder: neither libjpeg's jpeglib.h (for "
        f"{_cxx()}) nor the CUDA toolkit's nvjpeg.h was found")


def _command(name: str, target: Path) -> list[str]:
    cmd = [_cxx(), *CXX_FLAGS, str(SRC_DIR / SOURCES[name]), "-o",
           str(target)]
    if name == "zstd":
        return cmd
    if name == "libjpeg":
        return cmd + ["-ljpeg"]
    cuda = cuda_home()
    lib = cuda / "lib64"
    return cmd + [f"-I{cuda / 'include'}", f"-L{lib}", f"-Wl,-rpath,{lib}",
                  "-lnvjpeg", "-lcudart"]


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, framestore.h (for
    a reader) and the compiler command."""
    h = hashlib.sha256((SRC_DIR / SOURCES[name]).read_bytes())
    if name != "zstd":
        h.update((SRC_DIR / "framestore.h").read_bytes())
    h.update(" ".join(_command(name, Path("lib.so"))).encode())
    stem = "libzstd_decode" if name == "zstd" else f"libframestore_{name}"
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _what(name: str) -> str:
    return ("the zstd decoder" if name == "zstd"
            else f"the {name} FrameStore reader")


def build(name: str | None = None) -> Path:
    """Compile the reader for ``name`` (default: :func:`decoder`; ``"zstd"``
    the zstd decoder) unless it is built; returns the library's path.
    Raises RuntimeError with the compiler's output when the build fails."""
    name = name or decoder()
    target = _target(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a unique temporary name and rename: atomic against
    # concurrent builders (test workers, the decode worker)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(_command(name, tmp), capture_output=True,
                           text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{_what(name)} did not build: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{_what(name)} did not build "
                           f"({' '.join(_command(name, tmp))}):\n"
                           f"{r.stderr[-4000:]}")
    os.replace(tmp, target)
    return target


def library(name: str | None = None) -> ctypes.CDLL:
    """The loaded reader for ``name`` (default: :func:`decoder`), built
    on first use, with every function's argument and result types set."""
    name = name or decoder()
    target = _target(name)
    with _lock:
        lib = _LIBS.get(target)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(name)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fs_open.restype = ctypes.c_void_p
        lib.fs_open.argtypes = [ctypes.c_char_p]
        lib.fs_close.restype = None
        lib.fs_close.argtypes = [ctypes.c_void_p]
        lib.fs_num_entries.restype = ctypes.c_long
        lib.fs_num_entries.argtypes = [ctypes.c_void_p]
        lib.fs_get_raw.restype = ctypes.c_int
        lib.fs_get_raw.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(u8p),
                                   ctypes.POINTER(ctypes.c_long)]
        lib.fs_decode_batch.restype = ctypes.c_int
        lib.fs_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int]
        lib.fs_encode_jpeg.restype = ctypes.c_long
        lib.fs_encode_jpeg.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, u8p,
                                       ctypes.c_long]
        lib.fs_decode_jpeg.restype = ctypes.c_int
        lib.fs_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_long, u8p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int]
        _LIBS[target] = lib
        return lib


def zstd_library() -> ctypes.CDLL:
    """The loaded zstd decoder (``zstd_decode.cpp``), built on first use."""
    target = _target("zstd")
    with _lock:
        lib = _LIBS.get(target)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build("zstd")))
        size_p = ctypes.POINTER(ctypes.c_size_t)
        lib.zstd_decompress.restype = ctypes.c_int
        lib.zstd_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), size_p, ctypes.c_char_p,
            ctypes.c_size_t]
        lib.zstd_decompress_into.restype = ctypes.c_int
        lib.zstd_decompress_into.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, size_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.zstd_free.restype = None
        lib.zstd_free.argtypes = [ctypes.c_void_p]
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_uint32]
        _LIBS[target] = lib
        return lib


def zstd_decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data`` (one or more, skippable
    ones skipped, each frame's checksum verified where it carries one).
    Raises ValueError on a malformed or truncated input."""
    lib = zstd_library()
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if lib.zstd_decompress(bytes(data), len(data), ctypes.byref(out),
                           ctypes.byref(n), err, len(err)) != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.zstd_free(out)


def zstd_decompress_into(data: bytes, out: np.ndarray) -> int:
    """Decompress ``data`` into the C-contiguous array ``out`` (its bytes);
    returns the bytes written. Raises ValueError on a malformed input or
    one that does not fit."""
    if not out.flags.c_contiguous:
        raise ValueError("zstd_decompress_into needs a C-contiguous output")
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if zstd_library().zstd_decompress_into(
            bytes(data), len(data), out.ctypes.data, out.nbytes,
            ctypes.byref(n), err, len(err)) != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    return n.value


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    return zstd_library().crc32c(bytes(data), len(data), crc)


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) RGB or (H, W) grayscale uint8 -> baseline JPEG bytes at
    ``quality`` (4:2:0 for colour, as cv2.imencode's default)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    out = np.empty(2 * img.size + 65536, np.uint8)
    n = library().fs_encode_jpeg(_u8(img), h, w, c, quality, _u8(out),
                                 out.size)
    if n < 0:
        raise RuntimeError(f"JPEG encode of a {img.shape} image failed")
    return out[:n].tobytes()


def decode_jpeg(data: bytes, height: int, width: int,
                channels: int = 3) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) RGB or (H, W) grayscale uint8 (channels 1).
    Raises ValueError when the bytes do not decode to that size."""
    out = np.empty((height, width, channels), np.uint8)
    if not library().fs_decode_jpeg(data, len(data), _u8(out), height, width,
                                    channels):
        raise ValueError(f"{len(data)} bytes do not decode as a {height}x"
                         f"{width}x{channels} JPEG")
    return out[..., 0] if channels == 1 else out


class NativeFrameStore:
    """Native mmap'd reader with batched JPEG decode off the GIL, by the
    library :func:`decoder` found (``self.decoder``).

    A store that ``ingest.create_image_store`` packed from a PNG-aligned
    tree keeps each frame's ``.png`` name in its key, as the JAX package's
    does, while the split names every frame ``<frame>.jpg`` (ROADMAP.md
    C11). Where the store's first key ends in ``.png``, ``decode_batch``
    reads each ``.jpg`` key under its ``.png`` name."""

    def __init__(self, path: str, n_threads: int = 4):
        self.decoder = decoder()
        self._lib = library(self.decoder)
        self._h = self._lib.fs_open(str(path).encode())
        if not self._h:
            raise OSError(f"fs_open failed for {path}")
        self.n_threads = n_threads
        self._png_keys = first_key(path).endswith(".png")

    def __len__(self) -> int:
        return self._lib.fs_num_entries(self._h)

    def get(self, key: str) -> bytes | None:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_long()
        if not self._lib.fs_get_raw(self._h, key.encode(),
                                    ctypes.byref(ptr), ctypes.byref(size)):
            return None
        return ctypes.string_at(ptr, size.value)

    def decode_batch(self, keys: list[str | None], height: int, width: int,
                     channels: int = 3, out: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Decode JPEGs for keys -> (n, H, W, C) uint8 + (n,) ok flags, into
        ``out`` when given (a C-contiguous uint8 array of that shape, e.g.
        rows of a shared frame ring). None/empty keys, missing keys,
        undecodable or wrongly sized JPEGs stay black with ok=False."""
        n = len(keys)
        shape = (n, height, width, channels)
        if out is None:
            out = np.zeros(shape, np.uint8)
        elif (out.shape != shape or out.dtype != np.uint8
              or not out.flags.c_contiguous):
            raise ValueError(f"decode_batch needs a C-contiguous uint8 "
                             f"{shape} output, got {out.dtype} {out.shape}")
        ok = np.zeros(n, np.uint8)
        if n == 0:
            return out, ok.astype(bool)
        if self._png_keys:
            keys = [k[:-4] + ".png" if k and k.endswith(".jpg") else k
                    for k in keys]
        arr = (ctypes.c_char_p * n)(
            *[(k.encode() if k else b"") for k in keys])
        if not self._lib.fs_decode_batch(self._h, arr, n, _u8(out), height,
                                         width, channels, _u8(ok),
                                         self.n_threads):
            raise RuntimeError(f"{self.decoder} decode of {n} frames failed "
                               "on the device")
        ok = ok.astype(bool)
        out[~ok] = 0
        return out, ok

    def close(self) -> None:
        if self._h:
            self._lib.fs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
