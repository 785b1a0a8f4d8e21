"""ctypes binding + on-demand build of the native FrameStore reader
(counterpart of auformer/data/native).

Two sources share one C interface (``fs_open``, ``fs_close``,
``fs_num_entries``, ``fs_get_raw``, ``fs_decode_batch``,
``fs_encode_jpeg``; ``framestore.h`` holds the store format both mmap):

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

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / ".cache" / "native"
SOURCES = {"libjpeg": "framestore_reader.cpp",
           "nvjpeg": "framestore_nvjpeg.cpp"}
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
    if name == "libjpeg":
        return cmd + ["-ljpeg"]
    cuda = cuda_home()
    lib = cuda / "lib64"
    return cmd + [f"-I{cuda / 'include'}", f"-L{lib}", f"-Wl,-rpath,{lib}",
                  "-lnvjpeg", "-lcudart"]


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, framestore.h and
    the compiler command."""
    h = hashlib.sha256((SRC_DIR / SOURCES[name]).read_bytes())
    h.update((SRC_DIR / "framestore.h").read_bytes())
    h.update(" ".join(_command(name, Path("lib.so"))).encode())
    return BUILD_DIR / f"libframestore_{name}-{h.hexdigest()[:16]}.so"


def build(name: str | None = None) -> Path:
    """Compile the reader for ``name`` (default: :func:`decoder`) unless it
    is built; returns the library's path. Raises RuntimeError with the
    compiler's output when the build fails."""
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
        raise RuntimeError(f"the {name} FrameStore reader did not build: "
                           f"{e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the {name} FrameStore reader did not build "
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
        _LIBS[target] = lib
        return lib


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


class NativeFrameStore:
    """Native mmap'd reader with batched JPEG decode off the GIL, by the
    library :func:`decoder` found (``self.decoder``)."""

    def __init__(self, path: str, n_threads: int = 4):
        self.decoder = decoder()
        self._lib = library(self.decoder)
        self._h = self._lib.fs_open(str(path).encode())
        if not self._h:
            raise OSError(f"fs_open failed for {path}")
        self.n_threads = n_threads

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
                     channels: int = 3) -> tuple[np.ndarray, np.ndarray]:
        """Decode JPEGs for keys -> (n, H, W, C) uint8 + (n,) ok flags.
        None/empty keys, missing keys, undecodable or wrongly sized JPEGs
        stay black with ok=False."""
        n = len(keys)
        out = np.zeros((n, height, width, channels), np.uint8)
        ok = np.zeros(n, np.uint8)
        if n == 0:
            return out, ok.astype(bool)
        arr = (ctypes.c_char_p * n)(
            *[(k.encode() if k else b"") for k in keys])
        if not self._lib.fs_decode_batch(self._h, arr, n, _u8(out), height,
                                         width, channels, _u8(ok),
                                         self.n_threads):
            raise RuntimeError(f"{self.decoder} decode of {n} frames failed "
                               "on the device")
        return out, ok.astype(bool)

    def close(self) -> None:
        if self._h:
            self._lib.fs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
