"""Build and load the hand-written CUDA kernels under ``auformer_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. The library name carries a hash of its source, the shared
headers (``csrc/*.cuh``), the flags and any extra preprocessor defines, so
an edit to any of them is rebuilt and a built library is reused. Builds
land in ``.cache/kernels`` at the root of the checkout. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".cache" / "kernels"
KERNELS = ("attention", "mel", "yuv_rgb")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def source(name: str) -> Path:
    return SRC_DIR / f"{name}.cu"


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The library's path, named by a hash of its source, every header
    under csrc/, the flags and the defines."""
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _tool(name: str) -> str | None:
    """A CUDA toolkit program from PATH or CUDA_HOME, else None."""
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which(name)
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", name).exists():
        return str(Path(CUDA_HOME, "bin", name))
    return None


def _nvcc() -> str:
    nvcc = _tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def tensor_core_instructions(name: str) -> int | None:
    """The count of tensor-core instructions (HMMA, HGMMA) in the SASS of
    the built ``csrc/<name>.cu``, from ``cuobjdump -sass``; None where the
    toolkit has no cuobjdump."""
    cuobjdump = _tool("cuobjdump")
    if cuobjdump is None:
        return None
    build((name,))
    sass = subprocess.run([cuobjdump, "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum(1 for line in sass.splitlines()
               if " HMMA." in line or " HGMMA." in line)


def build(names=KERNELS, defines: tuple[str, ...] = ()) -> dict[str, str]:
    """Compile every named source not built yet, one ``nvcc`` each, all
    started together, with ``-D<define>`` for each of ``defines``. Returns
    the compiler output (``-Xptxas -v``: each kernel's registers, shared
    memory and spills) of each build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _target(n, defines).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = _target(name, defines).with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *_flags(defines), "-o", str(tmp), str(source(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for name, (tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                failed.append(f"--- {name} (exit {proc.returncode})\n"
                              f"{logs[name]}")
            else:
                os.replace(tmp, _target(name, defines))
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` built with
    ``defines``, built on first use."""
    lib = _LIBS.get((name, defines))
    if lib is None:
        build((name,), defines)
        lib = ctypes.CDLL(str(_target(name, defines)))
        _LIBS[name, defines] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned after a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
