"""Build and load the hand-written CUDA kernels under ``auformer_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. The library name carries a hash of its source, so an edited
source is rebuilt and a built one is reused. Builds land in ``.cache/kernels``
at the root of the checkout. Nothing here runs at import time.
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
KERNELS = ("attention", "mel")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def source(name: str) -> Path:
    return SRC_DIR / f"{name}.cu"


def _target(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named source not built yet, one ``nvcc`` each, all
    started together. Returns the compiler output (``-Xptxas -v``: each
    kernel's registers, shared memory and spills) of each build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for name, (tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode:
                failed.append(f"--- {name} (exit {proc.returncode})\n"
                              f"{logs[name]}")
            else:
                os.replace(tmp, _target(name))
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned after a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
