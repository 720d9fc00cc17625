"""Build and load the CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` alone, into a
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout, and loads through ``ctypes``. The library's file name
carries a hash of the sources and flags, so an edited source never loads a
stale build. Every pointer argument (the stream included) is declared
``c_void_p``; every C entry returns ``cudaGetLastError()``, and
:func:`check` raises when it is not 0.

Nothing here runs when a module is imported: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("pairwise", "rank", "knn", "swap", "scan")
# -split-compile 0 runs the device optimiser over as many threads as there
# are cores: on an H100 host scan.cu's 51 kernels built in 41 s instead of
# 100 s, knn.cu in 34 instead of 67, every kernel's output bit-equal
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-split-compile", "0",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(out_path, tmp, proc)`` or
    ``(out_path, None, None)`` when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source that is not built yet, with one ``nvcc``
    process per source, all started together."""
    started = [(n, *_start(n)) for n in KERNELS]
    for n, out, tmp, proc in started:
        _finish(n, out, tmp, proc)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns an ``int`` (a ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, tmp, proc = _start(name)
            _finish(name, out, tmp, proc)
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")
