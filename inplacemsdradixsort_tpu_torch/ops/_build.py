"""Build ``csrc/kernels_v4.cu`` into a ctypes-loaded shared library.

The library is built at first use on a CUDA tensor, never at import
(the package imports on machines without ``nvcc``), into
``build/torch_kernels/`` beside the package, under a name that carries a
hash of the source and flags, so an edited source rebuilds and an
unchanged one is reused.  The C interface takes every pointer and the
stream as ``c_void_p`` and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "kernels_v4.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLANES = [_P] * 4            # one pointer per plane, NULL past nplanes
_SIGNATURES = {
    "kv4_hist_level": [_P, _LL, _P, _P, _P, _I, _I, _I, _I, _P],
    "kv4_route_level": _PLANES + [_LL, _P, _P, _P, _P, _P] + _PLANES
    + [_LL, _I, _I, _I, _I, _I, _P],
    "kv4_terminal_write": _PLANES + [_LL, _P, _I] + _PLANES
    + [_LL, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "kv4_splice_runs": _PLANES + [_LL, _P, _I] + _PLANES
    + [_LL, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "build only where the CUDA toolkit is installed")
    return path


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of this source exists; return
    its path.  ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report
    (registers, shared memory, spills per kernel) even when reusing."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"kernels_v4-{digest}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr}")
        if verbose:
            print(res.stderr, end="")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kv4_error_string.argtypes = [ctypes.c_int]
            lib.kv4_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
