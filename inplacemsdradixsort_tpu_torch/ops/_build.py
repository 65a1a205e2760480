"""Build the CUDA sources under ``csrc/`` into ctypes-loaded shared
libraries, one per source: ``kernels_v4.cu`` (the v4 level, terminal and
splice kernels) and ``kernels_v5.cu`` (the v5 in-place kernels).

A library is built at first use on a CUDA tensor, never at import (the
package imports on machines without ``nvcc``), into ``build/torch_kernels/``
beside the package, under a name that carries a hash of the source and
flags, so an edited source rebuilds and an unchanged one is reused.
``build`` starts one ``nvcc`` per missing library, all at once.  The C
interface takes every pointer and the stream as ``c_void_p`` and returns
``cudaGetLastError()``.
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
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("kernels_v4", "kernels_v5")}
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLANES = [_P] * 4            # one pointer per plane, NULL past nplanes
_SIGNATURES = {
    "kernels_v4": {
        "kv4_hist_level": [_P, _LL, _P, _P, _P, _I, _I, _I, _I, _P],
        "kv4_route_level": _PLANES + [_LL, _P, _P, _P, _P, _P] + _PLANES
        + [_LL, _I, _I, _I, _I, _I, _P],
        "kv4_terminal_write": _PLANES + [_LL, _P, _I] + _PLANES
        + [_LL, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
        "kv4_splice_runs": _PLANES + [_LL, _P, _I] + _PLANES
        + [_LL, _I, _I, _I, _P],
    },
    "kernels_v5": {
        "kv5_seqroute_level": _PLANES + [_LL] + [_P] * 9
        + [_I, _I, _I, _I, _I, _I, _P],
        "kv5_block_permute": _PLANES + [_P, _P, _I, _I, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
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


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every library whose source has no library yet, one
    ``nvcc`` per source, started together; return their paths by name.
    ``verbose`` adds ``-Xptxas -v`` and prints nvcc's report (registers,
    shared memory, spills per kernel), rebuilding every library."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    out = {name: _target(name) for name in SOURCES}
    todo = [name for name in SOURCES if verbose or not out[name].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, tmp)
        failed = []
        for name, (proc, tmp) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{err}")
            else:
                if verbose:
                    print(err, end="")
                os.replace(tmp, out[name])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def library(name: str = "kernels_v4") -> ctypes.CDLL:
    """The loaded kernel library ``name`` (every library is built on the
    first call that finds one missing)."""
    with _lock:
        if name not in _libs:
            path = build()[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.kv_error_string.argtypes = [ctypes.c_int]
            lib.kv_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def error_string(err: int) -> str:
    """CUDA's text for an error code a launcher returned."""
    return library().kv_error_string(err).decode()
