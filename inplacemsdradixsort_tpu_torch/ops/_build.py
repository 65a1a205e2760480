"""Build the CUDA sources under ``csrc/`` into one ctypes-loaded shared
library: ``kernels_v4.cu`` (the v4 level, terminal and splice kernels,
and the digit modes of the level kernels),
``kernels_v5.cu`` (the v5 in-place kernels), ``kernels_v3.cu`` (the v3
partition level) and ``pallas_kernels.cu`` (the v1 kernels), which share
``bitonic.cuh``; ``cluster_sort.cuh``, the cluster-resident network of the
v1 ``ragged_sort`` and the v4 terminal, is included by the first and the
last; ``range_lut.cuh``, the range lookup table of the partition kernels,
by ``kernels_v4.cu`` and ``kernels_v5.cu``.

The library is built at first use on a CUDA tensor, never at import (the
package imports on machines without ``nvcc``), by one ``nvcc -c`` per
source, run together, and one link, into ``build/torch_kernels/``
beside the package, under a name that carries
a hash of every source and header and of the flags, so an edited source
rebuilds and an unchanged tree is reused.  The C interface takes every
pointer and the stream as ``c_void_p`` and returns
``cudaGetLastError()``; ``kv_error_string`` turns that into text.
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
CSRC = _PKG / "csrc"
SOURCES = tuple(CSRC / f"{name}.cu"
                for name in ("kernels_v4", "kernels_v5", "kernels_v3",
                             "pallas_kernels"))
HEADERS = (CSRC / "bitonic.cuh", CSRC / "cluster_sort.cuh",
           CSRC / "range_lut.cuh")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLANES = [_P] * 4            # one pointer per plane, NULL past nplanes
_SIGNATURES = {
    # kernels_v4.cu
    "kv4_hist_level": [_P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _LL, _I, _P],
    "kv4_route_level": _PLANES + [_LL, _P, _P, _P, _P, _P] + _PLANES
    + [_LL, _I, _I, _I, _I, _I, _I, _LL, _I, _P, _P],
    "kv4_route_digit": _PLANES + [_LL, _P, _P, _P, _P] + _PLANES
    + [_LL, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    "kv4_terminal_write": _PLANES + [_LL, _P, _I] + _PLANES
    + [_LL, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "kv4_terminal_cluster": _PLANES + [_LL, _P, _I] + _PLANES
    + [_LL, _I, _I, _I, _I, _I, _I, _P],
    "kv4_terminal_resident": [_I, _I, _I],
    "kv4_splice_runs": _PLANES + [_LL, _P, _I] + _PLANES
    + [_LL, _I, _I, _I, _P],
    # kernels_v5.cu
    "kv5_seqroute_level": _PLANES + [_LL] + [_P] * 9
    + [_I, _I, _I, _I, _I, _I, _P],
    "kv5_block_permute": _PLANES + [_P, _P, _I, _I, _P],
    # kernels_v3.cu (key and value plane: the value plane NULL keys-only)
    "kv3_partition_level": [_P, _P, _LL] + [_P] * 10 + [_LL, _P, _P, _LL]
    + [_P] * 3 + [_I] * 9 + [_P],
    # pallas_kernels.cu (keys, vals: vals NULL for keys only)
    "kv1_tile_sort": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _P],
    "kv1_distribute": [_P, _P, _LL, _P, _P, _P, _P, _P, _LL, _LL, _I, _LL,
                       _I, _P],
    "kv1_ragged_sort": [_P, _P, _LL, _P, _P, _I, _LL, _I, _P],
    "kv1_compact": [_P, _P, _P, _I, _I, _LL, _I, _I, _P, _P, _I, _P],
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


def target() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library if the current sources have none yet, one
    ``nvcc -c`` per source, all started together, then one link; return
    its path.  ``verbose`` adds ``-Xptxas -v``, prints nvcc's report
    (registers, shared memory, spills per kernel) and rebuilds."""
    out = target()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, jobs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.stem + ".o")
            log = open(os.path.join(tmp, src.stem + ".log"), "w+")
            objs.append(obj)
            jobs.append((subprocess.Popen(
                [_nvcc(), *flags, "-c", "-o", obj, str(src)],
                stdout=log, stderr=subprocess.STDOUT), log))
        report = ""
        for proc, log in jobs:
            proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{text}")
            report += text
        lib = os.path.join(tmp, "kernels.so")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib,
                              *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stderr}")
        if verbose:
            print(report, end="")
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call that finds it
    missing)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.kv_error_string.argtypes = [ctypes.c_int]
            lib.kv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(err: int) -> str:
    """CUDA's text for an error code a launcher returned."""
    return library().kv_error_string(err).decode()
