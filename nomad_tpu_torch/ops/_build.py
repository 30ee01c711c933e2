"""Build and load the port's CUDA kernels.

Each kernel is one source file in nomad_tpu_torch/csrc/ with a plain C
interface.  At first use it is compiled with nvcc for Hopper (sm_90a)
into a shared library under nomad_tpu_torch/build/ (named by the
source's content hash, so an edited source rebuilds) and loaded with
ctypes.  `build_all()` starts one nvcc per source at once.

Flags: -O3, no fast math, and -fmad=false, so that every multiply and
add rounds on its own exactly as the plain PyTorch versions' separate
elementwise operations do (see PERF.md for the comparison on the card).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
KERNELS = ("place_bulk", "place_scan", "world_scatter")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of each kernel source and their argument types
# (pointers and the stream as c_void_p, ints as c_int); every entry
# point returns cudaError_t
_ARGTYPES: Dict[str, Dict[str, List]] = {
    "place_bulk": {
        "place_bulk_launch": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                              _I, _I, _I, _P, _P, _P],
        "place_bulk_batch_launch": [_P] * 4 + [_I] * 8 + [_P] * 5,
    },
    "place_scan": {
        "place_scan_launch": [_P] * 18 + [_I] * 6 + [_P] * 6,
        "place_batch_launch": [_P, _P, _P, _P] + [_I] * 8 + [_P] * 6,
    },
    "world_scatter": {
        "set_rows_launch": [_P, _P, _P, _I, _I, _P],
        "add_rank1_launch": [_P, _P, _P, _P, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME (or PATH); raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nomad_tpu_torch: nvcc not found; the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for `name` unless its library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out + ".tmp",
           os.path.join(SRC_DIR, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    out = _lib_path(name)
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as fh:
        fh.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(out + ".tmp", out)


def build_all(names=KERNELS) -> Dict[str, str]:
    """Compile every kernel source in parallel; returns name -> nvcc log
    (empty for a library that was already built)."""
    with _lock:
        procs = {n: _start(n) for n in names}
        for n, p in procs.items():
            _finish(n, p)
    logs = {}
    for n in names:
        path = os.path.join(BUILD_DIR, f"{n}.log")
        logs[n] = open(path).read() if os.path.exists(path) else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            for entry, argtypes in _ARGTYPES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib
