"""Build and load the port's CUDA kernels.

Each kernel is one source file in nomad_tpu_torch/csrc/ with a plain C
interface (sources may include the shared headers there, `*.cuh`).  At
first use it is compiled with nvcc for Hopper (sm_90a) into a shared
library under nomad_tpu_torch/build/ (named by a hash of the source and
the headers, so an edited source or header rebuilds) and loaded with
ctypes.  `build_all()` starts one nvcc per source at once.

Flags: -O3, no fast math, and -fmad=false, so that every multiply and
add rounds on its own exactly as the plain PyTorch versions' separate
elementwise operations do (see PERF.md for the comparison on the card).

The native host library (csrc/nomad_native.cpp, plain C, run on the
CPU) is built the same way with g++ (`load_host`): at first use, into
nomad_tpu_torch/build/, named by a hash of its source and GXX_FLAGS.
-ffp-contract=off and no -march=native keep every multiply and add
rounding on its own, as numpy's do.  It is loaded with ctypes.PyDLL,
so a call holds the interpreter lock.  A missing compiler, a failed
build or load, or a library of another ABI raises.
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
KERNELS = ("place_bulk", "place_scan", "world_scatter", "preempt",
           "stage_probe", "sharded")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of each kernel source and their argument types
# (pointers and the stream as c_void_p, ints as c_int, floats as
# c_float); every entry
# point returns cudaError_t
_ARGTYPES: Dict[str, Dict[str, List]] = {
    "place_bulk": {
        "place_bulk_launch": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                              _I, _I, _I, _P, _P, _P],
        "place_bulk_batch_launch": [_P] * 4 + [_I] * 8 + [_P] * 4,
        "place_bulk_cluster_size": [],
        "place_bulk_set_jitter": [_I, _P],
    },
    "place_scan": {
        "place_scan_launch": [_P] * 18 + [_I] * 6 + [_P] * 7,
        "place_batch_launch": [_P, _P, _P, _P] + [_I] * 8 + [_P] * 7,
        "place_scan_cluster_size": [],
        "place_scan_set_jitter": [_I, _P],
    },
    "world_scatter": {
        # (segment records, their count, stream)
        "set_rows_launch": [_P, _I, _P],
        "add_rank1_launch": [_P, _I, _P],
    },
    "preempt": {
        "preempt_launch": [_P] * 5 + [_I] * 4 + [_P] * 4,
    },
    "stage_probe": {
        "feasibility_launch": [_P] * 5 + [_I, _I] + [_P] * 3,
        "fit_launch": [_P, _P, _I, _I, _P, _P],
        "score_launch": [_P, _P, _P, _F, _P, _P, _I, _I, _I, _P, _P],
        "argmax_launch": [_P, _P, _P, _I, _I, _P, _P, _P],
        "scatter_launch": [_P, _P, _I, _P, _P, _P, _I] + [_P] * 4,
        "fused_wave_launch": [_P, _P, _P, _P, _P, _I, _F, _P, _P, _I, _I,
                              _I] + [_P] * 4,
        "stage_probe_set_jitter": [_I, _P],
        "stage_probe_cluster_size": [],
    },
    "sharded": {
        # K7a, K7b and K7c-K7e take their shard's packed operands (a
        # pointer to ops/sharded.py ScanArgs / BulkArgs) first
        "scan_local_launch": [_P] * 4 + [_I] * 3 + [_P, _I, _I, _P],
        "scan_cache_words_of": [_I, _I, _I],
        "scan_apply_launch": [_P, _I, _P, _I, _P, _P],
        "bulk_stats_launch": [_P, _I, _I, _P, _P, _I, _I, _I, _P],
        "bulk_stats_cluster_size": [],
        "sharded_set_jitter": [_I, _P],
        "bulk_run_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _P],
        "bulk_order_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _P],
        # K7g, and K7f's counts in node shard 0's launch (else nulls)
        "basis_merge_launch": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P],
    },
}

# the native host library (csrc/HOST_LIB.cpp): g++ flags, the ABI
# version its bindings need, and its C entry points (restype first, then
# the argument types)
HOST_LIB = "nomad_native"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
HOST_ABI = 2
_HOST_ENTRIES: Dict[str, List] = {
    "allocs_fit_dense": [None, _P, _P, _P, _I, _I, _P],
    "score_fit_dense": [None, _P, _P, _P, _I, _I, _I, _P],
    "ports_check": [ctypes.c_int32, _P, _I, _I, _P, _I, _P, _I],
    "ports_set": [None, _P, _I, _I, _P, _I, _I],
    "scatter_add": [None, _P, _I, _P, _P, _I],
    "validate_plan": [None, _P, _P, _P, _I, _I] + [_P] * 7 + [_I, _P],
    "expand_pairs": [ctypes.c_int32, _P, _P, _P, _I, _P, _P,
                     ctypes.c_int32],
    "format_uuids": [None, ctypes.c_char_p, _I, ctypes.c_char_p],
    "scatter_add_rank1": [None, _P, _I, _P, _P, _P, _I],
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
    """The library's path, named by a hash of its source, the shared
    headers it may include and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [f"{name}.cu"] + sorted(f for f in os.listdir(SRC_DIR)
                                        if f.endswith(".cuh")):
        with open(os.path.join(SRC_DIR, src), "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:16]
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


def gxx_path() -> str:
    """g++ from PATH; raises when there is none."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("nomad_tpu_torch: g++ not found on PATH; the native "
                       "host library (csrc/nomad_native.cpp) builds with "
                       "g++")


def _host_lib_path() -> str:
    """The host library's path, named by a hash of its source and the
    flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(SRC_DIR, f"{HOST_LIB}.cpp"), "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{HOST_LIB}-{h.hexdigest()[:16]}.so")


def _build_host() -> str:
    """Compile the host library unless it is built; -> its path.  Each
    process compiles into a file of its own and renames it into place,
    so processes that build at once do not collide."""
    out = _host_lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [gxx_path(), *GXX_FLAGS, "-o", tmp,
           os.path.join(SRC_DIR, f"{HOST_LIB}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {HOST_LIB}.cpp "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_host() -> ctypes.CDLL:
    """The loaded native host library, built on first use; its ABI
    version checked and every entry point typed."""
    lib = _libs.get(HOST_LIB)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(HOST_LIB)
        if lib is None:
            path = _build_host()
            # PyDLL: each call keeps the interpreter lock.  The calls
            # take microseconds; CDLL releases the lock around each, and
            # with the server's ~50 threads the caller then waits up to
            # a switch interval to get it back (PERF.md)
            lib = ctypes.PyDLL(path)
            abi = lib.nomad_native_abi_version
            abi.argtypes, abi.restype = [], ctypes.c_int32
            if abi() != HOST_ABI:
                raise RuntimeError(
                    f"{HOST_LIB} ABI mismatch: {path} reports version "
                    f"{abi()}, the bindings need {HOST_ABI}; delete {path} "
                    f"to rebuild it")
            for entry, (restype, *argtypes) in _HOST_ENTRIES.items():
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = restype, argtypes
            _libs[HOST_LIB] = lib
    return lib
