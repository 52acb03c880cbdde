"""Build and load the hand-written CUDA kernels under ops/csrc/.

Each `csrc/*.cu` compiles with nvcc for Hopper (sm_90a) into its own
shared library with a plain C interface, loaded with ctypes. Builds land
in the package's `_build/` (git-ignored) under a name that carries a hash
of the source, every header in `csrc/` and the nvcc flags, so an edited
kernel, header or flag never loads a stale library. The first
`library()` call builds every missing library at once, one nvcc process
per source, all started together. Processes that share the checkout (the
nodes of a cluster, the sweep's workloads) take an exclusive lock on the
build directory first, so one builds and the others load its output.

Nothing here runs at import: the CPU tests import every module, and the
package must import on hosts that have no nvcc.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signature of every exported kernel entry point: (argtypes, restype)
_SIGNATURES = {
    "segment_window": {
        "segment_window_f64": ([_P] * 17 + [_I64] * 4 + [ctypes.c_int, _P],
                               ctypes.c_int),
        "segment_window_i64": ([_P] * 17 + [_I64] * 4 + [ctypes.c_int, _P],
                               ctypes.c_int),
        "segment_window_call_f64": ([_P, _P, _I64, _P, _I64, _I64, _P, _P]
                                    + [_I64] * 4 + [_P, _P], ctypes.c_int),
        "segment_window_call_i64": ([_P, _P, _I64, _P, _I64, _I64, _P, _P]
                                    + [_I64] * 4 + [_P, _P], ctypes.c_int),
        "segment_window_bounds": ([_P, _I64, _I64, _I64, _I64]
                                  + [_P] * 5, _I64),
        "segment_window_pack": ([_P] * 5 + [_I64, _P, _P, _P, _I64, _I64],
                                None),
    },
    "xor_scan": {
        "xor_scan_state_words": ([_I64, _I64], _I64),
        "xor_scan_u64": ([_P, _P, _P, _I64, _I64, _P], ctypes.c_int),
        "gorilla_decode_u8": ([_P, _P, _P, _I64, _I64, _P], ctypes.c_int),
    },
}

# entry points that only enqueue work on a stream or do microseconds of
# host work: they keep the Python GIL (ctypes.PyDLL), since a thread that
# drops it may queue behind every other thread before it runs again
_HOLD_GIL = {"segment_window_call_f64", "segment_window_call_i64",
             "segment_window_bounds", "segment_window_pack",
             "xor_scan_state_words", "xor_scan_u64", "gorilla_decode_u8"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def _lib_path(name: str) -> str:
    """Where csrc/<name>.cu builds to: the name carries a hash of the
    source, every csrc/*.cuh header and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        h.update(f.encode())
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build_all() -> dict[str, float]:
    """Compile every kernel library that is not built yet, all nvcc
    processes at once. → seconds each build took (0 for a cached one)."""
    with _lock:
        return _build_missing()


def _build_missing() -> dict[str, float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # an flock is released when its process exits: a killed build
    # leaves no lock behind
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked()


def _build_locked() -> dict[str, float]:
    nvcc = None
    procs = {}
    for name in _SIGNATURES:
        out = _lib_path(name)
        if os.path.exists(out):
            build_seconds.setdefault(name, 0.0)
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc rc={proc.returncode}\n{log[-4000:]}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return dict(build_seconds)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` (a csrc/<name>.cu), building the
    missing libraries first. Raises KernelBuildError when it cannot."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not os.path.exists(_lib_path(name)):
            _build_missing()
        lib = ctypes.CDLL(_lib_path(name))
        held = ctypes.PyDLL(_lib_path(name))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(held if fn in _HOLD_GIL else lib, fn)
            f.argtypes = argtypes
            f.restype = restype
            setattr(lib, fn, f)
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def current_stream(device) -> int:
    """PyTorch's current stream on `device`, as the pointer-sized int the
    C entry points take (the raw lookup: torch.cuda.current_stream builds
    a Stream object, which costs more than a small launch)."""
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
