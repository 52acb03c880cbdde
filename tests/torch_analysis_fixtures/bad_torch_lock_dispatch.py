"""lock-held-dispatch fixture: card work reached under a mutex."""
import threading

import cuda_build
import torch

_LOCK = threading.Lock()


def _reduce(t):
    return torch.cumsum(t, 0)


def _scan(t):
    return _reduce(t) + 1


def checksum(t):
    with _LOCK:
        out = _scan(t)
        n = len(t)
        ok = torch.cuda.is_available()
    return out, n, ok


def launch(name, ptr):
    lib = cuda_build.library(name)
    fn = lib.entry_f64 if name else lib.entry_i64
    with _LOCK:
        rc = lib.entry(ptr)
        rc2 = fn(ptr)
        rc3 = getattr(lib, name)(ptr)
    return rc, rc2, rc3
