"""glibc allocator tuning for the host pipeline.

This host faults in fresh pages at ~10MB/s, and glibc serves every
allocation above M_MMAP_THRESHOLD (128KB default) with a fresh mmap that
is munmapped on free — so every large numpy/C++ buffer pays the full
page-fault cost on every pipeline phase, every run.  Raising the
threshold keeps big buffers on the main heap, where freed pages are
reused warm; disabling trim stops the heap from being returned to the
OS between phases.  Measured: repeat allocations of a 55MB array drop
from ~5s to ~6ms.

No effect on correctness; skipped silently off glibc."""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def tune_glibc_allocator() -> bool:
    """Idempotent; returns True when mallopt was applied."""
    global _done
    if _done:
        return True
    if os.environ.get("RPVG_TPU_NO_MALLOC_TUNE"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    ok = bool(mallopt(_M_MMAP_THRESHOLD, 1 << 30))
    ok = bool(mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)) and ok
    _done = ok
    return ok
