"""The `.rpa` fragment pass as one native call (``csrc/host/fragment_pass.cpp``).

``rpvg_flat_pass`` reads the file's blocks on the calling thread and
projects, condenses and counts every fragment on ``-t`` persistent
workers, without the GIL and without a heap object per search path,
alignment record or fragment key; ``rpvg_flat_dump`` writes the distinct
lists in the columns of ``rpvg_indexer_dump_located``.  Both share the
pass's one path index, the :class:`native.NativeFinder`'s.

The pipeline takes this route for an ``.rpa`` file read by one process
with the native library (:func:`takes`); every other pass runs
``pipeline.collect_fragments``, whose bytes this route reproduces.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

from rpvg_tpu_torch import native

# What rpvg_flat_pass's error codes mean: io/rpa.RpaReader.blocks' errors.
_ERRORS = {
    1: "truncated rpa block header",
    2: "corrupt rpa block length",
    3: "truncated rpa block",
}
_HEADER_BYTES = 8 + 18  # magic, then <BBdd (io/rpa.py)


def _library():
    """The native library with the flat pass configured, or None."""
    lib = native.load_library()
    if lib is None or not hasattr(lib, "rpvg_flat_pass"):
        return None
    if not getattr(lib, "_flat_configured", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rpvg_flat_pass.restype = ctypes.c_void_p
        lib.rpvg_flat_pass.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, i32p, ctypes.c_double,
            i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.rpvg_flat_free.restype = None
        lib.rpvg_flat_free.argtypes = [ctypes.c_void_p]
        lib.rpvg_flat_dump.restype = u8p
        lib.rpvg_flat_dump.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ]
        lib._flat_configured = True
    return lib


def takes(alignments, finder) -> bool:
    """Whether a single-process pass over ``alignments`` takes this route:
    an ``.rpa`` path, a native finder and a library that has the pass."""
    return (
        isinstance(alignments, str)
        and alignments.endswith(".rpa")
        and isinstance(finder, native.NativeFinder)
        and _library() is not None
    )


@dataclass
class PassStats:
    """What one pass read and did: blocks and their payload bytes, the
    reader's seconds in reads, the workers' mean seconds waiting for a
    block, and their peak arena bytes."""

    blocks: int
    bytes: int
    read_s: float
    wait_s: float
    arena_bytes: int


class FlatPass:
    """One pass's result in native memory: :meth:`dump` it once."""

    def __init__(self, finder, path: str, hist_size: int, pre_loc: int, is_single_end: bool):
        lib = _library()
        assert lib is not None, "native library without the flat fragment pass"
        self._lib = lib
        self._finder = finder
        self.hist_size = int(hist_size)
        out = (ctypes.c_double * 6)()
        self._handle = lib.rpvg_flat_pass(
            finder._handle, path.encode(), _HEADER_BYTES,
            finder._iparams.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            finder._min_best_score_filter,
            finder._match_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            finder._bonuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.hist_size, int(pre_loc), int(is_single_end), out,
        )
        error = int(out[0])
        if error:
            self.free()
            if error in _ERRORS:
                raise ValueError(_ERRORS[error])
            raise OSError(f"cannot read {path}")
        self.stats = PassStats(
            blocks=int(out[1]), bytes=int(out[2]), read_s=out[4], wait_s=out[5],
            arena_bytes=int(out[3]),
        )

    def free(self) -> None:
        if self._handle:
            self._lib.rpvg_flat_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass

    def dump(self) -> "native.ColumnarFragments":
        """The distinct lists as :class:`native.ColumnarFragments`, the
        pass's native memory freed."""
        n_threads = int(self._finder._iparams[7])
        out_len = ctypes.c_int64()
        out_ptr = self._lib.rpvg_flat_dump(
            self._handle, self._finder._handle, ctypes.byref(out_len), n_threads
        )
        self.free()
        if not out_ptr:
            raise MemoryError(
                "native dump allocation failed "
                f"(requested entry blob too large; out_len={out_len.value})"
            )
        try:
            data = ctypes.string_at(out_ptr, out_len.value)
        finally:
            self._lib.rpvg_buffer_free(out_ptr)
        cols = native.columnar_fragments(data, self.hist_size)
        cols.n_threads = n_threads
        return cols

