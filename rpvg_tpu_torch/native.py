"""ctypes bridge to the C++ projection kernels (native/rpvg_native.cpp).

Builds the shared library on demand (g++ -O3) and exposes a
NativeFinder with the same find_alignment_paths /
find_paired_alignment_paths surface as the Python engine; fragments are
batched through a compact binary serialization for throughput.  Falls
back gracefully when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import sys
from typing import List, Optional, Sequence

import numpy as np

from .alignments import Alignment, MultipathAlignment
from .pathindex import PathIndex, SearchState
from .projection import AlignmentPath
from .scoring import QUAL_FULL_LENGTH_BONUSES, QUAL_MATCH_SCORES

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "csrc", "host", "rpvg_native.cpp")
# The library's translation unit: rpvg_native.cpp and the `.rpa` fragment
# pass that includes it (fragment_pass.py).
_TU = os.path.join(_PKG_DIR, "csrc", "host", "fragment_pass.cpp")
_LIB = os.path.join(_PKG_DIR, "build", "host", "librpvg_native.so")

_lib = None

# Process-wide native thread budget.  The pipeline sets this from the
# run's -t/--threads so EVERY native kernel (matrix build, fused nested
# infer, escalated EM, gathers, merges) respects the configured budget;
# unset, kernels use all host cores (the historical default).  The
# reference's -t N caps its OpenMP pool the same way (reference
# src/main.cpp:476 omp_set_num_threads).
_THREAD_BUDGET = None


def set_thread_budget(n) -> None:
    global _THREAD_BUDGET
    _THREAD_BUDGET = max(1, int(n)) if n else None


def thread_budget() -> int:
    if _THREAD_BUDGET is not None:
        return min(16, _THREAD_BUDGET)
    return min(16, os.cpu_count() or 1)


def _build_library() -> bool:
    # Several processes may build at once: each writes its own temporary
    # file and renames it into place, so none loads a half-written library.
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        # -ffp-contract=off: round every FP operation like the Python/
        # numpy spec arithmetic (no FMA contraction), so C++ twins are
        # bitwise-comparable with the Python engines.
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
        "-shared", "-fPIC", "-pthread",
        _TU, "-o", tmp,
    ]
    try:
        result = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if result.returncode != 0:
        print(f"rpvg_native build failed:\n{result.stderr}", file=sys.stderr)
        return False
    os.replace(tmp, _LIB)
    return True


def _bytes_ptr(data):
    """Read-only uint8 pointer into a bytes object — zero copy (the old
    from_buffer_copy duplicated every projection block / entry blob,
    ~hundreds of MB per large run).  The caller must keep `data` alive
    across the native call; non-bytes buffers fall back to a copy."""
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    newest = max(os.path.getmtime(_SRC), os.path.getmtime(_TU))
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < newest:
        if not _build_library():
            return None
    lib = ctypes.CDLL(_LIB)
    lib.rpvg_index_create.restype = ctypes.c_void_p
    lib.rpvg_index_create.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.rpvg_index_free.argtypes = [ctypes.c_void_p]
    lib.rpvg_project_batch.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rpvg_project_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rpvg_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.rpvg_indexer_create.restype = ctypes.c_void_p
    lib.rpvg_indexer_create.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.rpvg_indexer_free.argtypes = [ctypes.c_void_p]
    lib.rpvg_project_and_index.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rpvg_indexer_dump.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rpvg_indexer_dump.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.rpvg_indexer_dump_located.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rpvg_indexer_dump_located.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.rpvg_build_cluster_matrices.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rpvg_build_cluster_matrices.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rpvg_diploid_scores_ragged.restype = None
    lib.rpvg_diploid_scores_ragged.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
    ]
    lib.rpvg_diploid_posteriors_ragged.restype = None
    lib.rpvg_diploid_posteriors_ragged.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rpvg_diploid_select_ragged.restype = None
    lib.rpvg_diploid_select_ragged.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rpvg_posterior_gibbs_ragged.restype = None
    lib.rpvg_posterior_gibbs_ragged.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rpvg_gibbs_ragged.restype = None
    lib.rpvg_gibbs_ragged.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rpvg_subset_collapse.restype = None
    lib.rpvg_subset_collapse.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rpvg_subset_collapse_multi.restype = None
    lib.rpvg_subset_collapse_multi.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_double, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rpvg_em_ragged.restype = None
    lib.rpvg_em_ragged.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rpvg_read_collapse.restype = ctypes.c_int64
    lib.rpvg_read_collapse.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
    ]
    lib.rpvg_build_cluster_probs.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rpvg_build_cluster_probs.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return load_library() is not None


_LIBRARY_TYPES = {"unstranded": 0, "fr": 1, "rf": 2}


def serialize_fragments(fragments: Sequence) -> bytes:
    """Serialize fragments into the native batch format (also the .rpa
    on-disk block payload)."""
    s = _Serializer()
    s.put("<i", len(fragments))
    for fragment in fragments:
        paired = isinstance(fragment, tuple)
        first = fragment[0] if paired else fragment
        multipath = isinstance(first, MultipathAlignment)
        kind = (1 if multipath else 0) | (2 if paired else 0)
        s.put("<B", kind)
        if paired:
            _serialize_alignment(s, fragment[0])
            _serialize_alignment(s, fragment[1])
        else:
            _serialize_alignment(s, first)
    return s.buffer()


class LocatedPaths:
    """Pre-located fragment entry: the anchor path id and the sorted
    unique union of path ids its alignment paths locate to — all the
    host pipeline needs for clustering/partitioning when the native
    probability builder consumes the raw entry bytes."""

    __slots__ = ("anchor", "ids")

    def __init__(self, anchor: int, ids: np.ndarray):
        self.anchor = anchor
        self.ids = ids


def _marshal_cluster_columns(
    cluster_path_ids, cluster_eff_lengths, cluster_group_of,
    cluster_log_source_counts, n_clusters, concats,
):
    """Concatenated (path ids, eff lengths, group ids, log source
    counts) columns for the multi-cluster native kernels.  `concats`
    (from pipeline._clusters_meta) short-circuits the per-cluster
    np.concatenate calls with arrays built in one pass."""
    if concats is not None:
        path_offsets = concats["offsets"]
        path_sizes = np.diff(path_offsets)
        path_ids_concat = np.ascontiguousarray(concats["ids"], dtype=np.int64)
        eff_concat = np.ascontiguousarray(concats["eff"], dtype=np.float64)
        total = path_ids_concat.size
        group_of_concat = (
            np.ascontiguousarray(concats["group_of"], dtype=np.int32)
            if concats["group_of"] is not None
            else np.full(total, -1, dtype=np.int32)
        )
        log_src_concat = (
            np.ascontiguousarray(concats["log_src"], dtype=np.float64)
            if concats["log_src"] is not None
            else np.zeros(total, dtype=np.float64)
        )
        return (
            path_sizes, path_offsets, path_ids_concat, eff_concat,
            group_of_concat, log_src_concat,
        )

    path_sizes = [ids.size for ids in cluster_path_ids]
    path_offsets = np.zeros(n_clusters + 1, dtype=np.int64)
    np.cumsum(path_sizes, out=path_offsets[1:])
    path_ids_concat = np.ascontiguousarray(
        np.concatenate(cluster_path_ids), dtype=np.int64
    )
    eff_concat = np.ascontiguousarray(
        np.concatenate(cluster_eff_lengths), dtype=np.float64
    )
    group_of_concat = np.concatenate(
        [
            g if g is not None else np.full(n, -1, dtype=np.int32)
            for g, n in zip(cluster_group_of, path_sizes)
        ]
    ).astype(np.int32, copy=False)
    log_src_concat = np.concatenate(
        [
            s if s is not None else np.zeros(n, dtype=np.float64)
            for s, n in zip(cluster_log_source_counts, path_sizes)
        ]
    ).astype(np.float64, copy=False)
    return (
        path_sizes, path_offsets, path_ids_concat, eff_concat,
        group_of_concat, log_src_concat,
    )


class ColumnarFragments:
    """Columnar view of the native dedup index dump: per-entry count,
    anchor path id, located-id CSR and raw serialized-entry byte bounds,
    all over one shared buffer.  Lets the pipeline cluster, partition
    and assemble native matrix-builder blobs with array ops only."""

    __slots__ = (
        "data", "counts", "anchors", "id_bounds", "all_ids", "raw_bounds",
        "histogram", "unaligned", "_data_arr", "n_threads",
    )

    def __init__(self, data, counts, anchors, id_bounds, all_ids, raw_bounds,
                 histogram, unaligned):
        self.data = data
        self.counts = counts
        self.anchors = anchors
        self.id_bounds = id_bounds
        self.all_ids = all_ids
        self.raw_bounds = raw_bounds
        self.histogram = histogram
        self.unaligned = unaligned
        self._data_arr = None

    def __len__(self) -> int:
        return self.anchors.size

    def data_array(self) -> np.ndarray:
        if self._data_arr is None:
            self._data_arr = np.frombuffer(self.data, dtype=np.uint8)
        return self._data_arr

    def gather_blob(self, entry_order: np.ndarray):
        """Concatenated raw entry bytes for `entry_order` (uint8 array)
        plus each entry's byte length — one threaded native gather
        (numpy fancy-index fallback)."""
        starts = np.ascontiguousarray(self.raw_bounds[entry_order])
        lens = np.ascontiguousarray(self.raw_bounds[entry_order + 1] - starts)
        total = int(lens.sum())
        if total == 0:
            return np.empty(0, dtype=np.uint8), lens
        out_starts = np.zeros(entry_order.size, dtype=np.int64)
        np.cumsum(lens[:-1], out=out_starts[1:])
        lib = load_library()
        if lib is not None:
            if not getattr(lib, "_gather_configured", False):
                lib.rpvg_gather_blob.restype = None
                lib.rpvg_gather_blob.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                ]
                lib._gather_configured = True
            out = np.empty(total, dtype=np.uint8)
            lib.rpvg_gather_blob(
                self.data_array().ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                int(entry_order.size),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                int(getattr(self, "n_threads", 0) or thread_budget()),
            )
            return out, lens
        idx = np.arange(total, dtype=np.int64)
        idx += np.repeat(starts - out_starts, lens)
        return self.data_array()[idx], lens

    def entry_list(self):
        """Materialise the legacy per-entry representation:
        [(LocatedPaths, count, raw bytes)]."""
        data, counts, anchors = self.data, self.counts, self.anchors
        id_bounds, all_ids, raw_bounds = self.id_bounds, self.all_ids, self.raw_bounds
        return [
            (
                LocatedPaths(int(anchors[i]), all_ids[id_bounds[i] : id_bounds[i + 1]]),
                int(counts[i]),
                data[raw_bounds[i] : raw_bounds[i + 1]],
            )
            for i in range(anchors.size)
        ]


def columnar_fragments(data: bytes, hist_size: int) -> ColumnarFragments:
    """:class:`ColumnarFragments` over a dump in the layout of
    ``rpvg_indexer_dump_located`` (also ``rpvg_flat_dump``'s)."""
    (n,) = struct.unpack_from("<Q", data, 0)
    offset = 8
    counts = np.frombuffer(data, dtype=np.uint64, count=n, offset=offset)
    offset += 8 * n
    anchors = np.frombuffer(data, dtype=np.int64, count=n, offset=offset)
    offset += 8 * n
    n_ids = np.frombuffer(data, dtype=np.int32, count=n, offset=offset)
    offset += 4 * n
    (ids_total,) = struct.unpack_from("<q", data, offset)
    offset += 8
    all_ids = np.frombuffer(data, dtype=np.int64, count=ids_total, offset=offset)
    offset += 8 * ids_total
    raw_lens = np.frombuffer(data, dtype=np.int64, count=n, offset=offset)
    offset += 8 * n

    id_bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_ids, out=id_bounds[1:])
    raw_bounds = np.full(n + 1, offset, dtype=np.int64)
    np.cumsum(raw_lens, out=raw_bounds[1:])
    raw_bounds[1:] += offset
    offset = int(raw_bounds[-1])

    (unaligned,) = struct.unpack_from("<Q", data, offset)
    offset += 8
    histogram = np.frombuffer(data, dtype=np.int64, count=hist_size, offset=offset).copy()
    return ColumnarFragments(
        data, counts, anchors, id_bounds, all_ids, raw_bounds,
        histogram, int(unaligned),
    )


def _parse_path_list(view, offset):
    """Parse one serialized alignment-path list; returns (paths, offset)."""
    (n_paths,) = struct.unpack_from("<i", view, offset)
    offset += 4
    paths: List[AlignmentPath] = []
    for _ in range(n_paths):
        node, n_pos = struct.unpack_from("<qi", view, offset)
        offset += 12
        positions = np.frombuffer(view, dtype=np.int64, count=n_pos, offset=offset).copy()
        offset += 8 * n_pos
        is_simple, mapq, score_sum, align_length, frag_length = struct.unpack_from(
            "<Biiii", view, offset
        )
        offset += 17
        paths.append(
            AlignmentPath(
                SearchState(node, positions),
                bool(is_simple),
                mapq,
                score_sum,
                align_length,
                frag_length,
            )
        )
    return paths, offset


class _Serializer:
    def __init__(self):
        self.parts: List[bytes] = []

    def put(self, fmt: str, *values):
        self.parts.append(struct.pack(fmt, *values))

    def raw(self, data: bytes):
        self.parts.append(data)

    def buffer(self) -> bytes:
        return b"".join(self.parts)


def _serialize_path(s: _Serializer, path) -> None:
    # An absent path (unaligned record, or a multipath record read in
    # --single-path mode) serializes as zero mappings — the projection
    # kernel finds nothing and the fragment counts as unaligned/noise,
    # matching the Python finder's has_path() handling.
    mappings = path.mappings if path is not None else ()
    s.put("<i", len(mappings))
    for m in mappings:
        first_edit = m.edits[0]
        last_edit = m.edits[-1]
        s.put(
            "<qiiiiiii",
            m.gbwt_node(),
            m.offset,
            m.to_length(),
            m.from_length(),
            first_edit.from_length,
            first_edit.to_length,
            last_edit.from_length,
            last_edit.to_length,
        )


def _serialize_alignment(s: _Serializer, aln) -> None:
    is_multipath = isinstance(aln, MultipathAlignment)
    allelic_mapq = int(aln.annotation.get("allelic_mapq", -1))
    s.put("<iiiBB", len(aln.sequence), aln.mapping_quality, allelic_mapq,
          int("disconnected" in aln.annotation), int(bool(aln.quality)))
    if aln.quality:
        s.raw(bytes(aln.quality))
    if not is_multipath:
        s.put("<i", aln.score)
        _serialize_path(s, aln.path)
    else:
        s.put("<ii", len(aln.subpaths), len(aln.start))
        for start in aln.start:
            s.put("<i", start)
        for sp in aln.subpaths:
            s.put("<iii", sp.score, len(sp.connections), len(sp.next))
            for nxt in sp.next:
                s.put("<i", nxt)
            _serialize_path(s, sp.path)


class NativeFinder:
    """Projection driver backed by the C++ kernels.  Prefer
    :meth:`project_batch` for throughput; the single-fragment methods
    exist for drop-in compatibility and testing."""

    def __init__(
        self,
        paths_index: PathIndex,
        library_type: str = "unstranded",
        score_not_qual: bool = False,
        use_allelic_mapq: bool = False,
        max_pair_frag_length: int = 1000,
        max_partial_offset: int = 4,
        est_missing_noise_prob: bool = False,
        max_score_diff: int = 20,
        min_best_score_filter: float = 0.9,
        threads: int = 1,
    ):
        lib = load_library()
        assert lib is not None, "native library unavailable"
        self._lib = lib
        self.index = paths_index
        self.use_allelic_mapq = use_allelic_mapq

        concat = np.ascontiguousarray(paths_index.concat, dtype=np.int64)
        seq_starts = np.ascontiguousarray(paths_index.seq_starts, dtype=np.int64)
        node_lengths = np.ascontiguousarray(
            paths_index.graph.node_lengths, dtype=np.int32
        )
        self._keepalive = (concat, seq_starts, node_lengths)
        self._handle = lib.rpvg_index_create(
            concat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            concat.size,
            seq_starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            seq_starts.size,
            node_lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            node_lengths.size,
            int(paths_index.is_bidirectional),
        )

        self._iparams = np.array(
            [
                _LIBRARY_TYPES[library_type],
                int(score_not_qual),
                max_pair_frag_length,
                max_partial_offset,
                int(est_missing_noise_prob),
                max_score_diff,
                int(use_allelic_mapq),
                max(1, int(threads)),
            ],
            dtype=np.int32,
        )
        self._min_best_score_filter = float(min_best_score_filter)
        self._match_scores = np.ascontiguousarray(QUAL_MATCH_SCORES, dtype=np.int32)
        self._bonuses = np.ascontiguousarray(QUAL_FULL_LENGTH_BONUSES, dtype=np.int32)

    def __del__(self):
        try:
            self._lib.rpvg_index_free(self._handle)
        except Exception:
            pass

    # ------------------------------------------------------------ batching
    def project_batch(self, fragments: Sequence) -> List[List[AlignmentPath]]:
        """fragments: list of Alignment/MultipathAlignment (single-end)
        or (mate1, mate2) tuples.  Returns per fragment the finalized
        alignment-path list ([] = unaligned)."""
        return self.project_payload(serialize_fragments(fragments))

    def project_payload(self, payload: bytes) -> List[List[AlignmentPath]]:
        """Run projection on an already-serialized fragment block (the
        .rpa on-disk format), bypassing Python object construction."""
        out_len = ctypes.c_int64()
        in_buf = _bytes_ptr(payload)
        out_ptr = self._lib.rpvg_project_batch(
            self._handle,
            in_buf,
            len(payload),
            self._iparams.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._min_best_score_filter,
            self._match_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._bonuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.byref(out_len),
        )
        try:
            data = ctypes.string_at(out_ptr, out_len.value)
        finally:
            self._lib.rpvg_buffer_free(out_ptr)

        return self._parse_results(data)

    @staticmethod
    def _parse_results(data: bytes) -> List[List[AlignmentPath]]:
        view = memoryview(data)
        offset = 0
        (n_fragments,) = struct.unpack_from("<i", view, offset)
        offset += 4
        results: List[List[AlignmentPath]] = []
        for _ in range(n_fragments):
            paths, offset = _parse_path_list(view, offset)
            results.append(paths)
        return results

    # ------------------------------------------------ native fragment index
    def create_indexer(self, hist_size: int, pre_loc: int, is_single_end: bool) -> int:
        return self._lib.rpvg_indexer_create(int(hist_size), int(pre_loc), int(is_single_end))

    def free_indexer(self, indexer) -> None:
        self._lib.rpvg_indexer_free(indexer)

    def project_and_index(self, payload: bytes, indexer) -> None:
        """Project a serialized fragment block and fold the results into
        the native dedup index (no per-fragment Python round trip)."""
        in_buf = _bytes_ptr(payload)
        self._lib.rpvg_project_and_index(
            self._handle,
            indexer,
            in_buf,
            len(payload),
            self._iparams.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._min_best_score_filter,
            self._match_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._bonuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    def dump_indexer(self, indexer, hist_size: int):
        """Returns (entries [(align_paths, count, raw_bytes)], histogram,
        unaligned); raw_bytes is the serialized entry (count + path
        list), consumable by :meth:`build_cluster_probs`."""
        out_len = ctypes.c_int64()
        out_ptr = self._lib.rpvg_indexer_dump(indexer, ctypes.byref(out_len))
        try:
            data = ctypes.string_at(out_ptr, out_len.value)
        finally:
            self._lib.rpvg_buffer_free(out_ptr)

        view = memoryview(data)
        offset = 0
        (n_entries,) = struct.unpack_from("<Q", view, offset)
        offset += 8
        entries = []
        for _ in range(n_entries):
            start = offset
            (count,) = struct.unpack_from("<Q", view, offset)
            offset += 8
            paths, offset = _parse_path_list(view, offset)
            entries.append((paths, int(count), data[start:offset]))
        (unaligned,) = struct.unpack_from("<Q", view, offset)
        offset += 8
        histogram = np.frombuffer(view, dtype=np.int64, count=hist_size, offset=offset).copy()
        return entries, histogram, int(unaligned)

    def dump_indexer_columnar(self, indexer, hist_size: int) -> "ColumnarFragments":
        """Dump the dedup index as column arrays — counts, anchor ids,
        located-id CSR and raw-entry byte bounds over one shared buffer —
        with NO per-entry Python objects."""
        out_len = ctypes.c_int64()
        out_ptr = self._lib.rpvg_indexer_dump_located(
            indexer, self._handle, ctypes.byref(out_len),
            int(self._iparams[7]),
        )
        if not out_ptr:
            raise MemoryError(
                "native dump allocation failed "
                f"(requested entry blob too large; out_len={out_len.value})"
            )
        try:
            data = ctypes.string_at(out_ptr, out_len.value)
        finally:
            self._lib.rpvg_buffer_free(out_ptr)
        cols = columnar_fragments(data, hist_size)
        cols.n_threads = int(self._iparams[7])
        return cols

    def dump_indexer_located(self, indexer, hist_size: int):
        """Like :meth:`dump_indexer` but entries carry pre-located path
        ids (LocatedPaths) instead of parsed AlignmentPath objects —
        no per-path Python parsing on the hot path."""
        cols = self.dump_indexer_columnar(indexer, hist_size)
        return cols.entry_list(), cols.histogram, cols.unaligned

    # ------------------------------------------------------- cluster probs
    def build_cluster_matrices(
        self,
        cluster_blobs: Sequence[bytes],
        cluster_entry_counts: Sequence[int],
        cluster_path_ids: Sequence[np.ndarray],
        cluster_eff_lengths: Sequence[np.ndarray],
        cluster_group_of: Sequence[Optional[np.ndarray]],
        cluster_n_groups: Sequence[int],
        cluster_log_source_counts: Sequence[Optional[np.ndarray]],
        frag_log_probs: np.ndarray,
        is_single_end: bool,
        min_noise_prob: float,
        prob_precision: float,
        n_threads: int = 1,
        concats=None,
    ):
        """Dense probability matrices for every cluster in ONE native
        call, built by `n_threads` C++ workers.  Returns per cluster
        (probs (R, C), noise (R,), counts (R,)) as read-only views into
        one shared buffer; elementwise identical to assembling
        construct_probability_matrix from build_cluster_probs rows.
        `concats` (pipeline._clusters_meta) carries the marshalling
        arrays pre-concatenated, skipping the per-cluster np.concatenate
        calls."""
        # cluster_blobs: either a sequence of per-cluster bytes, or the
        # pre-concatenated fast path (uint8 array, int64 offsets (n+1,))
        # from ColumnarFragments.gather_blob — no join, no buffer copy.
        if isinstance(cluster_blobs, tuple):
            blob_arr, blob_offsets = cluster_blobs
            blob_arr = np.ascontiguousarray(blob_arr, dtype=np.uint8)
            blob_offsets = np.ascontiguousarray(blob_offsets, dtype=np.int64)
            n_clusters = blob_offsets.size - 1
            in_buf = blob_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        else:
            n_clusters = len(cluster_blobs)
            entries_blob = b"".join(cluster_blobs)
            blob_offsets = np.zeros(n_clusters + 1, dtype=np.int64)
            np.cumsum([len(b) for b in cluster_blobs], out=blob_offsets[1:])
            in_buf = _bytes_ptr(entries_blob)
        entry_counts = np.asarray(cluster_entry_counts, dtype=np.int64)

        (
            path_sizes, path_offsets, path_ids_concat, eff_concat,
            group_of_concat, log_src_concat,
        ) = _marshal_cluster_columns(
            cluster_path_ids, cluster_eff_lengths, cluster_group_of,
            cluster_log_source_counts, n_clusters, concats,
        )
        n_groups_arr = np.asarray(cluster_n_groups, dtype=np.int64)
        frag_log_probs = np.ascontiguousarray(frag_log_probs, dtype=np.float64)

        out_len = ctypes.c_int64()
        out_ptr = self._lib.rpvg_build_cluster_matrices(
            self._handle,
            in_buf,
            blob_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            entry_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_clusters,
            path_ids_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            path_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            eff_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            group_of_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_groups_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            log_src_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            frag_log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            frag_log_probs.size,
            int(is_single_end),
            float(min_noise_prob),
            float(prob_precision),
            int(max(1, n_threads)),
            ctypes.byref(out_len),
        )
        try:
            data = ctypes.string_at(out_ptr, out_len.value)
        finally:
            self._lib.rpvg_buffer_free(out_ptr)

        # Decode with two whole-buffer views; every record is a slice.
        # Layout per cluster: i64 R, f64 probs[R*n_cols], f64 noise[R],
        # f64 counts[R] — all 8-byte words, so one f64 view covers the
        # payloads and one i64 view the R headers.
        i64 = np.frombuffer(data, dtype=np.int64)
        f64 = np.frombuffer(data, dtype=np.float64)
        n_cols_list = np.where(
            n_groups_arr > 0, n_groups_arr, np.asarray(path_sizes, dtype=np.int64)
        ).tolist()
        results = []
        pos = 0
        for c in range(n_clusters):
            n_cols = n_cols_list[c]
            R = int(i64[pos])
            w = R * n_cols
            probs = f64[pos + 1 : pos + 1 + w].reshape(R, n_cols)
            pos += 1 + w
            noise = f64[pos : pos + R]
            counts = f64[pos + R : pos + 2 * R]
            pos += 2 * R
            results.append((probs, noise, counts))
        assert pos * 8 == len(data), "matrix stream decode mismatch"
        return results

    def format_prob_rows(
        self,
        cluster_blobs,
        cluster_entry_counts,
        cluster_path_ids,
        cluster_eff_lengths,
        cluster_group_of,
        cluster_n_groups,
        cluster_log_source_counts,
        frag_log_probs,
        is_single_end: bool,
        min_noise_prob: float,
        prob_precision: float,
        digits: int,
        n_threads: int = 1,
        concats=None,
    ):
        """'-b' probability rows for every cluster as text (native
        rpvg_format_prob_rows_multi) — the same ReadPathProbs rows the
        matrix builder derives, formatted 'count noise prob:ids...';
        same input marshalling as build_cluster_matrices.  Returns one
        text string per cluster (no '#'/header — callers add those)."""
        if not getattr(self._lib, "_fmt_prob_configured", False):
            self._lib.rpvg_format_prob_rows_multi.restype = ctypes.POINTER(ctypes.c_uint8)
            self._lib.rpvg_format_prob_rows_multi.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int32, ctypes.c_double, ctypes.c_double,
                ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
            ]
            self._lib._fmt_prob_configured = True

        if isinstance(cluster_blobs, tuple):
            blob_arr, blob_offsets = cluster_blobs
            blob_arr = np.ascontiguousarray(blob_arr, dtype=np.uint8)
            blob_offsets = np.ascontiguousarray(blob_offsets, dtype=np.int64)
            n_clusters = blob_offsets.size - 1
            in_buf = blob_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        else:
            n_clusters = len(cluster_blobs)
            entries_blob = b"".join(cluster_blobs)
            blob_offsets = np.zeros(n_clusters + 1, dtype=np.int64)
            np.cumsum([len(b) for b in cluster_blobs], out=blob_offsets[1:])
            in_buf = _bytes_ptr(entries_blob)
        entry_counts = np.asarray(cluster_entry_counts, dtype=np.int64)

        (
            path_sizes, path_offsets, path_ids_concat, eff_concat,
            group_of_concat, log_src_concat,
        ) = _marshal_cluster_columns(
            cluster_path_ids, cluster_eff_lengths, cluster_group_of,
            cluster_log_source_counts, n_clusters, concats,
        )
        n_groups_arr = np.asarray(cluster_n_groups, dtype=np.int64)
        frag_log_probs = np.ascontiguousarray(frag_log_probs, dtype=np.float64)

        out_len = ctypes.c_int64()
        out_ptr = self._lib.rpvg_format_prob_rows_multi(
            self._handle,
            in_buf,
            blob_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            entry_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_clusters,
            path_ids_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            path_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            eff_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            group_of_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_groups_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            log_src_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            frag_log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            frag_log_probs.size,
            int(is_single_end),
            float(min_noise_prob),
            float(prob_precision),
            int(digits),
            int(max(1, n_threads)),
            ctypes.byref(out_len),
        )
        try:
            data = ctypes.string_at(out_ptr, out_len.value)
        finally:
            self._lib.rpvg_buffer_free(out_ptr)

        (n_out,) = struct.unpack_from("<q", data, 0)
        assert n_out == n_clusters
        lens = np.frombuffer(data, dtype=np.int64, count=n_clusters, offset=8)
        offset = 8 + 8 * n_clusters
        texts = []
        for c in range(n_clusters):
            ln = int(lens[c])
            texts.append(data[offset : offset + ln].decode())
            offset += ln
        return texts

    def build_cluster_probs(
        self,
        entry_blobs: bytes,
        n_entries: int,
        cluster_path_ids: np.ndarray,
        eff_lengths: np.ndarray,
        frag_log_probs: np.ndarray,
        is_single_end: bool,
        min_noise_prob: float,
        prob_precision: float,
        group_of: Optional[np.ndarray] = None,
        n_groups: int = 0,
        log_source_counts: Optional[np.ndarray] = None,
    ):
        """Native ReadPathProbs construction + identical-row merge for
        one cluster; returns a list of ReadPathProbs."""
        from .probabilities import ReadPathProbs

        cluster_path_ids = np.ascontiguousarray(cluster_path_ids, dtype=np.int64)
        eff_lengths = np.ascontiguousarray(eff_lengths, dtype=np.float64)
        frag_log_probs = np.ascontiguousarray(frag_log_probs, dtype=np.float64)
        if group_of is None:
            group_of = np.full(cluster_path_ids.size, -1, dtype=np.int32)
        else:
            group_of = np.ascontiguousarray(group_of, dtype=np.int32)
        if log_source_counts is None:
            log_source_counts = np.zeros(cluster_path_ids.size, dtype=np.float64)
        else:
            log_source_counts = np.ascontiguousarray(log_source_counts, dtype=np.float64)

        in_buf = _bytes_ptr(entry_blobs)
        out_len = ctypes.c_int64()
        out_ptr = self._lib.rpvg_build_cluster_probs(
            self._handle,
            in_buf,
            len(entry_blobs),
            int(n_entries),
            cluster_path_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cluster_path_ids.size,
            eff_lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            group_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(n_groups),
            log_source_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            frag_log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            frag_log_probs.size,
            int(is_single_end),
            float(min_noise_prob),
            float(prob_precision),
            ctypes.byref(out_len),
        )
        try:
            data = ctypes.string_at(out_ptr, out_len.value)
        finally:
            self._lib.rpvg_buffer_free(out_ptr)

        view = memoryview(data)
        offset = 0
        (n_rows,) = struct.unpack_from("<Q", view, offset)
        offset += 8
        rows = []
        for _ in range(n_rows):
            count, noise, n_probs = struct.unpack_from("<Qdi", view, offset)
            offset += 20
            rpp = ReadPathProbs(int(count), prob_precision)
            rpp.noise_prob = noise
            for _ in range(n_probs):
                prob, n_ids = struct.unpack_from("<di", view, offset)
                offset += 12
                ids = list(struct.unpack_from(f"<{n_ids}i", view, offset))
                offset += 4 * n_ids
                rpp.path_probs.append((prob, ids))
            rows.append(rpp)
        return rows

    # --------------------------------------------- single-fragment surface
    def find_alignment_paths(self, aln) -> List[AlignmentPath]:
        return self.project_batch([aln])[0]

    def find_paired_alignment_paths(self, aln_1, aln_2) -> List[AlignmentPath]:
        return self.project_batch([(aln_1, aln_2)])[0]


def fit_skew_normal_mle(counts) -> "Optional[tuple]":
    """Native skew-normal MLE fit (same MOM init + alternating
    golden-section algorithm as fragments._fit_skew_normal_mle);
    returns (loc, scale, shape) or None when the library is missing."""
    lib = load_library()
    if lib is None:
        return None
    import numpy as np

    if not getattr(lib, "_fit_mle_configured", False):
        lib.rpvg_fit_skew_normal_mle.restype = None
        lib.rpvg_fit_skew_normal_mle.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib._fit_mle_configured = True
    counts = np.ascontiguousarray(counts, dtype=np.float64)
    mu = ctypes.c_double()
    sigma = ctypes.c_double()
    alpha = ctypes.c_double()
    lib.rpvg_fit_skew_normal_mle(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        counts.size,
        ctypes.byref(mu), ctypes.byref(sigma), ctypes.byref(alpha),
    )
    return mu.value, sigma.value, alpha.value


def nested_diploid_infer(
    dense_clusters,
    group_specs,
    group_src_counts,
    group_ids,
    min_rel_likelihood: float,
    min_hap_prob: float,
    prob_precision: float,
    max_em_its: int,
    max_rel_em_conv: float,
    em_area_cutoff: int = 0,
    em_bound_its: int = 0,
    emit_matrices: bool = False,
    n_threads: int = 0,
):
    """Fused nested-model inference (native/rpvg_native.cpp:
    rpvg_nested_diploid_infer): grouped matrices, diploid posteriors,
    subset selection, per-subset collapse and EM in one threaded call.

    dense_clusters: per slot (dense (R, C), noise (R,), counts (R,)).
    group_specs: per slot (flat [len, ids...] int64 spec, n_groups).
    group_src_counts: per slot the per-group source multiplicities.

    Returns a dict of global streams — totals/n_tasks per slot;
    subset_prob/n_col/kept/has_fracs per task; collapsed+mult CSR;
    fracs CSR for natively-EM'd tasks; mats+cnts CSR for device-EM
    handoffs (tasks the em_area_cutoff filtered out, plus tasks that
    failed to converge within em_bound_its iterations — the heavy tail
    of the EM time distribution, escalated to the device) — or None
    when the library is unavailable."""
    import os

    lib = load_library()
    if lib is None:
        return None
    if not getattr(lib, "_nested_configured", False):
        lib.rpvg_nested_diploid_infer.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rpvg_nested_diploid_infer.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._nested_configured = True

    n = len(dense_clusters)
    n_rows = np.fromiter((c[0].shape[0] for c in dense_clusters), np.int64, n)
    n_cols = np.fromiter((c[0].shape[1] for c in dense_clusters), np.int64, n)
    dense_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=dense_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])

    empty_f = np.empty(0, dtype=np.float64)
    dense_concat = (
        np.concatenate([np.ascontiguousarray(c[0], dtype=np.float64).ravel() for c in dense_clusters])
        if n else empty_f
    )
    noise_concat = (
        np.concatenate([np.asarray(c[1], dtype=np.float64) for c in dense_clusters])
        if n else empty_f
    )
    counts_concat = (
        np.concatenate([np.asarray(c[2], dtype=np.float64) for c in dense_clusters])
        if n else empty_f
    )

    n_groups = np.fromiter((s[1] for s in group_specs), np.int64, n)
    if n and int(n_groups.min()) == 0:
        # Degenerate slot without source groups: the staged path
        # handles it; reduceat below cannot.
        return None
    spec_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([s[0].size for s in group_specs], out=spec_offsets[1:])
    spec_concat = (
        np.concatenate([s[0] for s in group_specs])
        if n else np.empty(0, dtype=np.int64)
    )
    gc_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_groups, out=gc_offsets[1:])
    gc_concat = (
        np.concatenate([np.asarray(c, dtype=np.float64) for c in group_src_counts])
        if n else empty_f
    )
    # Log frequency priors computed HERE with numpy (np.log can differ
    # from libm's log by an ulp; the staged path uses numpy, and the
    # fused kernel must match it bitwise).
    if n:
        seg_totals = np.add.reduceat(gc_concat, gc_offsets[:-1])
        lf_concat = np.log(gc_concat / np.repeat(seg_totals, n_groups))
    else:
        lf_concat = empty_f

    gid_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=gid_offsets[1:])
    gid_concat = (
        np.ascontiguousarray(np.concatenate(group_ids), dtype=np.int64)
        if n else np.empty(0, dtype=np.int64)
    )

    if n_threads <= 0:
        n_threads = thread_budget()
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    out_len = ctypes.c_int64()
    out_ptr = lib.rpvg_nested_diploid_infer(
        as_f64(dense_concat), as_f64(noise_concat), as_f64(counts_concat),
        as_i64(dense_offsets), as_i64(row_offsets), as_i64(n_rows), as_i64(n_cols),
        n, as_i64(spec_concat), as_i64(spec_offsets), as_i64(n_groups),
        as_f64(lf_concat), as_i64(gc_offsets),
        as_i64(gid_concat), as_i64(gid_offsets),
        float(min_rel_likelihood), float(min_hap_prob), float(prob_precision),
        int(max_em_its), float(max_rel_em_conv), int(em_area_cutoff),
        int(em_bound_its), int(bool(emit_matrices)), int(n_threads),
        ctypes.byref(out_len),
    )
    try:
        data = ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.rpvg_buffer_free(out_ptr)

    (n_out, n_tasks_total) = struct.unpack_from("<qq", data, 0)
    assert n_out == n
    offset = 16

    def take(dtype, count):
        nonlocal offset
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=offset)
        offset += arr.nbytes
        return arr

    def take_sized(dtype):
        nonlocal offset
        (count,) = struct.unpack_from("<q", data, offset)
        offset += 8
        return take(dtype, count)

    streams = {
        "totals": take(np.float64, n),
        "n_tasks": take(np.int64, n),
        "subset_prob": take(np.float64, n_tasks_total),
        "n_col": take(np.int64, n_tasks_total),
        "kept": take(np.int64, n_tasks_total),
        "has_fracs": take(np.uint8, n_tasks_total),
    }
    streams["collapsed"] = take_sized(np.int64)
    streams["mult"] = take(np.int64, streams["collapsed"].size)
    streams["fracs"] = take_sized(np.float64)
    streams["mats"] = take_sized(np.float64)
    streams["cnts"] = take_sized(np.float64)
    streams["combined"] = take(np.uint8, n)
    streams["slot_noise"] = take(np.float64, n)
    streams["n_sets"] = take(np.int64, n)
    streams["set_lens"] = take_sized(np.int64)
    streams["set_ids"] = take_sized(np.int64)
    streams["set_posteriors"] = take(np.float64, streams["set_lens"].size)
    streams["set_abundances"] = take(np.float64, streams["set_ids"].size)
    # Bounded-EM escalation exit state (one entry per deferred task in
    # stream order when em_bound_its was active).
    streams["esc_fracs"] = take_sized(np.float64)
    streams["esc_conv"] = take_sized(np.int64)
    return streams


def format_rows_native(prefixes, columns, digits: int = 8):
    """Assemble '<prefix>\\t<g-formatted num>...\\n' output rows in C++
    (native rpvg_format_rows); returns the text or None when the
    library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    if not getattr(lib, "_fmt_rows_configured", False):
        lib.rpvg_format_rows.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rpvg_format_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._fmt_rows_configured = True

    n = len(prefixes)
    joined = "".join(prefixes).encode()
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter((len(p.encode()) if not p.isascii() else len(p) for p in prefixes), np.int64, n),
        out=offsets[1:],
    )
    blob = np.frombuffer(joined, dtype=np.uint8)
    cols = np.ascontiguousarray(
        np.stack([np.asarray(c, dtype=np.float64) for c in columns])
        if columns else np.empty((0, n), dtype=np.float64)
    )
    out_len = ctypes.c_int64()
    out_ptr = lib.rpvg_format_rows(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(columns),
        int(digits),
        ctypes.byref(out_len),
    )
    try:
        return ctypes.string_at(out_ptr, out_len.value).decode()
    finally:
        lib.rpvg_buffer_free(out_ptr)


def strains_infer(
    dense_clusters,
    prob_precision: float,
    max_em_its: int,
    max_rel_em_conv: float,
    emit_matrices: bool = False,
    n_threads: int = 0,
):
    """Fused `strains` inference (native rpvg_strains_infer): greedy
    weighted minimum path cover, cover sub-matrix collapse and EM in one
    threaded call.  Returns a dict of columnar streams (n_cover / total
    / noise / kept per slot; cover ids + path counts CSR; task matrices
    when emit_matrices) or None when the library is unavailable."""
    import os

    lib = load_library()
    if lib is None:
        return None
    if not getattr(lib, "_strains_configured", False):
        lib.rpvg_strains_infer.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rpvg_strains_infer.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._strains_configured = True

    n = len(dense_clusters)
    n_rows = np.fromiter((c[0].shape[0] for c in dense_clusters), np.int64, n)
    n_cols = np.fromiter((c[0].shape[1] for c in dense_clusters), np.int64, n)
    dense_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=dense_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])

    empty_f = np.empty(0, dtype=np.float64)
    dense_concat = (
        np.concatenate([np.ascontiguousarray(c[0], dtype=np.float64).ravel() for c in dense_clusters])
        if n else empty_f
    )
    noise_concat = (
        np.concatenate([np.asarray(c[1], dtype=np.float64) for c in dense_clusters])
        if n else empty_f
    )
    counts_concat = (
        np.concatenate([np.asarray(c[2], dtype=np.float64) for c in dense_clusters])
        if n else empty_f
    )

    if n_threads <= 0:
        n_threads = thread_budget()
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    out_len = ctypes.c_int64()
    out_ptr = lib.rpvg_strains_infer(
        as_f64(dense_concat), as_f64(noise_concat), as_f64(counts_concat),
        as_i64(dense_offsets), as_i64(row_offsets), as_i64(n_rows), as_i64(n_cols),
        n, float(prob_precision), int(max_em_its), float(max_rel_em_conv),
        int(bool(emit_matrices)), int(n_threads), ctypes.byref(out_len),
    )
    try:
        data = ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.rpvg_buffer_free(out_ptr)

    (n_out, cover_total) = struct.unpack_from("<qq", data, 0)
    assert n_out == n
    offset = 16

    def take(dtype, count):
        nonlocal offset
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=offset)
        offset += arr.nbytes
        return arr

    def take_sized(dtype):
        nonlocal offset
        (count,) = struct.unpack_from("<q", data, offset)
        offset += 8
        return take(dtype, count)

    return {
        "n_cover": take(np.int64, n),
        "totals": take(np.float64, n),
        "noise": take(np.float64, n),
        "kept": take(np.int64, n),
        "cover": take(np.int64, cover_total),
        "path_counts": take(np.float64, cover_total),
        "mats": take_sized(np.float64),
        "cnts": take_sized(np.float64),
    }


def _load_compose_lib():
    """Load the library with the output-composer signatures configured
    (shared by compose_hapjoint_rows and tpm_normalizer_columnar so the
    argtypes live in exactly one place).  Returns None when the library
    (or an older build of it without the composer symbols) is
    unavailable, so callers fall back to the object writers."""
    lib = load_library()
    if lib is None:
        return None
    if not (
        hasattr(lib, "rpvg_compose_hapjoint_rows")
        and hasattr(lib, "rpvg_tpm_normalizer")
    ):
        return None
    if not getattr(lib, "_compose_configured", False):
        lib.rpvg_compose_hapjoint_rows.restype = None
        lib.rpvg_compose_hapjoint_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rpvg_tpm_normalizer.restype = ctypes.c_double
        lib.rpvg_tpm_normalizer.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib._compose_configured = True
    return lib


def compose_hapjoint_rows(
    names, lengths, effs, cids, n_paths, n_sets, set_lens, set_posteriors,
    set_ids, set_abundances, ploidy, min_posterior,
    total_transcript_count, threads, digits: int = 8,
):
    """Compose the haplotype-transcripts estimate rows (<prefix>.txt and
    <prefix>_joint.txt bodies) natively from the fused kernel's columnar
    set streams; returns (hap_text, joint_text) or None when the library
    is unavailable.  Byte-identical to the object writers
    (io/writers.py HaplotypeAbundance/JointHaplotypeAbundance)."""
    lib = _load_compose_lib()
    if lib is None:
        return None

    # Fixed-width NUL-padded name table (np encodes in C).
    names_fixed = np.array(names, dtype="S")
    name_width = names_fixed.dtype.itemsize
    names_blob = names_fixed.tobytes()

    def i64(a):
        return np.ascontiguousarray(np.asarray(a, dtype=np.int64))

    def f64(a):
        return np.ascontiguousarray(np.asarray(a, dtype=np.float64))

    lengths = i64(lengths)
    effs = f64(effs)
    cids = i64(cids)
    n_paths = i64(n_paths)
    n_sets = i64(n_sets)
    set_lens = i64(set_lens)
    set_posteriors = f64(set_posteriors)
    set_ids = i64(set_ids)
    set_abundances = f64(set_abundances)

    out_hap = ctypes.POINTER(ctypes.c_uint8)()
    out_hap_len = ctypes.c_int64()
    out_joint = ctypes.POINTER(ctypes.c_uint8)()
    out_joint_len = ctypes.c_int64()
    lib.rpvg_compose_hapjoint_rows(
        ctypes.cast(ctypes.c_char_p(names_blob), ctypes.POINTER(ctypes.c_uint8)),
        int(name_width),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        effs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_sets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        set_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        set_posteriors.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        set_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        set_abundances.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(len(cids)), int(ploidy), float(min_posterior),
        float(total_transcript_count), int(digits), int(threads),
        ctypes.byref(out_hap), ctypes.byref(out_hap_len),
        ctypes.byref(out_joint), ctypes.byref(out_joint_len),
    )
    try:
        hap_text = ctypes.string_at(out_hap, out_hap_len.value).decode()
    finally:
        lib.rpvg_buffer_free(out_hap)
    try:
        joint_text = ctypes.string_at(out_joint, out_joint_len.value).decode()
    finally:
        lib.rpvg_buffer_free(out_joint)
    from rpvg_tpu_torch import spans

    spans.count("outputs.composed_rows", hap_text.count("\n") + joint_text.count("\n"))
    return hap_text, joint_text


def tpm_normalizer_columnar(effs, n_paths, n_sets, set_lens, set_ids, set_abundances):
    """Sequential twin of pipeline.compute_tpm_normalizer over columnar
    set streams; returns the float total or None without the library."""
    lib = _load_compose_lib()
    if lib is None:
        return None
    effs = np.ascontiguousarray(np.asarray(effs, dtype=np.float64))
    n_paths = np.ascontiguousarray(np.asarray(n_paths, dtype=np.int64))
    n_sets = np.ascontiguousarray(np.asarray(n_sets, dtype=np.int64))
    set_lens = np.ascontiguousarray(np.asarray(set_lens, dtype=np.int64))
    set_ids = np.ascontiguousarray(np.asarray(set_ids, dtype=np.int64))
    set_abundances = np.ascontiguousarray(np.asarray(set_abundances, dtype=np.float64))
    return float(
        lib.rpvg_tpm_normalizer(
            effs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_sets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            set_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            set_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            set_abundances.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(len(n_paths)),
        )
    )


def _load_compose_ab_lib():
    """Library with the abundance-composer signatures configured (one
    place for the argtypes); None when the library — or an older build
    without the symbols — is unavailable, so callers fall back to the
    object writers."""
    lib = load_library()
    if lib is None:
        return None
    if not (
        hasattr(lib, "rpvg_compose_abundance_rows")
        and hasattr(lib, "rpvg_tpm_normalizer_perpath")
    ):
        return None
    if not getattr(lib, "_compose_ab_configured", False):
        lib.rpvg_compose_abundance_rows.restype = None
        lib.rpvg_compose_abundance_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rpvg_tpm_normalizer_perpath.restype = ctypes.c_double
        lib.rpvg_tpm_normalizer_perpath.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib._compose_ab_configured = True
    return lib


def compose_abundance_rows(
    names, lengths, effs, abundances, cids, n_paths,
    total_transcript_count, threads, digits: int = 8,
):
    """Compose AbundanceEstimatesWriter row text (transcripts/strains
    models: singleton group sets, one row per path) natively; returns
    the text or None when the library is unavailable."""
    lib = _load_compose_ab_lib()
    if lib is None:
        return None

    names_fixed = np.array(names, dtype="S")
    name_width = names_fixed.dtype.itemsize
    names_blob = names_fixed.tobytes()
    lengths = np.ascontiguousarray(np.asarray(lengths, dtype=np.int64))
    effs = np.ascontiguousarray(np.asarray(effs, dtype=np.float64))
    abundances = np.ascontiguousarray(np.asarray(abundances, dtype=np.float64))
    cids = np.ascontiguousarray(np.asarray(cids, dtype=np.int64))
    n_paths = np.ascontiguousarray(np.asarray(n_paths, dtype=np.int64))

    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    lib.rpvg_compose_abundance_rows(
        ctypes.cast(ctypes.c_char_p(names_blob), ctypes.POINTER(ctypes.c_uint8)),
        int(name_width),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        effs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        abundances.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(len(cids)), float(total_transcript_count), int(digits),
        int(threads),
        ctypes.byref(out), ctypes.byref(out_len),
    )
    try:
        return ctypes.string_at(out, out_len.value).decode()
    finally:
        lib.rpvg_buffer_free(out)


def tpm_normalizer_perpath(effs, abundances):
    """Sequential per-path normaliser twin (singleton-set models);
    returns the float total or None without the library."""
    lib = _load_compose_ab_lib()
    if lib is None:
        return None
    effs = np.ascontiguousarray(np.asarray(effs, dtype=np.float64))
    abundances = np.ascontiguousarray(np.asarray(abundances, dtype=np.float64))
    return float(
        lib.rpvg_tpm_normalizer_perpath(
            effs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            abundances.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(effs.size),
        )
    )


def nested_combine(
    gid_arrays,
    totals,
    n_tasks,
    subset_prob,
    n_col,
    collapsed,
    mult,
    col_offsets,
    em_counts,
    em_noise,
    n_threads: int = 0,
):
    """Threaded posterior-weighted combine for device-EM'd slots
    (native rpvg_nested_combine) — the exact combine tail of the fused
    nested kernel replayed from external EM results.  Returns
    (n_sets (S,), noise (S,), set_lens, set_ids, set_posteriors,
    set_abundances) or None without the library."""
    import os

    lib = load_library()
    if lib is None or not hasattr(lib, "rpvg_nested_combine"):
        return None
    if not getattr(lib, "_nested_combine_configured", False):
        lib.rpvg_nested_combine.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rpvg_nested_combine.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._nested_combine_configured = True

    n = len(gid_arrays)
    gid_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([g.size for g in gid_arrays], out=gid_offsets[1:])
    gid_concat = (
        np.ascontiguousarray(np.concatenate(gid_arrays), dtype=np.int64)
        if n else np.empty(0, dtype=np.int64)
    )
    totals = np.ascontiguousarray(totals, dtype=np.float64)
    n_tasks = np.ascontiguousarray(n_tasks, dtype=np.int64)
    subset_prob = np.ascontiguousarray(subset_prob, dtype=np.float64)
    n_col = np.ascontiguousarray(n_col, dtype=np.int64)
    collapsed = np.ascontiguousarray(collapsed, dtype=np.int64)
    mult = np.ascontiguousarray(mult, dtype=np.int64)
    col_offsets = np.ascontiguousarray(col_offsets, dtype=np.int64)
    em_counts = np.ascontiguousarray(em_counts, dtype=np.float64)
    em_noise = np.ascontiguousarray(em_noise, dtype=np.float64)

    if n_threads <= 0:
        n_threads = thread_budget()
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    out_len = ctypes.c_int64()
    out_ptr = lib.rpvg_nested_combine(
        as_i64(gid_concat), as_i64(gid_offsets), as_f64(totals), n,
        as_i64(n_tasks), as_f64(subset_prob), as_i64(n_col),
        as_i64(collapsed), as_i64(mult), as_i64(col_offsets),
        as_f64(em_counts), as_f64(em_noise),
        int(n_threads), ctypes.byref(out_len),
    )
    try:
        data = ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.rpvg_buffer_free(out_ptr)

    offset = 0
    n_sets = np.frombuffer(data, dtype=np.int64, count=n, offset=offset); offset += 8 * n
    noise = np.frombuffer(data, dtype=np.float64, count=n, offset=offset); offset += 8 * n
    (sets_total,) = struct.unpack_from("<q", data, offset); offset += 8
    set_lens = np.frombuffer(data, dtype=np.int64, count=sets_total, offset=offset); offset += 8 * sets_total
    (ids_total,) = struct.unpack_from("<q", data, offset); offset += 8
    set_ids = np.frombuffer(data, dtype=np.int64, count=ids_total, offset=offset); offset += 8 * ids_total
    set_posteriors = np.frombuffer(data, dtype=np.float64, count=sets_total, offset=offset); offset += 8 * sets_total
    set_abundances = np.frombuffer(data, dtype=np.float64, count=ids_total, offset=offset)
    return n_sets, noise, set_lens, set_ids, set_posteriors, set_abundances
