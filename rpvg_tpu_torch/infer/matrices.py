"""Dense probability-matrix assembly from sparse per-fragment
probabilities (host-side numpy; feeds the device kernels).

Behavioural contract: reference/src/path_estimator.cpp:55-313.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..constants import double_compare
from ..probabilities import ReadPathProbs


class DenseCluster:
    """A cluster's probability matrix already materialised (by the
    native batch builder, native/rpvg_native.cpp:rpvg_build_cluster_matrices):
    probs (R, P), noise (R,), counts (R,) — elementwise identical to
    running construct_probability_matrix over the sparse rows."""

    __slots__ = ("probs", "noise", "counts")

    def __init__(self, probs: np.ndarray, noise: np.ndarray, counts: np.ndarray):
        self.probs = probs
        self.noise = noise
        self.counts = counts

    def __len__(self) -> int:
        return self.probs.shape[0]


def cluster_matrix(data, num_paths: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(probs, noise, counts) for either input form: a DenseCluster
    passes through; a ReadPathProbs list is assembled densely."""
    if isinstance(data, DenseCluster):
        return data.probs, data.noise, data.counts
    return construct_probability_matrix(data, num_paths)


def total_read_count(data) -> float:
    """Sum of fragment read counts (integral, so the float sum is exact
    in either representation)."""
    if isinstance(data, DenseCluster):
        return float(data.counts.sum())
    return float(sum(rpp.read_count for rpp in data))


def construct_probability_matrix(
    cluster_probs: Sequence[ReadPathProbs], num_paths: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense (R, P) path probabilities + (R,) noise probs + (R,) counts."""
    if isinstance(cluster_probs, DenseCluster):
        return cluster_probs.probs, cluster_probs.noise, cluster_probs.counts
    R = len(cluster_probs)
    probs = np.zeros((R, num_paths), dtype=np.float64)
    noise = np.empty(R, dtype=np.float64)
    counts = np.empty(R, dtype=np.float64)
    for i, rpp in enumerate(cluster_probs):
        for prob, path_ids in rpp.path_probs:
            probs[i, path_ids] = prob
        noise[i] = rpp.noise_prob
        counts[i] = rpp.read_count
    return probs, noise, counts


def construct_partial_probability_matrix(
    cluster_probs, path_ids: Sequence[int], num_paths: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Matrix restricted to a subset of path indices (columns ordered as
    in `path_ids`)."""
    if isinstance(cluster_probs, DenseCluster):
        return (
            cluster_probs.probs[:, list(path_ids)],
            cluster_probs.noise,
            cluster_probs.counts,
        )
    col_of = -np.ones(num_paths, dtype=np.int64)
    for j, pid in enumerate(path_ids):
        col_of[pid] = j
    R = len(cluster_probs)
    probs = np.zeros((R, len(path_ids)), dtype=np.float64)
    noise = np.empty(R, dtype=np.float64)
    counts = np.empty(R, dtype=np.float64)
    for i, rpp in enumerate(cluster_probs):
        for prob, ids in rpp.path_probs:
            for pid in ids:
                j = col_of[pid]
                if j >= 0:
                    probs[i, j] = prob
        noise[i] = rpp.noise_prob
        counts[i] = rpp.read_count
    return probs, noise, counts


def construct_grouped_probability_matrix(
    cluster_probs,
    path_groups: Sequence[Sequence[int]],
    num_paths: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Columns summed over path groups (a path may feed several groups).

    Computed as column sums of the dense matrix so sparse (ReadPathProbs
    list) and DenseCluster inputs produce identical floats."""
    dense, noise, counts = cluster_matrix(cluster_probs, num_paths)
    probs = np.empty((dense.shape[0], len(path_groups)), dtype=np.float64)
    for g, group in enumerate(path_groups):
        probs[:, g] = dense[:, group].sum(axis=1)
    return probs, noise, counts


def add_noise_and_normalize(probs: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """Row-normalize, scale by (1 - noise) and append the noise column
    (reference :156-166)."""
    row_sums = probs.sum(axis=1, keepdims=True)
    scale = np.where(row_sums > 0, (1.0 - noise)[:, None] / np.where(row_sums > 0, row_sums, 1.0), 0.0)
    out = np.empty((probs.shape[0], probs.shape[1] + 1), dtype=np.float64)
    np.multiply(probs, scale, out=out[:, :-1])
    out[:, -1] = noise
    return out


_native_collapse = None


def _native_read_collapse():
    """ctypes handle for the C++ collapse kernel (None when the native
    library is unavailable); resolved once."""
    global _native_collapse
    if _native_collapse is None:
        try:
            from ..native import load_library

            lib = load_library()
            _native_collapse = lib.rpvg_read_collapse if lib is not None else False
        except Exception:
            _native_collapse = False
    return _native_collapse or None


def read_collapse(
    probs: np.ndarray, counts: np.ndarray, prob_precision: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort rows then merge consecutive rows identical within precision,
    summing their counts (reference :197-259).

    Speed path: the C++ kernel (native/rpvg_native.cpp:rpvg_read_collapse)
    runs the same sort+merge; the numpy fallback merges exact-duplicate
    rows (the common case) in one vectorised prestage.  Both are bitwise
    identical to the row-by-row loop: every member of an exactly-equal
    run receives the same keep/merge decision against the same kept row
    as the run's first member, and read counts are integral so the
    regrouped sums are exact."""
    if probs.shape[0] == 0:
        return probs, counts

    native_fn = _native_read_collapse()
    if native_fn is not None:
        import ctypes

        p = np.array(probs, dtype=np.float64, order="C", copy=True)
        c = np.array(counts, dtype=np.float64, copy=True)
        kept = native_fn(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            p.shape[0], p.shape[1], float(prob_precision),
        )
        return p[:kept], c[:kept]

    order = np.lexsort(np.concatenate([probs, counts[:, None]], axis=1).T[::-1])
    probs = probs[order]
    counts = counts[order]

    same = np.all(probs[1:] == probs[:-1], axis=1)
    uniq_mask = np.concatenate([[True], ~same])
    group_ids = np.cumsum(uniq_mask) - 1
    counts = np.bincount(group_ids, weights=counts)
    probs = probs[uniq_mask]

    keep = [0]
    for i in range(1, probs.shape[0]):
        if np.all(np.abs(probs[keep[-1]] - probs[i]) < prob_precision):
            counts[keep[-1]] += counts[i]
        else:
            keep.append(i)
    return probs[keep], counts[keep]


def native_subset_collapse(dense, noise, counts, col_specs, prob_precision):
    """Derived matrices for several jobs over one cluster through the
    C++ kernel: per job, columns are sums of dense source columns (a
    gather is a singleton sum), noise-normalised and row-collapsed.

    col_specs: per job a list of output columns, each a list of source
    column indices.  Returns per job (full matrix (R', C_out+1) with the
    noise column last, counts (R',)) — bitwise identical to
    read_collapse(add_noise_and_normalize(derived, noise), counts, p)
    (numpy's row sums are sequential below its 128-element pairwise
    blocking, matching the C loop).  Returns None when the native
    library is unavailable."""
    if _native_read_collapse() is None:
        return None
    import ctypes

    from ..native import load_library

    lib = load_library()
    R, C = dense.shape
    n_jobs = len(col_specs)
    job_ncols = np.array([len(spec) for spec in col_specs], dtype=np.int64)
    spec_stream = []
    spec_offsets = np.zeros(n_jobs + 1, dtype=np.int64)
    for j, spec in enumerate(col_specs):
        for col in spec:
            spec_stream.append(len(col))
            spec_stream.extend(col)
        spec_offsets[j + 1] = len(spec_stream)
    spec_stream = np.asarray(spec_stream, dtype=np.int64)

    out_offsets = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum(R * (job_ncols + 1), out=out_offsets[1:])
    out_count_offsets = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum(np.full(n_jobs, R, dtype=np.int64), out=out_count_offsets[1:])

    dense = np.ascontiguousarray(dense, dtype=np.float64)
    noise = np.ascontiguousarray(noise, dtype=np.float64)
    counts = np.ascontiguousarray(counts, dtype=np.float64)
    out_rkeep = np.zeros(n_jobs, dtype=np.int64)
    out_mats = np.empty(int(out_offsets[-1]), dtype=np.float64)
    out_counts = np.empty(int(out_count_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_subset_collapse(
        as_f64(dense), as_f64(noise), as_f64(counts), R, C,
        as_i64(spec_stream), as_i64(spec_offsets), as_i64(job_ncols), n_jobs,
        float(prob_precision), as_i64(out_rkeep), as_f64(out_mats),
        as_i64(out_offsets), as_f64(out_counts), as_i64(out_count_offsets),
    )

    results = []
    for j in range(n_jobs):
        keep = int(out_rkeep[j])
        width = int(job_ncols[j]) + 1
        mat = out_mats[out_offsets[j] : out_offsets[j] + keep * width].reshape(
            keep, width
        )
        cnt = out_counts[out_count_offsets[j] : out_count_offsets[j] + keep]
        results.append((mat, cnt))
    return results


def native_subset_collapse_multi(clusters, jobs, prob_precision):
    """Derived matrices for jobs spanning MANY clusters in one threaded
    native call (native/rpvg_native.cpp:rpvg_subset_collapse_multi).

    clusters: per cluster (dense (R, C), noise (R,), counts (R,)).
    jobs: per job (cluster_index, col_spec) with col_spec a list of
    output columns, each a list of source column indices.

    Returns per job (full matrix (R', C_out+1), counts (R',)) — bitwise
    identical to native_subset_collapse on the job's cluster.  None when
    the native library is unavailable."""
    if _native_read_collapse() is None:
        return None
    import ctypes
    import os

    from ..native import load_library

    lib = load_library()
    if lib is None:
        # The memoised handle above can outlive the library (tests flip
        # it off mid-process); a fresh load is authoritative.
        return None
    n_clusters = len(clusters)
    n_jobs = len(jobs)

    n_rows = np.fromiter((c[0].shape[0] for c in clusters), np.int64, n_clusters)
    n_cols = np.fromiter((c[0].shape[1] for c in clusters), np.int64, n_clusters)
    dense_offsets = np.zeros(n_clusters, dtype=np.int64)
    np.cumsum(n_rows[:-1] * n_cols[:-1], out=dense_offsets[1:])
    row_offsets = np.zeros(n_clusters, dtype=np.int64)
    np.cumsum(n_rows[:-1], out=row_offsets[1:])

    dense_concat = (
        np.concatenate([np.ascontiguousarray(c[0], dtype=np.float64).ravel() for c in clusters])
        if n_clusters else np.empty(0, dtype=np.float64)
    )
    noise_concat = (
        np.concatenate([np.asarray(c[1], dtype=np.float64) for c in clusters])
        if n_clusters else np.empty(0, dtype=np.float64)
    )
    counts_concat = (
        np.concatenate([np.asarray(c[2], dtype=np.float64) for c in clusters])
        if n_clusters else np.empty(0, dtype=np.float64)
    )

    job_cluster = np.fromiter((j[0] for j in jobs), np.int64, n_jobs)
    # A job's col_spec may arrive pre-flattened as (flat int64 array in
    # [len, ids..., len, ids...] layout, n_cols) — callers with repeated
    # or regular specs build/cache those without per-element Python work.
    job_ncols = np.empty(n_jobs, dtype=np.int64)
    flat_specs = []
    for j, (_, spec) in enumerate(jobs):
        if isinstance(spec, tuple):
            flat, ncols = spec
        else:
            ncols = len(spec)
            stream: List[int] = []
            for col in spec:
                stream.append(len(col))
                stream.extend(col)
            flat = np.asarray(stream, dtype=np.int64)
        job_ncols[j] = ncols
        flat_specs.append(flat)
    spec_offsets = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum([f.size for f in flat_specs], out=spec_offsets[1:])
    spec_arr = (
        np.concatenate(flat_specs) if flat_specs else np.empty(0, dtype=np.int64)
    )

    job_rows = n_rows[job_cluster]
    out_offsets = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum(job_rows * (job_ncols + 1), out=out_offsets[1:])
    out_count_offsets = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum(job_rows, out=out_count_offsets[1:])

    out_rkeep = np.zeros(n_jobs, dtype=np.int64)
    out_mats = np.empty(int(out_offsets[-1]), dtype=np.float64)
    out_counts = np.empty(int(out_count_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_subset_collapse_multi(
        as_f64(dense_concat), as_f64(noise_concat), as_f64(counts_concat),
        as_i64(dense_offsets), as_i64(row_offsets), as_i64(n_rows), as_i64(n_cols),
        as_i64(job_cluster), as_i64(spec_arr), as_i64(spec_offsets),
        as_i64(job_ncols), n_jobs,
        float(prob_precision), int(min(16, os.cpu_count() or 1)),
        as_i64(out_rkeep), as_f64(out_mats), as_i64(out_offsets),
        as_f64(out_counts), as_i64(out_count_offsets),
    )

    results = []
    for j in range(n_jobs):
        keep = int(out_rkeep[j])
        width = int(job_ncols[j]) + 1
        mat = out_mats[out_offsets[j] : out_offsets[j] + keep * width].reshape(
            keep, width
        )
        cnt = out_counts[out_count_offsets[j] : out_count_offsets[j] + keep]
        results.append((mat, cnt))
    return results


def path_collapse(probs: np.ndarray, prob_precision: float) -> np.ndarray:
    """Sort columns then merge consecutive near-identical columns
    (reference :261-313)."""
    if probs.shape[1] == 0:
        return probs
    order = np.lexsort(probs[::-1])
    probs = probs[:, order]
    keep = [0]
    for j in range(1, probs.shape[1]):
        if not np.all(np.abs(probs[:, keep[-1]] - probs[:, j]) < prob_precision):
            keep.append(j)
    return probs[:, keep]


def calc_path_log_frequencies(path_counts: Sequence[int]) -> np.ndarray:
    """Log frequency prior from path source counts (reference :315-330)."""
    counts = np.asarray(path_counts, dtype=np.float64)
    total = counts.sum()
    return np.log(counts / total)
