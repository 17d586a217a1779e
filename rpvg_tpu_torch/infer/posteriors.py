"""Haplotype-group posteriors at every ploidy (counterpart of
``rpvg_tpu/infer/posteriors.py``).

* Ploidy 2: pair scoring runs as a plain torch op on the run's device:
  for a padded cluster batch, pair_ll[b, i, j] = sum_r counts[b, r] *
  log(noise[b, r] + (P[b, r, i] + P[b, r, j]) / 2) + lf[b, i] + lf[b, j],
  with -inf where the argument is <= 0.  In the JAX package this is XLA,
  not a Pallas kernel.  Selection (upper triangle, permutation prior,
  relative cutoff, normalisation) stays on the host, through the native
  ``rpvg_diploid_select_ragged`` when the C++ library is loaded.
* Other ploidies: :func:`full_posteriors_batched` scores every multiset
  of k paths (``ops/group_scores_cuda.py``: ``csrc/group_scores.cu`` on
  the card, the plain version on the CPU); the group prior and the
  normalisation stay on the host in float64.
* ``--use-hap-gibbs``: :func:`path_group_posteriors_gibbs_batched`, the
  pair-score sampler at k = 2 (``csrc/gibbs_posterior.cu``) and the
  k-slot sampler at every other k (``csrc/gibbs_posterior_k.cu``).

Every device dispatch splits over the data shards of
``parallel/autoshard.py``: the padded pair-score chunks whole, each on
the least loaded shard, the group scorer's and the samplers' clusters in
contiguous ranges.  A giant cluster whose (R, P, P) tensor
passes the element guard but fits the guard times the shard count is
scored with its pair matrix's rows split over the shards
(:func:`_pair_scores_sharded`, ``parallel/mesh.py``), as in the JAX
package; with one shard it is scored in column blocks.  The host/device
hybrid split of the JAX package is not ported.
"""

from __future__ import annotations

import math
import time
from itertools import combinations_with_replacement
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu_torch.constants import (
    BURN_ITS_SCALING,
    GIBBS_CHAIN_SCALING,
    GIBBS_ITS_SCALING,
    MIN_BURN_ITS,
    MIN_GIBBS_CHAINS,
    MIN_GIBBS_ITS,
)
from rpvg_tpu_torch.infer.matrices import calc_path_log_frequencies
from rpvg_tpu_torch.mathutils import num_permutations
from rpvg_tpu_torch.parallel import autoshard

# Clusters whose pair or group scores were computed, by device type,
# since the last reset (a run can show where phase B ran).  Clusters of
# the full enumeration's host engine count under "cpu".
SCORED_CLUSTERS: Dict[str, int] = {"cuda": 0, "cpu": 0}

# Clusters whose enumeration exceeded _FULL_ENUM_GROUP_LIMIT and ran the
# per-cluster host engine, and its seconds, since the last reset.
HOST_ENUMERATION: Dict[str, float] = {"clusters": 0, "seconds": 0.0}

# Giant clusters scored with their pair rows split over the data shards
# (_pair_scores_sharded), since the last reset.
SHARDED_PAIR_CLUSTERS = 0

# Memory guard: (R, P, P) tensors above this many elements score in
# column blocks (the reference's giant-cluster branch-and-bound is the
# serial analogue; blocking keeps the dense formulation).
_PAIR_TENSOR_ELEMENT_LIMIT = 1 << 27

# Element bound of one padded (B, R, P, P) batch.
_BATCH_ELEMENT_LIMIT = 1 << 24


def _count_scored(device: torch.device, n: int) -> None:
    SCORED_CLUSTERS[device.type] = SCORED_CLUSTERS.get(device.type, 0) + n


def _normalize_log_posteriors(log_posteriors: np.ndarray) -> np.ndarray:
    max_lp = log_posteriors.max()
    if not np.isfinite(max_lp):
        return np.full_like(log_posteriors, np.nan)
    shifted = np.exp(log_posteriors - max_lp)
    return shifted / shifted.sum()


def _pair_tensor_limit() -> int:
    """RPVG_TPU_PAIR_TENSOR_LIMIT overrides the giant-cluster element
    guard (the multichip dryrun lowers it so the model-axis-sharded and
    blocked paths execute at toy scale)."""
    import os

    env = os.environ.get("RPVG_TPU_PAIR_TENSOR_LIMIT")
    return int(env) if env else _PAIR_TENSOR_ELEMENT_LIMIT


def _ceil_pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _ceil_pow4(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 4
    return size


def _log_or_neg_inf(group: torch.Tensor) -> torch.Tensor:
    positive = group > 0
    return torch.where(
        positive, torch.log(torch.where(positive, group, 1.0)), -math.inf
    )


def _diploid_pair_scores(probs, noise, counts, log_freqs):
    """(P, P) log-likelihood matrix of all ordered diplotype pairs."""
    half = probs * 0.5
    # group_probs[r, i, j] = noise[r] + (probs[r,i] + probs[r,j]) / 2
    group = noise[:, None, None] + half[:, :, None] + half[:, None, :]
    pair_ll = torch.einsum("r,rij->ij", counts, _log_or_neg_inf(group))
    return pair_ll + log_freqs[:, None] + log_freqs[None, :]


def _read_sum(counts, logs):
    """sum_r counts[r] * logs[r, i, j], as the last row of a running sum
    over r: on the CPU each element is added in r order whatever the
    block's shape (a reduction's vector layout, and einsum's choice of
    product, follow the shape), so column blocks and row stripes of one
    cluster give the same bits.  Overwrites ``logs``."""
    return logs.mul_(counts[:, None, None]).cumsum_(dim=0)[-1]


def _diploid_pair_scores_block(probs, noise, counts, log_freqs, half_block, block_log_freqs):
    """Column block of the pair matrix: (P, J) scores against
    half_block (R, J)."""
    half = probs * 0.5
    group = noise[:, None, None] + half[:, :, None] + half_block[:, None, :]
    pair_ll = _read_sum(counts, _log_or_neg_inf(group))
    return pair_ll + log_freqs[:, None] + block_log_freqs[None, :]


def _diploid_pair_scores_rows(probs, noise, counts, log_freqs, half_rows, row_log_freqs):
    """Row stripe of the pair matrix: (I, P) scores of the paths of
    half_rows (R, I) against every path, each element the same bits as
    in :func:`_diploid_pair_scores_block`."""
    half = probs * 0.5
    group = noise[:, None, None] + half_rows[:, :, None] + half[:, None, :]
    pair_ll = _read_sum(counts, _log_or_neg_inf(group))
    return pair_ll + row_log_freqs[:, None] + log_freqs[None, :]


def _pair_scores_sharded(probs, noise, counts, log_freqs, device: torch.device):
    """(P, P) pair scores of one giant cluster with the rows of the pair
    matrix split over the data shards of ``device``
    (``parallel/mesh.sharded_diploid_scores``), so each shard holds
    1/n of the (R, P, P) tensor.  None when there is one shard or the
    tensor passes the element guard times the shard count (the JAX
    package's condition, ``rpvg_tpu/infer/posteriors.py:140-145``)."""
    global SHARDED_PAIR_CLUSTERS
    from rpvg_tpu_torch.parallel.mesh import make_mesh, sharded_diploid_scores

    devices = autoshard.data_devices(device)
    n = len(devices)
    R, P = probs.shape
    if n <= 1 or R * P * P > _pair_tensor_limit() * n:
        return None
    P_pad = -(-P // n) * n
    probs_pad = np.zeros((R, P_pad), dtype=np.float64)
    probs_pad[:, :P] = probs
    freqs_pad = np.full(P_pad, -np.inf)
    freqs_pad[:P] = log_freqs
    scores = sharded_diploid_scores(make_mesh(devices, data=1, model=n))(
        probs_pad, noise, counts, freqs_pad
    )
    SHARDED_PAIR_CLUSTERS += 1
    return scores.cpu().numpy()[:P, :P]


def _diploid_pair_scores_batched(probs, noise, counts, log_freqs):
    """(B, P, P) pair log-likelihoods for a padded cluster batch."""
    half = probs * 0.5
    group = noise[:, :, None, None] + half[:, :, :, None] + half[:, :, None, :]
    pair_ll = torch.einsum("br,brij->bij", counts, _log_or_neg_inf(group))
    return pair_ll + log_freqs[:, :, None] + log_freqs[:, None, :]


def _pair_scores_blocked(probs, noise, counts, log_freqs, device: torch.device):
    """(P, P) pair scores of one cluster on ``device``: one dense call
    when (R, P, P) fits the element guard, else its rows split over the
    data shards (:func:`_pair_scores_sharded`) where that fits, else
    column blocks of a fixed width."""
    R, P = probs.shape
    if R * P * P > _pair_tensor_limit():
        sharded = _pair_scores_sharded(probs, noise, counts, log_freqs, device)
        if sharded is not None:
            return sharded
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(device)  # noqa: E731
    probs_dev = to_dev(probs)
    noise_dev = to_dev(noise)
    counts_dev = to_dev(counts)
    freqs_dev = to_dev(log_freqs)
    if R * P * P <= _pair_tensor_limit():
        return _diploid_pair_scores(probs_dev, noise_dev, counts_dev, freqs_dev).cpu().numpy()
    block = max(8, _pair_tensor_limit() // max(1, R * P))
    block = _ceil_pow2(block) // 2 or 8
    out = np.empty((P, P), dtype=np.float64)
    half = probs * 0.5
    for j0 in range(0, P, block):
        j1 = min(P, j0 + block)
        width = j1 - j0
        half_block = np.zeros((R, block), dtype=probs.dtype)
        half_block[:, :width] = half[:, j0:j1]
        freqs_block = np.full(block, -np.inf)
        freqs_block[:width] = log_freqs[j0:j1]
        scores = _diploid_pair_scores_block(
            probs_dev, noise_dev, counts_dev, freqs_dev,
            to_dev(half_block), to_dev(freqs_block),
        )
        out[:, j0:j1] = scores.cpu().numpy()[:, :width]
    return out


def _diploid_log_likelihoods(probs, noise, counts, log_freqs, device: torch.device):
    """All P*(P+1)/2 diplotype log-likelihoods.  Inputs are zero-padded
    to power-of-two shapes (padded rows get unit noise and zero counts;
    padded paths -inf prior), as in the JAX package."""
    R, P = probs.shape
    R_pad, P_pad = _ceil_pow2(R), _ceil_pow2(P)
    probs_pad = np.zeros((R_pad, P_pad), dtype=np.float64)
    probs_pad[:R, :P] = probs
    noise_pad = np.ones(R_pad, dtype=np.float64)
    noise_pad[:R] = noise
    counts_pad = np.zeros(R_pad, dtype=np.float64)
    counts_pad[:R] = counts
    log_freqs_pad = np.full(P_pad, -np.inf)
    log_freqs_pad[:P] = log_freqs

    pair_ll = _pair_scores_blocked(
        probs_pad, noise_pad, counts_pad, log_freqs_pad, device
    )[:P, :P]
    iu = np.triu_indices(P)
    log_liks = pair_ll[iu].copy()
    # Heterozygous pairs carry the 2-permutation prior factor.
    log_liks[iu[0] != iu[1]] += math.log(2.0)
    groups = [[int(i), int(j)] for i, j in zip(*iu)]
    return groups, log_liks


def path_group_posteriors_diploid(
    probs: np.ndarray,
    noise: np.ndarray,
    counts: np.ndarray,
    path_counts: Sequence[int],
    min_rel_likelihood: float,
    device: torch.device,
) -> Tuple[List[List[int]], np.ndarray]:
    """Diploid posterior of one cluster with the reference's
    relative-likelihood cutoff: pairs below max * min_rel_likelihood
    carry zero posterior and are dropped from the reported group sets."""
    log_freqs = calc_path_log_frequencies(path_counts)
    groups, log_liks = _diploid_log_likelihoods(probs, noise, counts, log_freqs, device)
    _count_scored(device, 1)

    max_ll = log_liks.max()
    keep = log_liks - max_ll >= math.log(min_rel_likelihood)
    kept_groups = [g for g, k in zip(groups, keep) if k]
    posteriors = _normalize_log_posteriors(log_liks[keep])
    return kept_groups, posteriors


def _diploid_select(pair_ll: np.ndarray, min_rel_likelihood: float):
    """Upper-triangle extraction + permutation prior + relative cutoff
    (shared by the device and native scoring paths)."""
    P = pair_ll.shape[0]
    iu = np.triu_indices(P)
    log_liks = pair_ll[iu].copy()
    log_liks[iu[0] != iu[1]] += math.log(2.0)
    max_ll = log_liks.max()
    keep = log_liks - max_ll >= math.log(min_rel_likelihood)
    groups = [[int(i), int(j)] for i, j, k in zip(iu[0], iu[1], keep) if k]
    return groups, _normalize_log_posteriors(log_liks[keep])


def _bucket_plan(cluster_inputs):
    """Clusters by padded (rows to powers of four, paths to powers of
    two) shape, and the giant clusters whose padded (R, P, P) tensor
    exceeds the element guard."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    giant_idx: List[int] = []
    pair_limit = _pair_tensor_limit()
    for idx, (probs, _, _, _) in enumerate(cluster_inputs):
        R, P = probs.shape
        R_pad, P_pad = _ceil_pow4(R), _ceil_pow2(P)
        if R_pad * P_pad * P_pad > pair_limit:
            giant_idx.append(idx)
            continue
        buckets.setdefault((R_pad, P_pad), []).append(idx)
    return buckets, giant_idx


def _score_chunks(cluster_inputs, buckets, devices: Sequence[torch.device]):
    """Yield (cluster indices, (B, P_pad, P_pad) pair scores on a device,
    shard index) per chunk of at most 2**24 padded pair-tensor elements
    of each bucket, each chunk whole on the shard with the least padded
    work so far.  A chunk is not split: cuBLAS may pick another product
    for another batch count (a last-bit difference measured on an H100),
    and a whole chunk keeps every cluster's bits, whatever the shard
    count."""
    load = [0] * len(devices)
    for (R_pad, P_pad), indices in buckets.items():
        max_batch = max(1, _BATCH_ELEMENT_LIMIT // max(1, R_pad * P_pad * P_pad))
        for chunk_start in range(0, len(indices), max_batch):
            chunk = indices[chunk_start : chunk_start + max_batch]
            B = len(chunk)
            probs_pad = np.zeros((B, R_pad, P_pad), dtype=np.float64)
            noise_pad = np.ones((B, R_pad), dtype=np.float64)
            counts_pad = np.zeros((B, R_pad), dtype=np.float64)
            log_freqs_pad = np.full((B, P_pad), -np.inf, dtype=np.float64)
            for b, idx in enumerate(chunk):
                probs, noise, counts, path_counts = cluster_inputs[idx]
                R, P = probs.shape
                probs_pad[b, :R, :P] = probs
                noise_pad[b, :R] = noise
                counts_pad[b, :R] = counts
                log_freqs_pad[b, :P] = calc_path_log_frequencies(path_counts)
            shard = load.index(min(load))
            load[shard] += B * R_pad * P_pad * P_pad
            device = devices[shard]
            pair_ll_dev = _diploid_pair_scores_batched(
                torch.from_numpy(probs_pad).to(device),
                torch.from_numpy(noise_pad).to(device),
                torch.from_numpy(counts_pad).to(device),
                torch.from_numpy(log_freqs_pad).to(device),
            )
            _count_scored(pair_ll_dev.device, B)
            yield chunk, pair_ll_dev, shard


def _diploid_posteriors_native(cluster_inputs, min_rel_likelihood: float):
    """CPU speed path: fused ragged pair scoring + selection +
    normalisation on worker threads (no padding, no shape buckets, no
    per-cluster Python) — identical to scoring then _diploid_select.
    Returns None when the C++ library is unavailable or disabled
    (RPVG_TPU_NATIVE_EM=0 governs the CPU native kernels)."""
    import ctypes
    import os

    from .batching import native_em_available

    if not native_em_available():
        return None
    from rpvg_tpu_torch.native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    if n == 0:
        return []
    n_rows = np.fromiter((p.shape[0] for p, _, _, _ in cluster_inputs), np.int64, n)
    n_cols = np.fromiter((p.shape[1] for p, _, _, _ in cluster_inputs), np.int64, n)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])
    tri = n_cols * (n_cols + 1) // 2
    tri_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(tri, out=tri_offsets[1:])

    probs_concat = np.concatenate(
        [np.ascontiguousarray(p, dtype=np.float64).ravel() for p, _, _, _ in cluster_inputs]
    )
    noise_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, x, _, _ in cluster_inputs]
    )
    counts_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, _, x, _ in cluster_inputs]
    )
    # log frequency priors, segment-normalised in one vectorised pass.
    pc_concat = np.concatenate(
        [np.asarray(pc, dtype=np.float64) for _, _, _, pc in cluster_inputs]
    )
    seg_totals = np.add.reduceat(pc_concat, col_offsets[:-1])
    lf_concat = np.log(pc_concat / np.repeat(seg_totals, n_cols))

    out_nkeep = np.zeros(n, dtype=np.int64)
    out_pairs = np.empty(2 * int(tri_offsets[-1]), dtype=np.int32)
    out_post = np.empty(int(tri_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_diploid_posteriors_ragged(
        as_f64(probs_concat), as_f64(noise_concat), as_f64(counts_concat),
        as_f64(lf_concat), as_i64(mat_offsets), as_i64(row_offsets),
        as_i64(col_offsets), as_i64(tri_offsets), as_i64(n_rows), as_i64(n_cols),
        n, float(min_rel_likelihood), int(min(16, os.cpu_count() or 1)),
        as_i64(out_nkeep),
        out_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        as_f64(out_post),
    )

    results = []
    for b in range(n):
        kept = int(out_nkeep[b])
        base = int(tri_offsets[b])
        pairs = out_pairs[2 * base : 2 * (base + kept)].reshape(kept, 2)
        groups = pairs.tolist()
        results.append((groups, out_post[base : base + kept]))
    return results


def diploid_posteriors_batched(
    cluster_inputs,
    min_rel_likelihood: float,
    device: torch.device,
):
    """Diploid posteriors for many clusters, scored on ``device``.

    cluster_inputs: per cluster (probs (R, P), noise (R,), counts (R,),
    path_counts).  Clusters are bucketed into padded shapes (rows to
    powers of four, paths to powers of two) and scored a chunk of at
    most 2**24 padded pair-tensor elements at a time; a cluster whose
    padded (R, P, P) tensor exceeds the giant-cluster guard is scored
    alone, its pair rows split over the data shards or in column blocks.
    The chunks spread over the data shards of ``device``.  On ``cpu``
    the native library scores, selects and normalises every cluster
    (the JAX package's route off the TPU, so the same bits) unless
    ``RPVG_TPU_NATIVE_EM=0`` or the library is missing.
    Returns per cluster (group_sets, posteriors)."""
    if device.type == "cpu":
        native_results = _diploid_posteriors_native(cluster_inputs, min_rel_likelihood)
        if native_results is not None:
            _count_scored(device, len(cluster_inputs))
            return native_results
    buckets, giant_idx = _bucket_plan(cluster_inputs)
    results = [None] * len(cluster_inputs)
    select_jobs = []  # (idx, (P, P) score matrix)
    devices = autoshard.data_devices(device)
    per_shard = [0] * len(devices)
    for chunk, pair_ll_dev, shard in _score_chunks(cluster_inputs, buckets, devices):
        per_shard[shard] += len(chunk)
        pair_ll = pair_ll_dev.cpu().numpy()
        for b, idx in enumerate(chunk):
            P = cluster_inputs[idx][0].shape[1]
            select_jobs.append((idx, pair_ll[b, :P, :P]))
    autoshard.record(per_shard)

    # Giant clusters: per-cluster sharded or blocked scoring.
    for idx in giant_idx:
        probs, noise, counts, path_counts = cluster_inputs[idx]
        results[idx] = path_group_posteriors_diploid(
            probs, noise, counts, path_counts, min_rel_likelihood, device
        )

    native = _native_diploid_select(
        [m for _, m in select_jobs], min_rel_likelihood
    )
    if native is not None:
        for (idx, _), res in zip(select_jobs, native):
            results[idx] = res
    else:
        for idx, scores in select_jobs:
            results[idx] = _diploid_select(scores, min_rel_likelihood)
    return results


def _native_diploid_select(score_matrices, min_rel_likelihood: float):
    """Batched selection + normalisation over precomputed (P, P) pair
    score matrices through the native kernel; None without the
    library.  Identical to _diploid_select per matrix."""
    import ctypes
    import os

    from .batching import native_em_available

    if not native_em_available():
        return None
    from rpvg_tpu_torch.native import load_library

    lib = load_library()
    n = len(score_matrices)
    if n == 0:
        return []
    n_cols = np.fromiter((m.shape[0] for m in score_matrices), np.int64, n)
    score_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * n_cols, out=score_offsets[1:])
    tri_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * (n_cols + 1) // 2, out=tri_offsets[1:])
    scores_concat = np.concatenate(
        [np.ascontiguousarray(m, dtype=np.float64).ravel() for m in score_matrices]
    )
    out_nkeep = np.zeros(n, dtype=np.int64)
    out_pairs = np.empty(2 * int(tri_offsets[-1]), dtype=np.int32)
    out_post = np.empty(int(tri_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_diploid_select_ragged(
        as_f64(scores_concat), as_i64(score_offsets), as_i64(tri_offsets),
        as_i64(n_cols), n, float(min_rel_likelihood),
        int(min(16, os.cpu_count() or 1)), as_i64(out_nkeep),
        out_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), as_f64(out_post),
    )

    results = []
    for b in range(n):
        kept = int(out_nkeep[b])
        base = int(tri_offsets[b])
        pairs = out_pairs[2 * base : 2 * (base + kept)].reshape(kept, 2)
        results.append((pairs.tolist(), out_post[base : base + kept]))
    return results


# ---------------------------------------------- full group enumeration


def path_group_posteriors_full(
    probs: np.ndarray,
    noise: np.ndarray,
    counts: np.ndarray,
    path_counts: Sequence[int],
    group_size: int,
) -> Tuple[List[List[int]], np.ndarray]:
    """Posterior over every multiset of `group_size` paths, one cluster
    on the host (the JAX package's function; its group-size-2 branch
    scores the pairs on the CPU)."""
    P = probs.shape[1]
    log_freqs = calc_path_log_frequencies(path_counts)

    if group_size == 1:
        # Vectorised marginal case: (R, P) directly.
        with np.errstate(divide="ignore"):
            log_liks = counts @ np.log(noise[:, None] + probs)
        log_liks = log_liks + log_freqs
        groups = [[i] for i in range(P)]
        return groups, _normalize_log_posteriors(log_liks)

    if group_size == 2:
        groups, log_liks = _diploid_log_likelihoods(
            probs, noise, counts, log_freqs, torch.device("cpu")
        )
        return groups, _normalize_log_posteriors(log_liks)

    groups = [list(c) for c in combinations_with_replacement(range(P), group_size)]
    log_liks = np.empty(len(groups), dtype=np.float64)
    for g, group in enumerate(groups):
        group_probs = noise + probs[:, group].sum(axis=1) / group_size
        with np.errstate(divide="ignore"):
            ll = float(counts @ np.log(group_probs))
        ll += float(log_freqs[list(group)].sum())
        ll += math.log(num_permutations(group))
        log_liks[g] = ll
    return groups, _normalize_log_posteriors(log_liks)


def _log_permutations_rows(groups: np.ndarray) -> np.ndarray:
    """log permutation prior per row of sorted index tuples — the
    reference's n! / (n - u + 1)! with u unique values (src/utils.hpp:
    95-117, mirrored by mathutils.num_permutations), NOT the multinomial
    coefficient.  Exact integer arithmetic so the float matches
    math.log(num_permutations(group))."""
    G, k = groups.shape
    if k == 1:
        return np.zeros(G, dtype=np.float64)
    uniques = 1 + (groups[:, 1:] != groups[:, :-1]).sum(axis=1)
    denom = np.array(
        [math.factorial(k - u + 1) for u in range(1, k + 1)], dtype=np.int64
    )
    return np.log(math.factorial(k) // denom[uniques - 1])


# Enumeration explodes combinatorially with ploidy; buckets whose padded
# group count exceeds this fall back to the per-cluster host engine.
_FULL_ENUM_GROUP_LIMIT = 1 << 17


def full_posteriors_batched(cluster_inputs, group_size: int, device: torch.device):
    """Exhaustive group-posterior enumeration over many clusters (the
    ``haplotypes`` and ``haplotype-transcripts`` posteriors at group size
    k != 2 without Gibbs): the log-likelihood of every multiset of k of a
    cluster's P paths, in ``combinations_with_replacement(range(P), k)``
    order, scored on ``device`` by :func:`rpvg_tpu_torch.ops.
    group_scores_cuda.group_scores` (the CUDA kernel on ``cuda``, the
    plain version in the JAX package's padded buckets on ``cpu``), then
    the group prior and the normalisation on the host in float64.  A
    cluster whose padded enumeration comb(P_pad + k - 1, k) exceeds
    ``_FULL_ENUM_GROUP_LIMIT`` runs :func:`path_group_posteriors_full` on
    the host instead (counted in ``HOST_ENUMERATION``).

    cluster_inputs: per cluster (probs (R, P), noise (R,), counts (R,),
    path_counts).  Returns per cluster (groups, posteriors)."""
    from rpvg_tpu_torch.ops import group_scores_cuda

    results = [None] * len(cluster_inputs)
    scored = []
    t0 = time.perf_counter()
    for ci, (probs, noise, counts, path_counts) in enumerate(cluster_inputs):
        P_pad = _ceil_pow2(probs.shape[1])
        if math.comb(P_pad + group_size - 1, group_size) > _FULL_ENUM_GROUP_LIMIT:
            results[ci] = path_group_posteriors_full(probs, noise, counts, path_counts, group_size)
            HOST_ENUMERATION["clusters"] += 1
            _count_scored(torch.device("cpu"), 1)
        else:
            scored.append(ci)
    HOST_ENUMERATION["seconds"] += time.perf_counter() - t0
    if not scored:
        return results

    # Contiguous ranges of the scored clusters per data shard, balanced by
    # rows times groups; every shard launched before any is read.
    devices = autoshard.data_devices(device)
    work = [
        (cluster_inputs[ci][0].shape[0],
         math.comb(cluster_inputs[ci][0].shape[1] + group_size - 1, group_size))
        for ci in scored
    ]
    ranges = autoshard.shard_tasks(work, len(devices))
    launched = []
    for (lo, hi), shard_device in zip(ranges, devices):
        if hi > lo:
            clusters = group_scores_cuda.make_clusters(
                [cluster_inputs[ci][:3] for ci in scored[lo:hi]], group_size, shard_device
            )
            launched.append((scored[lo:hi], clusters, group_scores_cuda.group_scores(clusters)))
            _count_scored(shard_device, hi - lo)
    autoshard.record([hi - lo for lo, hi in ranges])
    for members, clusters, scores in launched:
        scores = scores.cpu().numpy()
        out_offsets = clusters.host["out_offsets"]
        for b, ci in enumerate(members):
            probs, _, _, path_counts = cluster_inputs[ci]
            groups = group_scores_cuda.group_table(probs.shape[1], group_size)
            log_freqs = calc_path_log_frequencies(path_counts)
            ll = (
                scores[out_offsets[b] : out_offsets[b + 1]]
                + log_freqs[groups].sum(axis=1)
                + _log_permutations_rows(groups)
            )
            results[ci] = (groups.tolist(), _normalize_log_posteriors(ll))
    return results


# ------------------------------------------------- posterior Gibbs


def _native_pair_scores(cluster_inputs):
    """Raw (P, P) pair log-likelihood matrices per cluster through the
    native ragged scorer; None when the library is unavailable."""
    import ctypes
    import os

    from .batching import native_em_available

    if not native_em_available():
        return None
    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    if n == 0:
        return []
    n_rows = np.array([p.shape[0] for p, _, _, _ in cluster_inputs], dtype=np.int64)
    n_cols = np.array([p.shape[1] for p, _, _, _ in cluster_inputs], dtype=np.int64)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * n_cols, out=out_offsets[1:])

    probs_concat = np.concatenate(
        [np.ascontiguousarray(p, dtype=np.float64).ravel() for p, _, _, _ in cluster_inputs]
    )
    noise_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, x, _, _ in cluster_inputs]
    )
    counts_concat = np.concatenate(
        [np.asarray(x, dtype=np.float64) for _, _, x, _ in cluster_inputs]
    )
    lf_concat = np.concatenate(
        [calc_path_log_frequencies(pc) for _, _, _, pc in cluster_inputs]
    )
    out = np.empty(int(out_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_diploid_scores_ragged(
        as_f64(probs_concat), as_f64(noise_concat), as_f64(counts_concat),
        as_f64(lf_concat), as_i64(mat_offsets), as_i64(row_offsets),
        as_i64(col_offsets), as_i64(out_offsets), as_i64(n_rows), as_i64(n_cols),
        n, int(min(16, os.cpu_count() or 1)), as_f64(out),
    )

    return [
        out[out_offsets[i] : out_offsets[i + 1]].reshape(int(n_cols[i]), int(n_cols[i]))
        for i in range(n)
    ]


def gibbs_iteration_counts(group_size: int, num_paths: int) -> Tuple[int, int, int]:
    """Chain/burn-in/sample sizing scaled to problem size (reference
    path_estimator.cpp:4-11,501-503)."""
    scale = group_size * num_paths
    chains = MIN_GIBBS_CHAINS + round(GIBBS_CHAIN_SCALING * scale)
    burn = MIN_BURN_ITS + round(BURN_ITS_SCALING * scale)
    its = MIN_GIBBS_ITS + round(GIBBS_ITS_SCALING * scale)
    return chains, burn, its


def _posterior_gibbs_native(cluster_inputs, rng_keys):
    """CPU speed path for diploid posterior Gibbs: pair-score matrices
    are the cached conditionals (the +lf[other] row constant cancels in
    the categorical), so chains sample cached rows in C++.  Returns None
    when the native library is unavailable."""
    import ctypes
    import os

    matrices = _native_pair_scores(cluster_inputs)
    if matrices is None:
        return None
    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    sizing = [
        gibbs_iteration_counts(2, item[0].shape[1]) for item in cluster_inputs
    ]
    n_cols = np.array([item[0].shape[1] for item in cluster_inputs], dtype=np.int64)
    chains = np.array([s[0] for s in sizing], dtype=np.int64)
    burn = np.array([s[1] for s in sizing], dtype=np.int64)
    its = np.array([s[2] for s in sizing], dtype=np.int64)
    score_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols * n_cols, out=score_offsets[1:])
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(chains * its * 2, out=out_offsets[1:])
    seeds = np.array(
        [
            (np.uint64(np.asarray(key).astype(np.uint64)[0]) << np.uint64(32))
            | np.uint64(np.asarray(key).astype(np.uint64)[1])
            for key in rng_keys
        ],
        dtype=np.uint64,
    )
    scores_concat = np.concatenate([m.ravel() for m in matrices])
    out = np.empty(int(out_offsets[-1]), dtype=np.int32)

    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_posterior_gibbs_ragged(
        scores_concat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        as_i64(score_offsets), as_i64(n_cols), as_i64(chains), as_i64(burn),
        as_i64(its), seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        as_i64(out_offsets), n, int(min(16, os.cpu_count() or 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )

    # Normalise + dedup the sampled diplotypes natively (the twin of
    # np.sort(axis=1) + np.unique(axis=0, return_counts=True), which
    # dominated this configuration's host time).
    if not getattr(lib, "_pair_dedup_configured", False):
        lib.rpvg_pair_dedup_ragged.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rpvg_pair_dedup_ragged.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._pair_dedup_configured = True
    import struct as _struct

    dd_len = ctypes.c_int64()
    dd_ptr = lib.rpvg_pair_dedup_ragged(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        as_i64(out_offsets), n, int(min(16, os.cpu_count() or 1)),
        ctypes.byref(dd_len),
    )
    try:
        data = ctypes.string_at(dd_ptr, dd_len.value)
    finally:
        lib.rpvg_buffer_free(dd_ptr)
    (n_out,) = _struct.unpack_from("<q", data, 0)
    assert n_out == n
    n_unique = np.frombuffer(data, dtype=np.int64, count=n, offset=8)
    offset = 8 + 8 * n
    (uniq_total,) = _struct.unpack_from("<q", data, offset)
    offset += 8
    pairs_all = np.frombuffer(
        data, dtype=np.int32, count=2 * uniq_total, offset=offset
    ).reshape(-1, 2)
    offset += 8 * uniq_total
    counts_all = np.frombuffer(data, dtype=np.int64, count=uniq_total, offset=offset)
    bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_unique, out=bounds[1:])

    results = []
    for i in range(n):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        groups = pairs_all[lo:hi].tolist()
        results.append((groups, counts_all[lo:hi] / float(chains[i] * its[i])))
    return results


def _dedup_pairs(samples: np.ndarray, out_offsets: np.ndarray, chains, its):
    """Per cluster (sorted unique pairs, sample frequencies) of the
    sampled pairs at ``out_offsets`` (int32 offsets, two per pair): each
    pair sorted, then counted, through the native
    ``rpvg_pair_dedup_ragged`` as ``_posterior_gibbs_native`` does."""
    import ctypes
    import os
    import struct

    from rpvg_tpu_torch.native import load_library

    n = len(chains)

    lib = load_library()
    if not getattr(lib, "_pair_dedup_configured", False):
        lib.rpvg_pair_dedup_ragged.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rpvg_pair_dedup_ragged.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib._pair_dedup_configured = True
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    offsets = np.ascontiguousarray(out_offsets, dtype=np.int64)
    dd_len = ctypes.c_int64()
    dd_ptr = lib.rpvg_pair_dedup_ragged(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        int(min(16, os.cpu_count() or 1)), ctypes.byref(dd_len),
    )
    try:
        data = ctypes.string_at(dd_ptr, dd_len.value)
    finally:
        lib.rpvg_buffer_free(dd_ptr)
    n_unique = np.frombuffer(data, dtype=np.int64, count=n, offset=8)
    offset = 8 + 8 * n
    (uniq_total,) = struct.unpack_from("<q", data, offset)
    offset += 8
    pairs_all = np.frombuffer(data, dtype=np.int32, count=2 * uniq_total, offset=offset).reshape(-1, 2)
    offset += 8 * uniq_total
    counts_all = np.frombuffer(data, dtype=np.int64, count=uniq_total, offset=offset)
    bounds = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_unique, out=bounds[1:])
    return [
        (
            pairs_all[bounds[i] : bounds[i + 1]].tolist(),
            counts_all[bounds[i] : bounds[i + 1]] / float(chains[i] * its[i]),
        )
        for i in range(n)
    ]


def posterior_gibbs_jobs(cluster_inputs, rng_keys, device: torch.device):
    """The clusters' pair scores on ``device`` (the padded chunks of
    :func:`_score_chunks`, read in place at their padded row stride;
    giant clusters scored alone in column blocks) as
    :class:`~rpvg_tpu_torch.ops.posterior_gibbs_cuda.PosteriorJobs`,
    sized by :func:`gibbs_iteration_counts` and seeded from the keys."""
    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.ops import posterior_gibbs_cuda

    n = len(cluster_inputs)
    buckets, giant_idx = _bucket_plan(cluster_inputs)
    pieces = []
    offsets = np.zeros(n, dtype=np.int64)
    strides = np.zeros(n, dtype=np.int64)
    base = 0
    for chunk, pair_ll_dev, _ in _score_chunks(cluster_inputs, buckets, (device,)):
        P_pad = pair_ll_dev.shape[-1]
        pieces.append(pair_ll_dev.reshape(-1))
        for b, idx in enumerate(chunk):
            offsets[idx] = base + b * P_pad * P_pad
            strides[idx] = P_pad
        base += pair_ll_dev.numel()
    for idx in giant_idx:
        probs, noise, counts, path_counts = cluster_inputs[idx]
        R, P = probs.shape
        R_pad, P_pad = _ceil_pow2(R), _ceil_pow2(P)
        probs_pad = np.zeros((R_pad, P_pad), dtype=np.float64)
        probs_pad[:R, :P] = probs
        noise_pad = np.ones(R_pad, dtype=np.float64)
        noise_pad[:R] = noise
        counts_pad = np.zeros(R_pad, dtype=np.float64)
        counts_pad[:R] = counts
        log_freqs_pad = np.full(P_pad, -np.inf)
        log_freqs_pad[:P] = calc_path_log_frequencies(path_counts)
        scores = _pair_scores_blocked(probs_pad, noise_pad, counts_pad, log_freqs_pad, device)
        _count_scored(device, 1)
        pieces.append(torch.from_numpy(np.ascontiguousarray(scores[:P, :P])).to(device).reshape(-1))
        offsets[idx] = base
        strides[idx] = P
        base += P * P
    n_cols = np.array([item[0].shape[1] for item in cluster_inputs], dtype=np.int64)
    scores_all = torch.cat(pieces) if pieces else torch.zeros(0, dtype=torch.float64, device=device)
    return posterior_gibbs_cuda.make_jobs(
        scores_all, offsets, strides, n_cols,
        [gibbs_iteration_counts(2, int(P)) for P in n_cols],
        [prng.key_seed(key) for key in rng_keys],
    )


def posterior_gibbs_k_jobs(cluster_inputs, group_size: int, rng_keys, device: torch.device):
    """The clusters' k-slot sampler inputs on ``device``
    (:class:`~rpvg_tpu_torch.ops.posterior_gibbs_k_cuda.KSlotJobs`), sized
    by :func:`gibbs_iteration_counts` and seeded from the keys."""
    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.ops import posterior_gibbs_k_cuda

    return posterior_gibbs_k_cuda.make_jobs(
        [(p, n, c, calc_path_log_frequencies(pc)) for p, n, c, pc in cluster_inputs],
        group_size,
        [gibbs_iteration_counts(group_size, item[0].shape[1]) for item in cluster_inputs],
        [prng.key_seed(key) for key in rng_keys],
        device,
    )


def _group_sample_posteriors(samples: np.ndarray, host, group_size: int):
    """Per cluster (sorted unique groups, sample frequencies) of the
    k-slot sampler's output (host int32, ``host["out_offsets"]``):
    burn-in sliced off, each sample sorted, then counted, as the JAX
    package's ``path_group_posteriors_gibbs_batched`` does."""
    results = []
    for b, (chains, burn, its) in enumerate(
        zip(host["n_chains"], host["n_burn"], host["n_its"])
    ):
        lo, hi = host["out_offsets"][b], host["out_offsets"][b + 1]
        kept = samples[lo:hi].reshape(chains, burn + its, group_size)[:, burn:, :]
        kept = np.sort(kept, axis=2).reshape(-1, group_size)
        unique, sample_counts = np.unique(kept, axis=0, return_counts=True)
        groups = [list(map(int, row)) for row in unique]
        results.append((groups, sample_counts / float(chains * its)))
    return results


def path_group_posteriors_gibbs_batched(cluster_inputs, group_size, rng_keys, device: torch.device):
    """Collapsed-Gibbs group posteriors of many clusters on ``device``
    (cluster_inputs: per cluster (probs (R, P), noise (R,), counts (R,),
    path_counts); one threefry key per cluster).  Returns per cluster
    (sorted unique groups, sample frequencies).

    Group size 2: on ``cpu`` the native sampler runs
    (:func:`_posterior_gibbs_native`, a verbatim copy: the JAX package's
    bytes), or without the library the plain version; on ``cuda`` the
    pair scores are computed on the card and sampled there by
    ``csrc/gibbs_posterior.cu``.  Every other group size runs the k-slot
    sampler: ``csrc/gibbs_posterior_k.cu`` on ``cuda``, its plain version
    on ``cpu`` (the JAX package has no native sampler there).  The
    clusters split over the data shards of ``device``."""
    from rpvg_tpu_torch.ops import posterior_gibbs_cuda, posterior_gibbs_k_cuda

    if not cluster_inputs:
        return []
    if group_size == 2 and device.type == "cpu":
        native = _posterior_gibbs_native(cluster_inputs, rng_keys)
        if native is not None:
            return native
    # Contiguous ranges of clusters per data shard, balanced by rows times
    # the chain steps' path scans; every shard launched before any is read.
    devices = autoshard.data_devices(device)
    work = []
    for probs, _, _, _ in cluster_inputs:
        chains, burn, its = gibbs_iteration_counts(group_size, probs.shape[1])
        work.append((probs.shape[0], chains * (burn + its) * probs.shape[1]))
    ranges = autoshard.shard_tasks(work, len(devices))
    launched = []
    for (lo, hi), shard_device in zip(ranges, devices):
        if hi == lo:
            continue
        if group_size != 2:
            jobs = posterior_gibbs_k_jobs(cluster_inputs[lo:hi], group_size, rng_keys[lo:hi],
                                          shard_device)
            launched.append((jobs, posterior_gibbs_k_cuda.posterior_gibbs_k(jobs)))
        else:
            jobs = posterior_gibbs_jobs(cluster_inputs[lo:hi], rng_keys[lo:hi], shard_device)
            launched.append((jobs, posterior_gibbs_cuda.posterior_gibbs(jobs)))
    autoshard.record([hi - lo for lo, hi in ranges])
    results = []
    for jobs, samples in launched:
        samples = samples.cpu().numpy()
        if group_size != 2:
            results.extend(_group_sample_posteriors(samples, jobs.host, group_size))
        else:
            results.extend(_dedup_pairs(samples, jobs.host["out_offsets"], jobs.host["n_chains"],
                                        jobs.host["n_its"]))
    return results
