"""Diploid haplotype-group posteriors (the ploidy-2 part of
``rpvg_tpu/infer/posteriors.py``).

Pair scoring runs as a plain torch op on the run's device: for a padded
cluster batch, pair_ll[b, i, j] = sum_r counts[b, r] * log(noise[b, r] +
(P[b, r, i] + P[b, r, j]) / 2) + lf[b, i] + lf[b, j], with -inf where
the argument is <= 0.  In the JAX package this is XLA, not a Pallas
kernel.  Selection (upper triangle, permutation prior, relative cutoff,
normalisation) stays on the host, through the native
``rpvg_diploid_select_ragged`` when the C++ library is loaded.

The mesh-sharded giant-cluster path and the host/device hybrid split of
the JAX package are not ported (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu.infer.matrices import calc_path_log_frequencies

# Clusters whose pair scores were computed, by device type, since the
# last reset (a run can show where phase B ran).
SCORED_CLUSTERS: Dict[str, int] = {"cuda": 0, "cpu": 0}

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


def _diploid_pair_scores_block(probs, noise, counts, log_freqs, half_block, block_log_freqs):
    """Column block of the pair matrix: (P, J) scores against
    half_block (R, J)."""
    half = probs * 0.5
    group = noise[:, None, None] + half[:, :, None] + half_block[:, None, :]
    pair_ll = torch.einsum("r,rij->ij", counts, _log_or_neg_inf(group))
    return pair_ll + log_freqs[:, None] + block_log_freqs[None, :]


def _diploid_pair_scores_batched(probs, noise, counts, log_freqs):
    """(B, P, P) pair log-likelihoods for a padded cluster batch."""
    half = probs * 0.5
    group = noise[:, :, None, None] + half[:, :, :, None] + half[:, :, None, :]
    pair_ll = torch.einsum("br,brij->bij", counts, _log_or_neg_inf(group))
    return pair_ll + log_freqs[:, :, None] + log_freqs[:, None, :]


def _pair_scores_blocked(probs, noise, counts, log_freqs, device: torch.device):
    """(P, P) pair scores of one cluster on ``device``: one dense call
    when (R, P, P) fits the element guard, else column blocks of a
    fixed width."""
    R, P = probs.shape
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
    alone in column blocks.  Returns per cluster (group_sets,
    posteriors)."""
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

    results = [None] * len(cluster_inputs)
    select_jobs = []  # (idx, (P, P) score matrix)
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
            pair_ll_dev = _diploid_pair_scores_batched(
                torch.from_numpy(probs_pad).to(device),
                torch.from_numpy(noise_pad).to(device),
                torch.from_numpy(counts_pad).to(device),
                torch.from_numpy(log_freqs_pad).to(device),
            )
            _count_scored(pair_ll_dev.device, B)
            pair_ll = pair_ll_dev.cpu().numpy()
            for b, idx in enumerate(chunk):
                P = cluster_inputs[idx][0].shape[1]
                select_jobs.append((idx, pair_ll[b, :P, :P]))

    # Giant clusters: per-cluster blocked scoring.
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
    from rpvg_tpu.native import load_library

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
