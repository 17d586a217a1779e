"""Whole-population batched inference of the four models on one device
(counterpart of ``rpvg_tpu/infer/batched_models.py``).

``haplotype-transcripts`` (collapsed groups, any ploidy k) is the staged
route of ``batched_haplotype_transcripts`` (``RPVG_TPU_FUSED_NESTED=0``
in the JAX package), five phases over every cluster at once, and a sixth
with read-count Gibbs sampling (``-n``):

* A (host): grouped probability matrices, one threaded native call;
* B (device): the group posteriors: diploid pair scoring with selection
  on the host at k = 2, the full enumeration of k-multisets otherwise;
  or, under ``--use-hap-gibbs``, the collapsed Gibbs sampler (over the
  pair scores at k = 2, over k slots otherwise);
* C (host): subset selection and the EM task matrices;
* D (device): one EM run over every (cluster, subset) task;
* D2 (device): read-count Gibbs sampling of the subsets that the host
  allocates samples to, on the task matrices phase D packed;
* E (host): posterior-weighted combination per cluster.

The other models run a subset of the same phases:

* ``transcripts``: A (noise-normalised matrices), D, D2, E (abundances);
* ``strains``: C (greedy minimum path cover per cluster and the cover
  sub-matrices, the staged route of ``batched_strains``), D, D2, E;
* ``haplotypes``: A (matrices), B, E (posteriors).

Random keys replay the JAX package's per-cluster streams exactly (the
port's threefry, :mod:`rpvg_tpu_torch.prng`): a cluster's keys are
fold_in(seed, rank) split in a chain, and the posterior sampler takes
the first.  The fused native routes of the JAX package (one C++ call for
the whole nested chain, or for the strains host half and its EM) are not
ported: on the card the staged device routes are the ones to measure
first.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from rpvg_tpu_torch import prng
from rpvg_tpu_torch.constants import HAPLOTYPES_MIN_REL_LIKELIHOOD
from rpvg_tpu_torch.infer.matrices import (
    add_noise_and_normalize,
    cluster_matrix,
    construct_probability_matrix,
    native_subset_collapse_multi,
    total_read_count,
)
from rpvg_tpu_torch.device import synchronize
from rpvg_tpu_torch.infer.batching import run_batched_em_packed
from rpvg_tpu_torch.infer.estimators import (
    MinimumPathAbundanceEstimator,
    NestedPathAbundanceEstimator,
    PathAbundanceEstimator,
    PathGroupPosteriorEstimator,
)
from rpvg_tpu_torch.infer.posteriors import (
    HOST_ENUMERATION,
    diploid_posteriors_batched,
    full_posteriors_batched,
    path_group_posteriors_gibbs_batched,
)
from rpvg_tpu_torch.infer.readcount_gibbs import run_batched_gibbs

PHASES = (
    ("A", "grouped matrices"),
    ("B", "group posteriors"),
    ("C", "subset selection"),
    ("D", "batched EM"),
    ("D2", "batched Gibbs"),
    ("E", "combine"),
)

# Flattened [len, ids...] specs for the memoised (shared) group lists
# returned by find_path_source_groups, keyed by object identity — the
# memo holds the lists alive, so ids stay valid; the identity check
# guards against id reuse for non-memoised lists.
_FLAT_SPEC_CACHE: Dict[int, Tuple[list, tuple]] = {}


def _flat_group_spec(groups: List[List[int]]) -> Tuple[np.ndarray, int]:
    """(flat int64 spec, n_cols) for native_subset_collapse_multi."""
    key = id(groups)
    hit = _FLAT_SPEC_CACHE.get(key)
    if hit is not None and hit[0] is groups:
        return hit[1]
    stream: List[int] = []
    for col in groups:
        stream.append(len(col))
        stream.extend(col)
    spec = (np.asarray(stream, dtype=np.int64), len(groups))
    if len(_FLAT_SPEC_CACHE) < 1_000_000:
        _FLAT_SPEC_CACHE[key] = (groups, spec)
    return spec


def supports_batched_nested(estimator) -> bool:
    """Collapsed-group nested inference at any ploidy, with or without
    Gibbs sampling: the configurations batched_haplotype_transcripts
    runs."""
    return isinstance(estimator, NestedPathAbundanceEstimator) and estimator.infer_collapsed


def _group_posteriors_batched(inputs, group_size: int, min_rel_likelihood: float, device):
    """Non-Gibbs group posteriors for many clusters: dense diploid
    scoring at group size 2, exhaustive enumeration otherwise — the
    batched twin of PathPosteriorEstimator._group_posteriors."""
    if group_size == 2:
        return diploid_posteriors_batched(inputs, min_rel_likelihood, device)
    return full_posteriors_batched(inputs, group_size, device)


def _group_engine(group_size: int, gibbs: bool) -> str:
    """Phase B's label: the engine that computes the group posteriors."""
    if gibbs:
        return f"posterior Gibbs, {group_size} slots"
    if group_size == 2:
        return "diploid posteriors"
    return f"full enumeration, group size {group_size}"


def _fallback_since(before: Dict[str, float]) -> Dict:
    """The clusters and seconds of the full enumeration's host engine
    since ``before`` (a copy of ``posteriors.HOST_ENUMERATION``)."""
    now = HOST_ENUMERATION
    return {
        "enumeration_fallback_clusters": int(now["clusters"] - before["clusters"]),
        "enumeration_fallback_seconds": now["seconds"] - before["seconds"],
    }


class _PhaseClock:
    """Host-clock phase times; on CUDA each boundary waits for the
    device so a phase is charged its own device work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.verbose = bool(os.environ.get("RPVG_TPU_PHASE_TIMING"))
        self.t0 = time.perf_counter()

    def lap(self, key: str, label: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        self.seconds[key] = now - self.t0
        if self.verbose:
            print(f"  [timing]   {key} {label}: {self.seconds[key]:.2f}s", file=sys.stderr)
        self.t0 = now


def batched_haplotype_transcripts(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Dict:
    """Batched collapsed-group nested inference on ``device``; mutates
    the estimates in cluster_data in place.  ``ranks`` maps the
    cluster_data index to the cluster's rank (identity when None), which
    with ``rng_seed`` keys its random streams.  Returns the seconds of
    phases A-E and D2 (``phase_seconds``), the number of clusters scored
    in phase B (``scored_clusters``) and its engine (``group_engine``),
    the clusters and seconds of the full enumeration's host engine
    (``enumeration_fallback_clusters``, ``_seconds``), the number of EM
    tasks in phase D (``em_tasks``) and of Gibbs jobs in phase D2
    (``gibbs_jobs``)."""
    if not supports_batched_nested(estimator):
        raise NotImplementedError("only collapsed haplotype-transcripts is ported")
    clock = _PhaseClock(device)
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    # Object writers only: the native output composer reads columnar
    # streams that only the fused native route produces.
    estimator._columnar_outputs = None

    # Phase A (host): grouped probability matrices — one threaded native
    # call across every cluster (per-cluster Python fallback without the
    # library).
    meta: List[Tuple[int, List[List[int]]]] = []
    dense_clusters = []
    group_jobs = []
    source_counts_of = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        source_groups, source_counts = estimator.find_path_source_groups(est.paths)
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        group_jobs.append((len(dense_clusters) - 1, _flat_group_spec(source_groups)))
        source_counts_of.append(source_counts)
        meta.append((ci, source_groups))

    multi = native_subset_collapse_multi(
        dense_clusters, group_jobs, estimator.prob_precision
    )
    inputs = []
    if multi is not None:
        for (full, counts), source_counts in zip(multi, source_counts_of):
            inputs.append((full[:, :-1], full[:, -1], counts, source_counts))
    else:
        for (ci, source_groups), source_counts in zip(meta, source_counts_of):
            g_probs, g_noise, g_counts = estimator._group_posterior_matrix(
                cluster_data[ci][1], source_groups, len(cluster_data[ci][0].paths)
            )
            inputs.append((g_probs, g_noise, g_counts, source_counts))
    clock.lap(*PHASES[0])

    # Phase B (device): dense diploid scoring or the full enumeration for
    # every cluster, or the collapsed Gibbs sampler under --use-hap-gibbs
    # (consuming each cluster's first key, as the per-cluster estimator
    # does).
    fallback = dict(HOST_ENUMERATION)
    if estimator.use_group_post_gibbs:
        posterior_results = path_group_posteriors_gibbs_batched(
            inputs, estimator.group_size,
            prng.first_keys(rng_seed, [rank_of(ci) for ci, _ in meta]), device,
        )
    else:
        posterior_results = _group_posteriors_batched(
            inputs, estimator.group_size, estimator.min_hap_prob, device
        )
    engine = _group_engine(estimator.group_size, estimator.use_group_post_gibbs)
    clock.lap(PHASES[1][0], engine)
    fallback = _fallback_since(fallback)

    # Phase C (host): subset selection, then EM task matrices for every
    # (cluster, subset) in one threaded native call.
    all_tasks: List[Tuple[int, dict]] = []
    cluster_tasks: Dict[int, List[dict]] = {}
    subset_jobs = []
    min_hap_prob = estimator.min_hap_prob
    for slot, ((ci, source_groups), (groups, posteriors)) in enumerate(
        zip(meta, posterior_results)
    ):
        est, cluster_probs = cluster_data[ci]

        subset_probs: Dict[tuple, float] = {}
        total_posterior = 0.0
        for group_set, posterior in zip(groups, posteriors):
            if posterior >= min_hap_prob:
                path_subset: List[int] = []
                for g in group_set:
                    path_subset.extend(source_groups[g])
                key = tuple(sorted(path_subset))
                subset_probs[key] = subset_probs.get(key, 0.0) + float(posterior)
                total_posterior += float(posterior)

        est.total_count = total_read_count(cluster_probs)
        tasks = []
        for key, posterior in subset_probs.items():
            subset_prob = posterior / total_posterior
            if subset_prob < min_hap_prob:
                continue
            collapsed: List[int] = []
            multiplicity: Dict[int, int] = {}
            for pid in key:
                if not collapsed or pid != collapsed[-1]:
                    collapsed.append(pid)
                    multiplicity[pid] = 1
                else:
                    multiplicity[pid] += 1
            task = {
                "subset": key,
                "subset_prob": subset_prob,
                "collapsed": collapsed,
                "multiplicity": multiplicity,
            }
            tasks.append(task)
            flat = np.empty(2 * len(collapsed), dtype=np.int64)
            flat[0::2] = 1
            flat[1::2] = collapsed
            subset_jobs.append((slot, (flat, len(collapsed))))
        cluster_tasks[ci] = tasks
        all_tasks.extend((ci, task) for task in tasks)

    multi = native_subset_collapse_multi(
        dense_clusters, subset_jobs, estimator.prob_precision
    )
    if multi is not None:
        for (_, task), (sub_full, sub_counts) in zip(all_tasks, multi):
            task["matrix"] = sub_full
            task["counts"] = sub_counts
    else:
        for ci, tasks in cluster_tasks.items():
            if tasks:
                estimator.fill_subset_matrices(
                    cluster_data[ci][1], len(cluster_data[ci][0].paths), tasks
                )
    clock.lap(*PHASES[2])

    # Phase D (device): one EM run over every subset task.
    em_inputs = [(task["matrix"], task["counts"]) for _, task in all_tasks]
    em_results, packed = run_batched_em_packed(
        em_inputs, estimator.max_em_its, estimator.max_rel_em_conv, device
    )
    clock.lap(PHASES[3][0], f"{PHASES[3][1]} ({len(all_tasks)} tasks)")

    per_cluster: Dict[int, List] = {}
    for (ci, _), result in zip(all_tasks, em_results):
        per_cluster.setdefault(ci, []).append(result)

    # Phase D2 (device): read-count Gibbs per selected subset; the key
    # chain continues past the key phase B consumed.
    gibbs_jobs = 0
    if estimator.num_gibbs_samples > 0:
        task_index = {id(task): i for i, (_, task) in enumerate(all_tasks)}
        key_base = 1 if estimator.use_group_post_gibbs else 0
        gibbs_jobs = _nested_gibbs(
            estimator, cluster_data, cluster_tasks, per_cluster, rng_seed, rank_of,
            key_base, device, packed, task_index,
        )
        clock.lap(PHASES[4][0], f"{PHASES[4][1]} ({gibbs_jobs} jobs)")

    # Phase E (host): posterior-weighted combination per cluster.
    for ci, tasks in cluster_tasks.items():
        est = cluster_data[ci][0]
        estimator.combine_subset_tasks(est, tasks, per_cluster.get(ci, []))
    clock.lap(*PHASES[5])
    return {
        "phase_seconds": clock.seconds,
        "scored_clusters": len(meta),
        "group_engine": engine,
        **fallback,
        "em_tasks": len(all_tasks),
        "gibbs_jobs": gibbs_jobs,
    }


def _nested_gibbs(
    estimator, cluster_data, cluster_tasks, per_cluster, rng_seed, rank_of, key_base,
    device, packed, task_index,
) -> int:
    """Phase D2 of the nested driver (``_nested_em_and_gibbs`` of the
    JAX package, ``batched_models.py:1346-1442``): per cluster the host
    allocates the -n samples over its subsets by sequential binomial
    thinning from the cluster's numpy stream, each subset with samples is
    a job keyed by the cluster's next key (after the ``key_base`` keys
    phase B took), and every job runs in one batched sampler call.
    Attaches the samples; returns the number of jobs."""
    jobs = []  # (ci, key index in cluster, task, abundances, noise count, samples)
    key_ranks = []
    max_depth = 0
    for ci, tasks in cluster_tasks.items():
        np_rng = np.random.default_rng((rng_seed, rank_of(ci)))
        remaining_gibbs = estimator.num_gibbs_samples
        remaining_prob = 1.0
        key_count = 0
        for task, (abundances, noise_count) in zip(tasks, per_cluster.get(ci, [])):
            if remaining_gibbs > 0:
                n_here = int(
                    np_rng.binomial(
                        remaining_gibbs, min(1.0, task["subset_prob"] / remaining_prob)
                    )
                )
                remaining_gibbs -= n_here
                remaining_prob -= task["subset_prob"]
                if n_here > 0:
                    jobs.append((ci, key_count, task, abundances, noise_count, n_here))
                    key_count += 1
        if key_count:
            key_ranks.append(ci)
            max_depth = max(max_depth, key_base + key_count)
    if not jobs:
        return 0

    chains = prng.key_chains(rng_seed, [rank_of(ci) for ci in key_ranks], max_depth)
    chain_of = {ci: chains[i] for i, ci in enumerate(key_ranks)}
    inputs = [
        (task["matrix"], task["counts"], np.asarray(abundances), noise_count,
         float(task["counts"].sum()))
        for _, _, task, abundances, noise_count, _ in jobs
    ]
    keys = [chain_of[ci][key_base + key_idx] for ci, key_idx, _, _, _, _ in jobs]
    samples = [job[5] for job in jobs]
    reuse = None
    if packed is not None:
        reuse = (packed, [task_index[id(job[2])] for job in jobs])
    results = run_batched_gibbs(
        inputs, keys, samples, estimator.gibbs_thin_its, 1.0, device, packed=reuse
    )
    for (ci, _, task, _, _, _), (noise_samples, path_samples) in zip(jobs, results):
        _attach_gibbs_samples(cluster_data[ci][0], task["collapsed"], noise_samples, path_samples)
    return len(jobs)


def _attach_gibbs_samples(est, path_ids, noise_samples, path_samples) -> None:
    from .estimates import CountSamples

    samples = CountSamples(path_ids=list(path_ids))
    samples.noise_samples = list(map(float, noise_samples))
    samples.abundance_samples = list(map(float, path_samples.reshape(-1)))
    est.gibbs_read_count_samples.append(samples)


def supports_batched_transcripts(estimator) -> bool:
    """``transcripts`` inference, with or without Gibbs sampling."""
    return type(estimator) is PathAbundanceEstimator


def _first_key_gibbs(estimator, cluster_data, meta, gibbs_inputs, path_ids, rng_seed, rank_of,
                     device, packed) -> int:
    """One sampler job per cluster of ``meta``, keyed by the cluster's
    first key (``batched_transcripts`` / ``batched_strains`` of the JAX
    package), on the EM task set phase D packed; attaches the samples and
    returns the number of jobs."""
    if estimator.num_gibbs_samples <= 0 or not meta:
        return 0
    keys = prng.first_keys(rng_seed, [rank_of(ci) for ci in meta])
    reuse = None if packed is None else (packed, np.arange(len(meta)))
    results = run_batched_gibbs(
        gibbs_inputs, keys, estimator.num_gibbs_samples, estimator.gibbs_thin_its, 1.0,
        device, packed=reuse,
    )
    for ci, ids, (noise_samples, path_samples) in zip(meta, path_ids, results):
        _attach_gibbs_samples(cluster_data[ci][0], ids, noise_samples, path_samples)
    return len(meta)


def batched_transcripts(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Dict:
    """Batched ``transcripts`` inference on ``device`` (``batched_
    transcripts`` of the JAX package): one EM run over every cluster,
    then with -n one Gibbs run over every cluster.  Mutates the
    estimates in cluster_data in place; returns ``phase_seconds`` (A, D,
    D2 with -n, E), ``em_tasks`` and ``gibbs_jobs``."""
    if not supports_batched_transcripts(estimator):
        raise NotImplementedError("only transcripts is ported here")
    clock = _PhaseClock(device)
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    inputs = []
    meta = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(len(est.paths), 1)
        if not cluster_probs:
            continue
        probs, noise, counts = construct_probability_matrix(cluster_probs, len(est.paths))
        full_probs = add_noise_and_normalize(probs, noise)
        est.total_count = float(counts.sum())
        inputs.append((full_probs, counts))
        meta.append(ci)
    clock.lap("A", "noise-normalised matrices")

    em_results, packed = run_batched_em_packed(
        inputs, estimator.max_em_its, estimator.max_rel_em_conv, device
    )
    clock.lap("D", f"batched EM ({len(inputs)} tasks)")

    for ci, (abundances, noise_count) in zip(meta, em_results):
        est = cluster_data[ci][0]
        est.abundances = list(map(float, abundances))
        est.noise_count = noise_count

    gibbs_jobs = _first_key_gibbs(
        estimator, cluster_data, meta,
        [
            (probs, counts, np.asarray(abundances), noise_count, cluster_data[ci][0].total_count)
            for (probs, counts), (abundances, noise_count), ci in zip(inputs, em_results, meta)
        ],
        [range(len(cluster_data[ci][0].path_group_sets)) for ci in meta],
        rng_seed, rank_of, device, packed,
    )
    if gibbs_jobs:
        clock.lap("D2", f"batched Gibbs ({gibbs_jobs} jobs)")
    clock.lap("E", "abundances")
    return {"phase_seconds": clock.seconds, "em_tasks": len(inputs), "gibbs_jobs": gibbs_jobs}


def supports_batched_strains(estimator) -> bool:
    """``strains`` inference, with or without Gibbs sampling."""
    return isinstance(estimator, MinimumPathAbundanceEstimator)


def batched_strains(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Dict:
    """Batched ``strains`` inference on ``device`` (the staged route of
    ``batched_strains``): the greedy cover and its sub-matrix per cluster
    on the host, then one EM run over every cover, then with -n one Gibbs
    run over every cover.  Mutates the estimates in cluster_data in
    place; returns ``phase_seconds`` (C, D, D2 with -n, E), ``em_tasks``
    and ``gibbs_jobs``."""
    if not supports_batched_strains(estimator):
        raise NotImplementedError("only strains is ported here")
    clock = _PhaseClock(device)
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    tasks = []
    meta = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(len(est.paths), 1)
        if not cluster_probs:
            continue
        task = estimator.prepare_cover_task(est, cluster_probs)
        if task is None:
            continue
        tasks.append(task)
        meta.append(ci)
    clock.lap("C", "minimum path covers")

    em_results, packed = run_batched_em_packed(
        [(task["matrix"], task["counts"]) for task in tasks],
        estimator.max_em_its,
        estimator.max_rel_em_conv,
        device,
    )
    clock.lap("D", f"batched EM ({len(tasks)} tasks)")

    gibbs_jobs = _first_key_gibbs(
        estimator, cluster_data, meta,
        [
            (task["matrix"], task["counts"], np.asarray(abundances), noise_count, task["total"])
            for task, (abundances, noise_count) in zip(tasks, em_results)
        ],
        [task["min_cover"] for task in tasks], rng_seed, rank_of, device, packed,
    )
    if gibbs_jobs:
        clock.lap("D2", f"batched Gibbs ({gibbs_jobs} jobs)")

    for ci, task, (abundances, noise_count) in zip(meta, tasks, em_results):
        estimator.apply_cover_result(cluster_data[ci][0], task, abundances, noise_count)
    clock.lap("E", "cover abundances")
    return {"phase_seconds": clock.seconds, "em_tasks": len(tasks), "gibbs_jobs": gibbs_jobs}


def supports_batched_haplotypes(estimator) -> bool:
    """``haplotypes`` inference at any ploidy, with or without Gibbs."""
    return isinstance(estimator, PathGroupPosteriorEstimator)


def batched_haplotypes(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Dict:
    """Batched ``haplotypes`` inference on ``device`` (``batched_
    haplotypes`` of the JAX package): under --use-hap-gibbs the collapsed
    Gibbs sampler keyed by each cluster's first key; else at ploidy 2
    dense diploid pair scoring over every cluster with selection on the
    host, and at any other ploidy the full enumeration.  Mutates the
    estimates in cluster_data in place; returns ``phase_seconds`` (A, B,
    E), ``scored_clusters``, ``group_engine`` and the full enumeration's
    host-engine clusters and seconds."""
    if not supports_batched_haplotypes(estimator):
        raise NotImplementedError("only haplotypes is ported here")
    clock = _PhaseClock(device)
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    inputs = []
    meta = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        probs, noise, counts = construct_probability_matrix(cluster_probs, len(est.paths))
        inputs.append((probs, noise, counts, [p.source_count for p in est.paths]))
        meta.append(ci)
    clock.lap("A", "probability matrices")

    fallback = dict(HOST_ENUMERATION)
    if estimator.use_hap_gibbs:
        keys = prng.first_keys(rng_seed, [rank_of(ci) for ci in meta])
        results = path_group_posteriors_gibbs_batched(inputs, estimator.ploidy, keys, device)
    else:
        results = _group_posteriors_batched(
            inputs, estimator.ploidy, HAPLOTYPES_MIN_REL_LIKELIHOOD, device
        )
    engine = _group_engine(estimator.ploidy, estimator.use_hap_gibbs)
    clock.lap("B", engine)

    for ci, (groups, group_posteriors) in zip(meta, results):
        est = cluster_data[ci][0]
        est.path_group_sets = groups
        est.posteriors = list(map(float, group_posteriors))
    clock.lap("E", "posteriors")
    return {
        "phase_seconds": clock.seconds,
        "scored_clusters": len(meta),
        "group_engine": engine,
        **_fallback_since(fallback),
    }
