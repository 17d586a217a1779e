"""Whole-population batched inference of the four models on one device
and its data shards (counterpart of ``rpvg_tpu/infer/batched_models.py``).

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

With independent transcript groups (``--ind-hap-inference``),
``batched_haplotype_transcripts_independent`` replaces A-C by I1 (one
matrix per (cluster, transcript group) job), I2 (every job's group
posteriors on the device), I3 (subset sampling on the host) and C (the
task matrices), then runs the same D, D2 and E.

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

import math
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
from rpvg_tpu_torch.parallel import autoshard

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
    """``haplotype-transcripts`` at any ploidy, with or without Gibbs
    sampling: collapsed groups (:func:`batched_haplotype_transcripts`)
    or independent transcript groups
    (:func:`batched_haplotype_transcripts_independent`)."""
    return isinstance(estimator, NestedPathAbundanceEstimator)


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
    """Host-clock phase times; on CUDA each boundary waits for every data
    shard's device so a phase is charged all of its device work.  Also
    keeps, per phase with device dispatches, the tasks or clusters each
    shard took (``autoshard.take_shard_work``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.shard_work: Dict[str, List[int]] = {}
        self.verbose = bool(os.environ.get("RPVG_TPU_PHASE_TIMING"))
        autoshard.take_shard_work()
        self.t0 = time.perf_counter()

    def lap(self, key: str, label: str) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        self.seconds[key] = now - self.t0
        work = autoshard.take_shard_work()
        if work:
            self.shard_work[key] = work
        if self.verbose:
            print(f"  [timing]   {key} {label}: {self.seconds[key]:.2f}s", file=sys.stderr)
        self.t0 = now

    def report(self) -> Dict:
        """``phase_seconds``; ``data_shards``, the shard count of the
        run's device; ``shard_work``, per phase the items each shard took."""
        return {
            "phase_seconds": self.seconds,
            "data_shards": autoshard.num_data_shards(self.device),
            "shard_work": self.shard_work,
        }


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
    if not (supports_batched_nested(estimator) and estimator.infer_collapsed):
        raise NotImplementedError("collapsed groups only (not --ind-hap-inference)")
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

    # Phases D, D2 and E; the key chain continues past the key phase B
    # consumed.
    key_base_of = dict.fromkeys(cluster_tasks, 1 if estimator.use_group_post_gibbs else 0)
    gibbs_jobs = _nested_em_and_gibbs(
        estimator, cluster_data, cluster_tasks, all_tasks, rng_seed, rank_of, key_base_of,
        device, clock,
    )
    return {
        **clock.report(),
        "scored_clusters": len(meta),
        "group_engine": engine,
        **fallback,
        "em_tasks": len(all_tasks),
        "gibbs_jobs": gibbs_jobs,
    }


def batched_haplotype_transcripts_independent(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Dict:
    """Batched independent-group nested inference (--ind-hap-inference)
    on ``device`` (``batched_haplotype_transcripts_independent`` of the
    JAX package, ``batched_models.py:127-393``, which is bitwise the
    per-cluster ``_infer_independent_groups``); mutates the estimates in
    cluster_data in place.  Phases:

    * I1 (host): one matrix per (cluster, transcript group) job, one
      threaded native call;
    * I2 (device): every job's group posteriors through the engines of
      phase B (or, under --use-hap-gibbs, the posterior sampler keyed by
      key ``gi`` of its cluster's chain);
    * I3 (host): subset sampling (:func:`_sample_subsets`);
    * C (host): the task matrices, one threaded native call;
    * D, D2, E as in :func:`batched_haplotype_transcripts`, D2 continuing
      each cluster's numpy stream and key chain where I3 and I2 left them.

    Returns ``phase_seconds``, ``scored_clusters`` (the posterior jobs of
    phase I2), ``group_engine``, the full enumeration's host-engine
    clusters and seconds, ``em_tasks`` and ``gibbs_jobs``."""
    if not (supports_batched_nested(estimator) and not estimator.infer_collapsed):
        raise NotImplementedError("independent groups only (--ind-hap-inference)")
    clock = _PhaseClock(device)
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__

    # Phase I1 (host): one matrix per (cluster, transcript group).
    jobs = []  # (ci, gi, group)
    cluster_groups: Dict[int, List[List[int]]] = {}
    dense_clusters = []
    slot_of_ci: Dict[int, int] = {}
    group_jobs = []
    group_counts_of = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        path_groups = estimator.find_path_groups(est.paths)
        cluster_groups[ci] = path_groups
        slot_of_ci[ci] = len(dense_clusters)
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        for gi, group in enumerate(path_groups):
            flat = np.empty(2 * len(group), dtype=np.int64)
            flat[0::2] = 1
            flat[1::2] = group
            group_jobs.append((slot_of_ci[ci], (flat, len(group))))
            group_counts_of.append([est.paths[i].source_count for i in group])
            jobs.append((ci, gi, group))

    multi = native_subset_collapse_multi(dense_clusters, group_jobs, estimator.prob_precision)
    if multi is not None:
        inputs = [
            (full[:, :-1], full[:, -1], counts, gc)
            for (full, counts), gc in zip(multi, group_counts_of)
        ]
    else:
        inputs = [
            estimator._subset_matrix(
                cluster_data[ci][1], group, len(cluster_data[ci][0].paths)
            ) + (gc,)
            for (ci, _, group), gc in zip(jobs, group_counts_of)
        ]
    clock.lap("I1", f"group matrices ({len(jobs)} jobs)")

    # Phase I2 (device): the group posteriors of every job; under
    # --use-hap-gibbs job gi of a cluster takes key gi of its chain.
    fallback = dict(HOST_ENUMERATION)
    if estimator.use_group_post_gibbs:
        cis = sorted(cluster_groups)
        depth = max((len(cluster_groups[ci]) for ci in cis), default=0)
        chains = prng.key_chains(rng_seed, [rank_of(ci) for ci in cis], depth) if cis else []
        chain_of = {ci: chains[i] for i, ci in enumerate(cis)}
        keys = [chain_of[ci][gi] for ci, gi, _ in jobs]
        results = path_group_posteriors_gibbs_batched(inputs, estimator.group_size, keys, device)
    else:
        results = _group_posteriors_batched(
            inputs, estimator.group_size, estimator.min_hap_prob, device
        )
    engine = _group_engine(estimator.group_size, estimator.use_group_post_gibbs)
    clock.lap("I2", engine)
    fallback = _fallback_since(fallback)

    # Phase I3 (host): subset sampling from each cluster's numpy stream.
    cluster_tasks, all_tasks, key_base_of, np_rng_of = _sample_subsets(
        estimator, cluster_data, cluster_groups, jobs, results, rng_seed, rank_of
    )
    clock.lap("I3", "subset sampling")

    # Phase C (host): every task matrix in one threaded native call.
    fill_jobs = []
    for ci, task in all_tasks:
        collapsed = task["collapsed"]
        flat = np.empty(2 * len(collapsed), dtype=np.int64)
        flat[0::2] = 1
        flat[1::2] = collapsed
        fill_jobs.append((slot_of_ci[ci], (flat, len(collapsed))))
    multi_fill = native_subset_collapse_multi(dense_clusters, fill_jobs, estimator.prob_precision)
    if multi_fill is not None:
        for (_, task), (sub_full, sub_counts) in zip(all_tasks, multi_fill):
            task["matrix"] = sub_full
            task["counts"] = sub_counts
    else:
        for ci, tasks in cluster_tasks.items():
            if tasks:
                estimator.fill_subset_matrices(
                    cluster_data[ci][1], len(cluster_data[ci][0].paths), tasks
                )
    clock.lap("C", f"task fill ({len(all_tasks)} tasks)")

    gibbs_jobs = _nested_em_and_gibbs(
        estimator, cluster_data, cluster_tasks, all_tasks, rng_seed, rank_of, key_base_of,
        device, clock, np_rng_of=np_rng_of,
    )
    return {
        **clock.report(),
        "scored_clusters": len(jobs),
        "group_engine": engine,
        **fallback,
        "em_tasks": len(all_tasks),
        "gibbs_jobs": gibbs_jobs,
    }


def _nested_em_and_gibbs(
    estimator, cluster_data, cluster_tasks, all_tasks, rng_seed, rank_of, key_base_of,
    device, clock, np_rng_of=None,
) -> int:
    """Phases D, D2 (with -n) and E of both nested routes
    (``_nested_em_and_gibbs`` of the JAX package, ``batched_models.py:
    1318-1451``): one EM run over every (cluster, subset) task, the
    read-count Gibbs jobs (:func:`_nested_gibbs`) and the
    posterior-weighted combination per cluster, each lapped on
    ``clock``.  Returns the number of Gibbs jobs."""
    em_inputs = [(task["matrix"], task["counts"]) for _, task in all_tasks]
    em_results, packed = run_batched_em_packed(
        em_inputs, estimator.max_em_its, estimator.max_rel_em_conv, device
    )
    clock.lap(PHASES[3][0], f"{PHASES[3][1]} ({len(all_tasks)} tasks)")

    per_cluster: Dict[int, List] = {}
    for (ci, _), result in zip(all_tasks, em_results):
        per_cluster.setdefault(ci, []).append(result)

    gibbs_jobs = 0
    if estimator.num_gibbs_samples > 0:
        task_index = {id(task): i for i, (_, task) in enumerate(all_tasks)}
        gibbs_jobs = _nested_gibbs(
            estimator, cluster_data, cluster_tasks, per_cluster, rng_seed, rank_of,
            key_base_of, device, packed, task_index, np_rng_of,
        )
        clock.lap(PHASES[4][0], f"{PHASES[4][1]} ({gibbs_jobs} jobs)")

    for ci, tasks in cluster_tasks.items():
        est = cluster_data[ci][0]
        estimator.combine_subset_tasks(est, tasks, per_cluster.get(ci, []))
    clock.lap(*PHASES[5])
    return gibbs_jobs


def _nested_gibbs(
    estimator, cluster_data, cluster_tasks, per_cluster, rng_seed, rank_of, key_base_of,
    device, packed, task_index, np_rng_of=None,
) -> int:
    """Phase D2 of the nested routes (``_nested_em_and_gibbs`` of the
    JAX package, ``batched_models.py:1346-1442``): per cluster the host
    allocates the -n samples over its subsets by sequential binomial
    thinning from the cluster's numpy stream (``np_rng_of[ci]`` where
    an earlier phase drew from it, else a fresh one), each subset with
    samples is a job keyed by the cluster's next key (after the
    ``key_base_of[ci]`` keys the posterior phase took), and every job
    runs in one batched sampler call.  Attaches the samples; returns the
    number of jobs."""
    jobs = []  # (ci, key index in cluster, task, abundances, noise count, samples)
    key_ranks = []
    max_depth = 0
    for ci, tasks in cluster_tasks.items():
        if np_rng_of is not None and ci in np_rng_of:
            np_rng = np_rng_of[ci]
        else:
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
            max_depth = max(max_depth, key_base_of[ci] + key_count)
    if not jobs:
        return 0

    chains = prng.key_chains(rng_seed, [rank_of(ci) for ci in key_ranks], max_depth)
    chain_of = {ci: chains[i] for i, ci in enumerate(key_ranks)}
    inputs = [
        (task["matrix"], task["counts"], np.asarray(abundances), noise_count,
         float(task["counts"].sum()))
        for _, _, task, abundances, noise_count, _ in jobs
    ]
    keys = [chain_of[ci][key_base_of[ci] + key_idx] for ci, key_idx, _, _, _, _ in jobs]
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


def _sample_subsets(estimator, cluster_data, cluster_groups, jobs, results, rng_seed, rank_of):
    """Phase I3 (host) of the independent-group route: per cluster, one
    uniform block of 1/min_hap_prob samples per transcript-group job from
    the cluster's numpy stream, a group set picked per sample, and the
    distinct subsets with their sampled mass.  The body is a verbatim copy
    of ``batched_haplotype_transcripts_independent`` in the JAX package
    (``batched_models.py:211-358``; tests/test_torch_ind_hap.py pins it).
    Returns (cluster_tasks, all_tasks, key_base_of, np_rng_of): the
    subset specs per cluster and in order, the keys phase I2 took per
    cluster, and each cluster's numpy stream, to be continued by phase
    D2."""
    per_cluster_jobs: Dict[int, List] = {}
    for (ci, gi, group), res in zip(jobs, results):
        per_cluster_jobs.setdefault(ci, []).append((group, res))

    num_samples = math.floor(1.0 / estimator.min_hap_prob)
    cluster_tasks: Dict[int, List[dict]] = {}
    all_tasks: List[Tuple[int, dict]] = []
    key_base_of: Dict[int, int] = {}
    np_rng_of: Dict[int, np.random.Generator] = {}
    inc = 1.0 / num_samples
    # repeated_sums[k] = inc added k times to 0.0 (np.cumsum performs
    # the same sequential float64 additions the per-sample loop does, so
    # looking the total up is bitwise identical to adding in a loop).
    repeated_sums = np.empty(num_samples + 1, dtype=np.float64)
    repeated_sums[0] = 0.0
    np.cumsum(np.full(num_samples, inc), out=repeated_sums[1:])
    for ci in cluster_groups:
        est, cluster_probs = cluster_data[ci]
        np_rng = np.random.default_rng((rng_seed, rank_of(ci)))
        # Distinct transcript-group choices repeat across the ~1/p
        # samples, and disjoint groups make the choice tuple determine
        # the subset — so dedup the choice matrix first and expand only
        # unique rows (first-seen order; per-key mass accumulated by the
        # same repeated additions the per-sample loop performs).
        jobs_ci = per_cluster_jobs.get(ci, [])
        choice_cols = []
        decode_cache: List[Dict[int, List[int]]] = []
        # One uniform block per cluster replaces the per-job
        # Generator.choice calls: choice(n, size, p) draws
        # self.random(size) and searchsorts the normalised CDF, so a
        # (jobs, samples) block consumed row-major is the identical
        # stream and the searchsorted picks are bitwise identical
        # (verified against numpy 2.x; per-call validation overhead
        # dominated this loop).
        if jobs_ci:
            uniform_block = np_rng.random((len(jobs_ci), num_samples))
        for j, (group, (groups_g, posteriors)) in enumerate(jobs_ci):
            if len(groups_g) == 1:
                # Single candidate: every sample picks group-set 0 (the
                # job's uniform row was still drawn, keeping the stream
                # aligned with the per-cluster estimator's choice call).
                choice_cols.append(None)
                decode_cache.append({})
                continue
            p = np.asarray(posteriors, dtype=np.float64)
            # Generator.choice's input validation, kept explicitly: a
            # degenerate posterior must fail loudly, not mis-sample
            # (an all-zero vector would make the CDF NaN and searchsorted
            # return an out-of-range choice).
            if not np.isfinite(p).all() or (p < 0).any() or p.sum() <= 0:
                raise ValueError(
                    "group posteriors contain NaN/inf, negative entries, "
                    "or sum to zero"
                )
            p = p / p.sum()
            cdf = p.cumsum()
            cdf /= cdf[-1]
            choice_cols.append(cdf.searchsorted(uniform_block[j], side="right"))
            decode_cache.append({})

        def mapped(j: int, choice: int) -> List[int]:
            # Decode a chosen group-set lazily (only chosen indices are
            # ever needed; eager decoding of every candidate group-set
            # dominated this loop).
            cache = decode_cache[j]
            hit = cache.get(choice)
            if hit is None:
                group, (groups_g, _) = jobs_ci[j]
                hit = [group[l] for l in sorted(groups_g[choice])]
                cache[choice] = hit
            return hit

        subset_probs: Dict[tuple, float] = {}
        if choice_cols:
            # Pack each sample's per-group choices into one integer and
            # dedup with a 1-D unique; first-seen order (and the
            # per-key repeated additions) replicate the per-sample loop.
            sizes = [len(groups_g) for _, (groups_g, _) in jobs_ci]
            space = 1
            for s in sizes:
                space *= s
            if space == 1:
                # Every job has one candidate group-set: all samples
                # pick the same subset (packed would be all zeros).
                rows = [(0, num_samples)]
                decode = True
            elif space <= 2**62:
                packed = np.zeros(num_samples, dtype=np.int64)
                stride = 1
                for col, s in zip(choice_cols, sizes):
                    if col is not None:  # None = all-zero column (s == 1)
                        packed += col.astype(np.int64) * stride
                    stride *= s
                uniq, first_idx, counts = np.unique(
                    packed, return_index=True, return_counts=True
                )
                rows = [
                    (int(uniq[u]), int(counts[u]))
                    for u in np.argsort(first_idx, kind="stable")
                ]
                decode = True
            else:  # pragma: no cover - pathological group counts
                from collections import Counter

                rows = list(
                    Counter(
                        zip(
                            *(
                                c.tolist() if c is not None else [0] * num_samples
                                for c in choice_cols
                            )
                        )
                    ).items()
                )
                decode = False
            for packed_key, cnt in rows:
                subset: List[int] = []
                if decode:
                    rem = packed_key
                    for j, s in enumerate(sizes):
                        subset.extend(mapped(j, rem % s))
                        rem //= s
                else:
                    for j, choice in enumerate(packed_key):
                        subset.extend(mapped(j, choice))
                key = tuple(sorted(subset))
                prev = subset_probs.get(key)
                if prev is None:
                    # inc added cnt times from 0.0, via the lookup table.
                    subset_probs[key] = float(repeated_sums[cnt])
                else:
                    # Resumed accumulation (two choice tuples mapping to
                    # the same sorted subset) must keep the loop's exact
                    # addition order.
                    for _ in range(cnt):
                        prev += inc
                    subset_probs[key] = prev
        else:
            subset_probs[()] = float(repeated_sums[num_samples])

        est.total_count = total_read_count(cluster_probs)
        tasks = estimator.prepare_subset_specs(subset_probs)
        cluster_tasks[ci] = tasks
        all_tasks.extend((ci, task) for task in tasks)
        key_base_of[ci] = (
            len(per_cluster_jobs.get(ci, [])) if estimator.use_group_post_gibbs else 0
        )
        np_rng_of[ci] = np_rng
    return cluster_tasks, all_tasks, key_base_of, np_rng_of


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
    return {**clock.report(), "em_tasks": len(inputs), "gibbs_jobs": gibbs_jobs}


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
    return {**clock.report(), "em_tasks": len(tasks), "gibbs_jobs": gibbs_jobs}


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
        **clock.report(),
        "scored_clusters": len(meta),
        "group_engine": engine,
        **_fallback_since(fallback),
    }
