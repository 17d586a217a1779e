"""Whole-population batched ``haplotype-transcripts`` inference
(counterpart of the staged route of ``rpvg_tpu/infer/batched_models.py``,
``batched_haplotype_transcripts`` with ``RPVG_TPU_FUSED_NESTED=0``).

Five phases over every cluster at once:

* A (host): grouped probability matrices, one threaded native call;
* B (device): diploid pair scoring, selection on the host;
* C (host): subset selection and the EM task matrices;
* D (device): one EM run over every (cluster, subset) task;
* E (host): posterior-weighted combination per cluster.

The fused native route of the JAX package (one C++ call for the whole
chain) is not ported: on the card the staged device route is the one to
measure first.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from rpvg_tpu.infer.matrices import (
    cluster_matrix,
    native_subset_collapse_multi,
    total_read_count,
)
from rpvg_tpu_torch.device import synchronize
from rpvg_tpu_torch.infer.batching import run_batched_em
from rpvg_tpu_torch.infer.estimators import NestedPathAbundanceEstimator
from rpvg_tpu_torch.infer.posteriors import diploid_posteriors_batched

PHASES = (
    ("A", "grouped matrices"),
    ("B", "diploid posteriors"),
    ("C", "subset selection"),
    ("D", "batched EM"),
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
    """Collapsed-group, ploidy-2, non-Gibbs nested inference: the one
    configuration batched_haplotype_transcripts runs."""
    return (
        isinstance(estimator, NestedPathAbundanceEstimator)
        and estimator.infer_collapsed
        and estimator.group_size == 2
        and not estimator.use_group_post_gibbs
        and estimator.num_gibbs_samples == 0
    )


def _group_posteriors_batched(inputs, group_size: int, min_rel_likelihood: float, device):
    """Non-Gibbs group posteriors for many clusters: dense diploid
    scoring (group size 2 is the only one ported)."""
    if group_size == 2:
        return diploid_posteriors_batched(inputs, min_rel_likelihood, device)
    raise NotImplementedError(
        f"group size {group_size} is not yet ported (ROADMAP queue 1, item 10)"
    )


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


def batched_haplotype_transcripts(estimator, cluster_data, device: torch.device) -> Dict:
    """Batched collapsed-group nested inference on ``device``; mutates
    the estimates in cluster_data in place.  Returns the seconds of
    phases A-E (``phase_seconds``), the number of clusters scored in
    phase B (``scored_clusters``) and of EM tasks in phase D
    (``em_tasks``)."""
    if not supports_batched_nested(estimator):
        raise NotImplementedError(
            "only collapsed, ploidy-2, non-Gibbs haplotype-transcripts is ported"
        )
    clock = _PhaseClock(device)
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

    # Phase B (device): dense diploid scoring for every cluster.
    posterior_results = _group_posteriors_batched(
        inputs, estimator.group_size, estimator.min_hap_prob, device
    )
    clock.lap(*PHASES[1])

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
    em_results = run_batched_em(
        em_inputs, estimator.max_em_its, estimator.max_rel_em_conv, device
    )
    clock.lap(PHASES[3][0], f"{PHASES[3][1]} ({len(all_tasks)} tasks)")

    # Phase E (host): posterior-weighted combination per cluster.
    per_cluster: Dict[int, List] = {}
    for (ci, _), result in zip(all_tasks, em_results):
        per_cluster.setdefault(ci, []).append(result)
    for ci, tasks in cluster_tasks.items():
        est = cluster_data[ci][0]
        estimator.combine_subset_tasks(est, tasks, per_cluster.get(ci, []))
    clock.lap(*PHASES[4])
    return {
        "phase_seconds": clock.seconds,
        "scored_clusters": len(meta),
        "em_tasks": len(all_tasks),
    }
