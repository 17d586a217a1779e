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
* E (host): posterior-weighted combination per cluster, one threaded
  native call (``rpvg_nested_combine``) that leaves the set streams for
  the native output composer.

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
the first.

The JAX package's fused native routes run under its own switches, set
to anything but ``0``: ``RPVG_TPU_FUSED_NESTED`` (collapsed groups at
k = 2 without --use-hap-gibbs: one C++ call for the whole nested chain,
:func:`_batched_haplotype_transcripts_fused`, with its device legs:
bounded-EM escalation, slot routing, task deferral) and
``RPVG_TPU_FUSED_STRAINS`` (one C++ call for the strains host half and
its EM, :func:`_batched_strains_fused`); the read-count Gibbs jobs of
both run on the device.  Unset, the port takes the staged device routes
(the JAX package's default is the fused ones; the port's default waits
for its benchmark).  Every route but ``haplotypes`` leaves columnar
streams in ``estimator._columnar_outputs`` for the native output
composer (``pipeline.write_outputs``); the staged nested routes only
with the native library (else their phase E combines in Python and
leaves None).
"""

from __future__ import annotations

import math
import os
from itertools import chain
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rpvg_tpu_torch import prng, spans
from rpvg_tpu_torch.constants import HAPLOTYPES_MIN_REL_LIKELIHOOD
from rpvg_tpu_torch.infer.matrices import (
    add_noise_and_normalize,
    cluster_matrix,
    construct_probability_matrix,
    native_subset_collapse_multi,
    total_read_count,
)
from rpvg_tpu_torch.device import synchronize
from rpvg_tpu_torch.native import native_available
from rpvg_tpu_torch.infer.batching import (
    dispatch_em_device,
    em_postprocess,
    gather_em_device,
    run_batched_em,
    run_batched_em_packed,
    run_native_em,
)
from rpvg_tpu_torch.infer.estimators import (
    MinimumPathAbundanceEstimator,
    NestedPathAbundanceEstimator,
    PathAbundanceEstimator,
    PathGroupPosteriorEstimator,
)
from rpvg_tpu_torch.infer.posteriors import (
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


class _PhaseClock:
    """Host-clock phase times, each phase a span ``rpvg.phase.<key>``
    (:mod:`rpvg_tpu_torch.spans`); on CUDA each boundary waits for every
    data shard's device so a phase is charged all of its device work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        # A phase is named by the lap that ends it: a profiler session
        # sees it as ``rpvg.phase``.
        self.phase = spans.begin("rpvg.phase")

    def lap(self, key: str, label: str, sync: bool = True) -> None:
        """Charge the time since the last lap to ``key`` (added to what
        it has).  ``sync=False`` leaves the device's queued work running,
        for a lap between a dispatch and the gather that waits for it.
        ``label`` says what the phase did."""
        if sync:
            synchronize(self.device)
        now = spans.clock()
        seconds = self.phase.close(now, f"rpvg.phase.{key}")
        self.seconds[key] = self.seconds.get(key, 0.0) + seconds
        self.phase = spans.begin("rpvg.phase", start=now)

    def discard(self) -> None:
        """End the clock with no further phase (a route's last lap is
        behind it, or it hands over to another route)."""
        self.phase.discard()

    def report(self) -> Dict:
        """``phase_seconds``; ``data_shards``, the shard count of the
        run's device.  Ends the clock."""
        self.discard()
        return {
            "phase_seconds": self.seconds,
            "data_shards": autoshard.num_data_shards(self.device),
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
    the number of EM tasks in phase D (``em_tasks``) and of Gibbs jobs in
    phase D2 (``gibbs_jobs``).  Under ``RPVG_TPU_FUSED_NESTED`` (at k = 2 without
    --use-hap-gibbs, with the native library) the fused native route runs
    instead and returns its own phases and counters
    (:func:`_batched_haplotype_transcripts_fused`)."""
    if not (supports_batched_nested(estimator) and estimator.infer_collapsed):
        raise NotImplementedError("collapsed groups only (not --ind-hap-inference)")
    # Both routes stash their set streams for the native output composer
    # (the staged route's phase E only with the native library).
    estimator._columnar_outputs = None
    if (
        estimator.group_size == 2
        and not estimator.use_group_post_gibbs
        and fused_route_asked("RPVG_TPU_FUSED_NESTED")
        and native_available()
    ):
        stats = _batched_haplotype_transcripts_fused(
            estimator, cluster_data, device, rng_seed, ranks
        )
        if stats is not None:
            return stats
    clock = _PhaseClock(device)
    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__

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

    with spans.Span("rpvg.subset_matrices"):
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

    with spans.Span("rpvg.subset_matrices"):
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
        "em_tasks": len(all_tasks),
        "gibbs_jobs": gibbs_jobs,
    }


def fused_route_asked(variable: str) -> bool:
    """Whether the JAX package's switch ``variable`` asks for a fused
    native route: set to anything but ``0``.  Unset, the port keeps its
    staged device routes on both backends (the JAX package's default is
    the fused route; which default the port takes is decided on its
    benchmark)."""
    return os.environ.get(variable, "0") != "0"


def escalation_min_area(device: torch.device) -> int:
    """``RPVG_TPU_ESC_MIN_AREA``: the least number of matrix elements of
    an escalated set that re-runs on ``device``.  Unset, 0 on a CUDA
    device, where the ragged kernel runs the escalated tail in less time
    than the host's rebatch (``chip_smoke.py`` phase 16 times both), and
    elsewhere the JAX package's 10^12, so that the host rebatch runs."""
    default = 0 if device.type == "cuda" else 10**12
    return int(os.environ.get("RPVG_TPU_ESC_MIN_AREA", default))


def _batched_haplotype_transcripts_fused(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Optional[Dict]:
    """The fused native route of the collapsed diploid nested model on
    ``device`` (``_batched_haplotype_transcripts_fused`` of the JAX
    package, ``batched_models.py:590-789``): grouped matrices, diploid
    posteriors, subset selection, collapse and EM of every cluster in one
    threaded C++ call (``native.nested_diploid_infer``), then per section
    of that call (:func:`_process_nested_section`) the device EM leg, the
    read-count Gibbs jobs (``-n``) and the posterior-weighted combine.
    Returns None, with nothing inferred, where the library is missing.

    The device legs, each under one of the JAX package's variables:

    * bounded-EM escalation (the default, ``RPVG_TPU_EM_BOUND``, 1,024
      iterations): the C++ kernel gives each subset EM a bounded budget
      and hands back the tasks that did not converge in it.  An escalated
      set whose matrices hold at least :func:`escalation_min_area`
      elements re-runs on ``device`` from scratch (:func:`run_batched_em`,
      the ragged kernel on the card); a smaller one re-runs on the host,
      rebatched across worker threads and resumed from the bounded run's
      exit state;
    * slot routing (``RPVG_TPU_DEVICE_SLOT_AREA``, the clusters whose
      dense matrix holds at least that many elements): the routed
      clusters' task matrices come from an emit-only native pass, their
      EM is dispatched to ``device`` without waiting
      (:func:`dispatch_em_device`, the multi-bucket kernel on the card),
      and the full native pass over the other clusters runs while it is
      in flight;
    * task deferral (``RPVG_TPU_HYBRID_EM_AREA``, on any device; the JAX
      package reads it on a TPU alone): tasks of at least that area skip
      the native EM and run on ``device`` (:func:`run_batched_em`).

    A deferral turns the other two legs off, and slot routing the
    escalation, as in the JAX package.  On the CPU the legs take the
    native library as the JAX package does on its CPU
    (``RPVG_TPU_NATIVE_EM=0``: the kernels' plain versions).  Phases:
    ``native`` (the native passes and the dispatch), ``device`` (the
    device legs' EM, with the wait for a dispatch), ``D2`` (with
    -n) and ``combine``.  Returns them with ``route``, ``em_bound``,
    ``em_tasks`` and ``gibbs_jobs``.

    The legs count in the run (:mod:`rpvg_tpu_torch.spans`):
    ``fused.device_em_tasks`` (tasks whose EM ran on the device leg, the
    card on cuda), ``fused.escalated_tasks`` / ``_area`` (tasks the
    bounded EM escalated, their matrices' elements),
    ``fused.escalated_on_device``, ``fused.deferred_tasks`` (tasks the
    area cutoff deferred), ``fused.routed_slots`` / ``_tasks`` /
    ``_area``; the host's time in the slot
    dispatch and in the wait for it are the spans ``rpvg.fused.dispatch``
    and ``rpvg.fused.gather_wait``."""
    from rpvg_tpu_torch import native

    rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
    clock = _PhaseClock(device)

    meta: List[int] = []
    dense_clusters = []
    group_specs = []
    group_src_counts = []
    group_ids = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(0, 0)
        if not cluster_probs:
            continue
        source_groups, source_counts = estimator.find_path_source_groups(est.paths)
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        group_specs.append(_flat_group_spec(source_groups))
        group_src_counts.append(source_counts)
        group_ids.append(
            np.fromiter(
                (info.group_id for info in est.paths), np.int64, len(est.paths)
            )
        )
        meta.append(ci)

    # Task deferral and slot routing (explicit variables only).
    em_area_cutoff = max(0, int(os.environ.get("RPVG_TPU_HYBRID_EM_AREA", "0")))
    device_pos: List[int] = []
    slot_area = int(os.environ.get("RPVG_TPU_DEVICE_SLOT_AREA", "0"))
    if em_area_cutoff == 0 and slot_area > 0:
        areas = np.array([p.shape[0] * p.shape[1] for p, _, _ in dense_clusters], np.int64)
        device_pos = np.flatnonzero(areas >= slot_area).tolist()

    em_bound = 0
    if not device_pos and em_area_cutoff == 0:
        em_bound = int(os.environ.get("RPVG_TPU_EM_BOUND", "1024"))

    emit_matrices = estimator.num_gibbs_samples > 0

    def native_call(positions, cutoff, bound=0):
        return native.nested_diploid_infer(
            [dense_clusters[i] for i in positions],
            [group_specs[i] for i in positions],
            [group_src_counts[i] for i in positions],
            [group_ids[i] for i in positions],
            min_rel_likelihood=estimator.min_hap_prob,
            min_hap_prob=estimator.min_hap_prob,
            prob_precision=estimator.prob_precision,
            max_em_its=estimator.max_em_its,
            max_rel_em_conv=estimator.max_rel_em_conv,
            em_area_cutoff=cutoff,
            em_bound_its=bound,
            emit_matrices=emit_matrices,
        )

    sections = []  # (section meta, streams, pending EM or None)
    if device_pos:
        dev_set = set(device_pos)
        host_pos = [i for i in range(len(meta)) if i not in dev_set]
        # Pass 1 (emit-only: cutoff 1 defers every task), then the device
        # EM goes in flight while pass 2 runs the host share.
        dev_streams = native_call(device_pos, 1)
        if dev_streams is None:
            clock.discard()
            return None
        dev_inputs = _section_task_matrices(dev_streams, emit_matrices)
        with spans.Span("rpvg.fused.dispatch"):
            pending = dispatch_em_device(
                dev_inputs, range(len(dev_inputs)), estimator.max_em_its,
                estimator.max_rel_em_conv, device,
            )
        spans.count("fused.routed_slots", len(device_pos))
        spans.count("fused.routed_tasks", len(dev_inputs))
        spans.count("fused.routed_area", int(sum(m.size for m, _ in dev_inputs)))
        spans.count("fused.device_em_tasks", len(dev_inputs))
        host_streams = native_call(host_pos, 0)
        if host_streams is None:
            clock.discard()
            return None
        sections.append(([meta[i] for i in host_pos], host_streams, None))
        sections.append(
            ([meta[i] for i in device_pos], dev_streams,
             (pending, dev_inputs, list(range(len(dev_inputs)))))
        )
    else:
        streams = native_call(range(len(meta)), em_area_cutoff, em_bound)
        if streams is None:
            clock.discard()
            return None
        sections.append((meta, streams, None))
    clock.lap("native", "fused native pass", sync=False)

    col_parts = [
        _process_nested_section(
            estimator, cluster_data, device, clock, sec_streams, sec_meta, rank_of,
            rng_seed, emit_matrices, sec_pending, stage_floor=em_bound,
        )
        for sec_meta, sec_streams, sec_pending in sections
    ]
    _merge_nested_columnar(estimator, col_parts)
    return {
        **clock.report(),
        "route": "fused native",
        "em_bound": em_bound,
        "em_tasks": int(sum(sec_streams["n_col"].size for _, sec_streams, _ in sections)),
        "gibbs_jobs": sum(part["gibbs_jobs"] for part in col_parts),
    }


def _native_combine_slots(
    cluster_data, meta, noncomb, task_bounds, col_bounds,
    sp_arr, n_col_arr, collapsed_all, mult_all, totals, task_em_result,
):
    """Batch the deferred slots' posterior-weighted combine through the
    native rpvg_nested_combine kernel.  Returns its stream tuple, or
    None when the library is unavailable (Python fallback runs)."""
    from rpvg_tpu_torch.native import nested_combine

    sel_tasks = np.concatenate(
        [np.arange(task_bounds[s], task_bounds[s + 1]) for s in noncomb]
    ).astype(np.int64)
    n_tasks_sub = np.asarray(
        [task_bounds[s + 1] - task_bounds[s] for s in noncomb], dtype=np.int64
    )
    sub_ncol = n_col_arr[sel_tasks]
    sub_col_offsets = np.zeros(sel_tasks.size + 1, dtype=np.int64)
    np.cumsum(sub_ncol, out=sub_col_offsets[1:])
    em_counts_stream = np.empty(int(sub_col_offsets[-1]), dtype=np.float64)
    em_noise_arr = np.empty(sel_tasks.size, dtype=np.float64)
    for k, t in enumerate(sel_tasks):
        path_counts, noise_count = task_em_result(int(t))
        em_counts_stream[sub_col_offsets[k] : sub_col_offsets[k + 1]] = path_counts
        em_noise_arr[k] = noise_count
    cat_cols = lambda src: (  # noqa: E731
        np.concatenate([src[col_bounds[t] : col_bounds[t + 1]] for t in sel_tasks])
        if sel_tasks.size else np.empty(0, dtype=src.dtype)
    )
    gid_arrays = [
        np.fromiter(
            (info.group_id for info in cluster_data[meta[s]][0].paths),
            np.int64,
            len(cluster_data[meta[s]][0].paths),
        )
        for s in noncomb
    ]
    return nested_combine(
        gid_arrays,
        totals[noncomb],
        n_tasks_sub,
        sp_arr[sel_tasks],
        sub_ncol,
        cat_cols(collapsed_all),
        cat_cols(mult_all),
        sub_col_offsets,
        em_counts_stream,
        em_noise_arr,
    )


def _task_matrix_bounds(streams, emit_matrices):
    """CSR bounds into the emitted mats/cnts streams — the Python
    mirror of the kernel's '!run_em || emit_matrices' emission rule
    (one definition, shared by every consumer)."""
    n_col_arr = streams["n_col"]
    kept_arr = streams["kept"]
    has_fracs = streams["has_fracs"].astype(bool)
    T = n_col_arr.size
    has_mat = np.ones(T, dtype=bool) if emit_matrices else ~has_fracs
    mat_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(np.where(has_mat, kept_arr * (n_col_arr + 1), 0), out=mat_bounds[1:])
    cnt_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(np.where(has_mat, kept_arr, 0), out=cnt_bounds[1:])
    return mat_bounds, cnt_bounds


def _section_task_matrices(streams, emit_matrices, task_ids=None):
    """Per-task (matrix, counts) views over a section's emitted
    streams.  `task_ids` selects a subset (default: every task that has
    an emitted matrix — all of them for emit-only sections)."""
    mat_bounds, cnt_bounds = _task_matrix_bounds(streams, emit_matrices)
    kept_arr = streams["kept"]
    n_col_arr = streams["n_col"]
    mats_all = streams["mats"]
    cnts_all = streams["cnts"]
    if task_ids is None:
        task_ids = range(n_col_arr.size)
    return [
        (
            mats_all[mat_bounds[t] : mat_bounds[t + 1]].reshape(
                int(kept_arr[t]), int(n_col_arr[t]) + 1
            ),
            cnts_all[cnt_bounds[t] : cnt_bounds[t + 1]],
        )
        for t in task_ids
    ]


def _process_nested_section(
    estimator, cluster_data, device, clock, streams, meta, rank_of, rng_seed,
    emit_matrices, pre_dispatched, stage_floor=0,
):
    """Decode one native-call section of the fused nested route on
    ``device`` (``_process_nested_section`` of the JAX package,
    ``batched_models.py:880-1236``): the device EM of its deferred tasks
    (a pre-dispatched section's results are gathered here), the
    read-count Gibbs jobs and the per-cluster posterior-weighted combine,
    lapped on ``clock`` as ``device``, ``D2`` and ``combine``; the legs
    count in the run.  Returns the section's columnar-output
    arrays for :func:`_merge_nested_columnar` and its ``gibbs_jobs``."""
    from rpvg_tpu_torch.infer.estimates import GroupSetViews

    totals = streams["totals"]
    n_tasks = streams["n_tasks"]
    sp_arr = streams["subset_prob"]
    n_col_arr = streams["n_col"]
    kept_arr = streams["kept"]
    has_fracs = streams["has_fracs"].astype(bool)
    collapsed_all = streams["collapsed"]
    mult_all = streams["mult"]
    fracs_all = streams["fracs"]
    mats_all = streams["mats"]
    cnts_all = streams["cnts"]

    T = sp_arr.size
    task_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
    np.cumsum(n_tasks, out=task_bounds[1:])
    col_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(n_col_arr, out=col_bounds[1:])
    fr_bounds = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(np.where(has_fracs, n_col_arr + 1, 0), out=fr_bounds[1:])
    mat_bounds, cnt_bounds = _task_matrix_bounds(streams, emit_matrices)

    def task_matrix(t):
        return (
            mats_all[mat_bounds[t] : mat_bounds[t + 1]].reshape(
                int(kept_arr[t]), int(n_col_arr[t]) + 1
            ),
            cnts_all[cnt_bounds[t] : cnt_bounds[t + 1]],
        )

    # Device EM for the deferred tasks.  Pre-dispatched sections (slot
    # routing) gather their in-flight results here; escalation and task deferral run now.
    if pre_dispatched is not None:
        pending, dev_inputs, task_ids = pre_dispatched
        device_results = [None] * len(dev_inputs)
        with spans.Span("rpvg.fused.gather_wait"):
            gather_em_device(pending, dev_inputs, device_results)
        device_of = dict(zip(task_ids, device_results))
    else:
        device_tasks = np.flatnonzero(~has_fracs)
        if device_tasks.size:
            task_inputs = [task_matrix(t) for t in device_tasks]
            # Escalated sets below RPVG_TPU_ESC_MIN_AREA run on the host,
            # rebatched across worker threads; larger ones on the device.
            esc_min_area = escalation_min_area(device)
            total_area = sum(m.size for m, _ in task_inputs)
            if stage_floor > 0:
                spans.count("fused.escalated_tasks", len(task_inputs))
                spans.count("fused.escalated_area", int(total_area))
            else:
                spans.count("fused.deferred_tasks", len(task_inputs))
            if stage_floor > 0 and total_area < esc_min_area:
                # Resume from the bounded run's exit state (emitted by
                # the kernel): bitwise-identical to an uninterrupted
                # run, without re-paying the stage_floor iterations.
                resume = None
                remaining_its = estimator.max_em_its
                esc_conv = streams.get("esc_conv")
                if esc_conv is not None and esc_conv.size == device_tasks.size:
                    widths = n_col_arr[device_tasks] + 1
                    esc_fracs = streams["esc_fracs"]
                    if esc_fracs.size == int(widths.sum()):
                        resume = (esc_fracs, esc_conv)
                        remaining_its = max(1, estimator.max_em_its - stage_floor)
                # Without Gibbs the kernel emits mats/cnts for exactly the
                # escalated tasks in order: hand the streams through.
                concat = (mats_all, cnts_all) if not emit_matrices else None
                device_results = run_native_em(
                    task_inputs, remaining_its, estimator.max_rel_em_conv,
                    resume_state=resume, concat=concat,
                )
            else:
                if stage_floor > 0:
                    spans.count("fused.escalated_on_device", len(task_inputs))
                spans.count("fused.device_em_tasks", len(task_inputs))
                device_results = run_batched_em(
                    task_inputs, estimator.max_em_its, estimator.max_rel_em_conv, device
                )
            device_of = dict(zip(device_tasks.tolist(), device_results))
        else:
            device_of = {}
    clock.lap("device", "fused device EM leg")

    # Post-EM tail (exact run_batched_em/run_native_em semantics): the
    # kernel already folded these results into its per-slot combine;
    # they are re-derived only for the Gibbs sampler's inputs and the
    # combine of the slots whose EM was deferred.
    slot_of_task = np.repeat(np.arange(len(meta)), n_tasks)

    def task_em_result(t):
        if has_fracs[t]:
            # Collapse preserves the (integral) read-count total, so
            # the cluster total is exact for the per-task sum.
            return em_postprocess(
                fracs_all[fr_bounds[t] : fr_bounds[t + 1]],
                float(totals[slot_of_task[t]]),
            )
        return device_of[t]

    # Read-count Gibbs sampling per selected subset (the posterior phase
    # took no keys in this configuration, so each cluster's key chain and
    # numpy stream start fresh at its rank).
    jobs = []  # (slot, key_idx, task_id, n_here)
    if estimator.num_gibbs_samples > 0:
        key_ranks = []
        max_depth = 0
        for slot, ci in enumerate(meta):
            np_rng = np.random.default_rng((rng_seed, rank_of(ci)))
            remaining_gibbs = estimator.num_gibbs_samples
            remaining_prob = 1.0
            key_count = 0
            for t in range(int(task_bounds[slot]), int(task_bounds[slot + 1])):
                if remaining_gibbs > 0:
                    sp = float(sp_arr[t])
                    n_here = int(
                        np_rng.binomial(
                            remaining_gibbs, min(1.0, sp / remaining_prob)
                        )
                    )
                    remaining_gibbs -= n_here
                    remaining_prob -= sp
                    if n_here > 0:
                        jobs.append((slot, key_count, t, n_here))
                        key_count += 1
            if key_count:
                key_ranks.append(ci)
                max_depth = max(max_depth, key_count)

        if jobs:
            chains = prng.key_chains(rng_seed, [rank_of(ci) for ci in key_ranks], max_depth)
            chain_of = {ci: chains[i] for i, ci in enumerate(key_ranks)}

            inputs = []
            keys = []
            for slot, key_idx, t, _ in jobs:
                matrix, counts = task_matrix(t)
                abundances, noise_count = task_em_result(t)
                inputs.append(
                    (matrix, counts, np.asarray(abundances), noise_count, float(totals[slot]))
                )
                keys.append(chain_of[meta[slot]][key_idx])
            for (slot, _, t, n_here), (noise_samples, path_samples) in zip(
                jobs,
                run_batched_gibbs(
                    inputs, keys, [job[3] for job in jobs], estimator.gibbs_thin_its, 1.0,
                    device,
                ),
            ):
                _attach_gibbs_samples(
                    cluster_data[meta[slot]][0],
                    collapsed_all[col_bounds[t] : col_bounds[t + 1]].tolist(),
                    noise_samples[:n_here],
                    path_samples[:n_here],
                )
        clock.lap(PHASES[4][0], f"{PHASES[4][1]} ({len(jobs)} jobs)")

    # Per-cluster posterior-weighted combination: the kernel already
    # combined every slot whose EM ran natively; the slots whose EM was
    # deferred combine in one threaded native call (the per-slot Python
    # combine only without the library).
    combined = streams["combined"].astype(bool)
    n_sets = streams["n_sets"]
    set_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
    np.cumsum(n_sets, out=set_bounds[1:])
    set_lens = streams["set_lens"]
    len_bounds = np.zeros(set_lens.size + 1, dtype=np.int64)
    np.cumsum(set_lens, out=len_bounds[1:])
    set_ids_all = streams["set_ids"]
    set_post_all = streams["set_posteriors"]
    set_ab_all = streams["set_abundances"]

    noncomb = np.flatnonzero(~combined)
    native_combined = None
    if noncomb.size:
        native_combined = _native_combine_slots(
            cluster_data, meta, noncomb, task_bounds, col_bounds,
            sp_arr, n_col_arr, collapsed_all, mult_all, totals,
            task_em_result,
        )
    if native_combined is not None:
        (nc_n_sets, nc_noise, nc_set_lens, nc_set_ids,
         nc_set_post, nc_set_ab) = native_combined
        nc_set_bounds = np.zeros(noncomb.size + 1, dtype=np.int64)
        np.cumsum(nc_n_sets, out=nc_set_bounds[1:])
        nc_len_bounds = np.zeros(nc_set_lens.size + 1, dtype=np.int64)
        np.cumsum(nc_set_lens, out=nc_len_bounds[1:])
        for k, slot in enumerate(noncomb):
            est = cluster_data[meta[slot]][0]
            est.total_count = float(totals[slot])
            lo, hi = int(nc_set_bounds[k]), int(nc_set_bounds[k + 1])
            id_lo, id_hi = int(nc_len_bounds[lo]), int(nc_len_bounds[hi])
            est.path_group_sets = GroupSetViews(nc_set_ids, nc_len_bounds, lo, hi)
            est.posteriors = nc_set_post[lo:hi]
            est.abundances = nc_set_ab[id_lo:id_hi]
            est.noise_count = float(nc_noise[k])

    for slot, ci in enumerate(meta):
        est = cluster_data[ci][0]
        if not combined[slot] and native_combined is not None:
            continue
        total_count = float(totals[slot])
        est.total_count = total_count

        if combined[slot]:
            lo, hi = int(set_bounds[slot]), int(set_bounds[slot + 1])
            id_lo, id_hi = int(len_bounds[lo]), int(len_bounds[hi])
            # Zero-copy views over the kernel's streams (list-equivalent
            # for consumers; the composer reads the streams directly).
            est.path_group_sets = GroupSetViews(set_ids_all, len_bounds, lo, hi)
            est.posteriors = set_post_all[lo:hi]
            est.abundances = set_ab_all[id_lo:id_hi]
            est.noise_count = float(streams["slot_noise"][slot])
            continue

        gid_of = [info.group_id for info in est.paths]
        group_estimates: Dict[tuple, List] = {}
        sum_hap_prob = 0.0

        for t in range(int(task_bounds[slot]), int(task_bounds[slot + 1])):
            path_counts, noise_count = task_em_result(t)

            # combine_subset_tasks semantics (reference
            # inferPathSubsetAbundance :608-750 combine tail), reading
            # collapsed/multiplicity arrays: the expanded sorted subset
            # splits by transcript group in first-seen order, each slot
            # position receiving abundance * prob / multiplicity.
            sp = float(sp_arr[t])
            sum_hap_prob += sp
            est.noise_count += noise_count * sp

            by_group_paths: Dict[int, List[int]] = {}
            by_group_vals: Dict[int, List[float]] = {}
            mult_t = mult_all[col_bounds[t] : col_bounds[t + 1]]
            for j, pid in enumerate(
                collapsed_all[col_bounds[t] : col_bounds[t + 1]].tolist()
            ):
                m = int(mult_t[j])
                g = gid_of[pid]
                contrib = float(path_counts[j]) * sp / m
                paths_list = by_group_paths.get(g)
                if paths_list is None:
                    paths_list = by_group_paths[g] = []
                    by_group_vals[g] = []
                vals_list = by_group_vals[g]
                for _ in range(m):
                    paths_list.append(pid)
                    vals_list.append(contrib)

            for g, group_paths in by_group_paths.items():
                key = tuple(group_paths)
                entry = group_estimates.get(key)
                if entry is None:
                    entry = group_estimates[key] = [0.0, [0.0] * len(group_paths)]
                entry[0] += sp
                vals = by_group_vals[g]
                acc = entry[1]
                for i in range(len(acc)):
                    acc[i] += vals[i]

        est.path_group_sets = []
        est.posteriors = []
        est.abundances = []
        for key, (posterior, path_abundances) in group_estimates.items():
            est.path_group_sets.append(list(key))
            est.posteriors.append(posterior)
            est.abundances.extend(path_abundances)

        est.noise_count += (1.0 - sum_hap_prob) * est.total_count

    if native_combined is not None:
        # Interleave the kernel's set streams (combined slots) with the
        # native-combine streams (deferred slots) in slot order, so the
        # output composer sees every slot natively combined.
        pos_in_nc = {int(s): k for k, s in enumerate(noncomb)}
        lens_segs, post_segs, ids_segs, ab_segs = [], [], [], []
        n_sets_merged = np.empty(len(meta), dtype=np.int64)
        for slot in range(len(meta)):
            if combined[slot]:
                lo, hi = int(set_bounds[slot]), int(set_bounds[slot + 1])
                id_lo, id_hi = int(len_bounds[lo]), int(len_bounds[hi])
                lens_segs.append(set_lens[lo:hi])
                post_segs.append(set_post_all[lo:hi])
                ids_segs.append(set_ids_all[id_lo:id_hi])
                ab_segs.append(set_ab_all[id_lo:id_hi])
                n_sets_merged[slot] = hi - lo
            else:
                k = pos_in_nc[slot]
                lo, hi = int(nc_set_bounds[k]), int(nc_set_bounds[k + 1])
                id_lo, id_hi = int(nc_len_bounds[lo]), int(nc_len_bounds[hi])
                lens_segs.append(nc_set_lens[lo:hi])
                post_segs.append(nc_set_post[lo:hi])
                ids_segs.append(nc_set_ids[id_lo:id_hi])
                ab_segs.append(nc_set_ab[id_lo:id_hi])
                n_sets_merged[slot] = hi - lo
        cat = lambda segs, dt: (  # noqa: E731
            np.concatenate(segs) if segs else np.empty(0, dtype=dt)
        )
        combined = np.ones(len(meta), dtype=bool)
        n_sets = n_sets_merged
        set_lens = cat(lens_segs, np.int64)
        set_ids_all = cat(ids_segs, np.int64)
        set_post_all = cat(post_segs, np.float64)
        set_ab_all = cat(ab_segs, np.float64)

    clock.lap("combine", f"fused combine ({T} tasks)")
    return {
        "gibbs_jobs": len(jobs),
        "meta": meta,
        "combined": combined,
        "n_sets": n_sets,
        "set_lens": set_lens,
        "set_ids": set_ids_all,
        "set_posteriors": set_post_all,
        "set_abundances": set_ab_all,
    }


def _merge_nested_columnar(estimator, col_parts) -> None:
    """Stash the columnar set streams so the output phase can compose
    the estimate files in C++ (pipeline._write_hapjoint_columnar)
    without walking the per-cluster Python objects.  Slots that combined
    in Python (device-routed or EM-deferred) have empty stream segments
    — the composer splices their sets from the estimates — so merging
    sections only interleaves the per-slot meta/flags in cluster order;
    set streams concatenate as-is (the non-combined slots contribute
    nothing and the combined slots stay in ascending cluster order)."""
    parts = [p for p in col_parts if p["meta"]]
    if not parts:
        estimator._columnar_outputs = None
        return
    if len(parts) == 1:
        # Single section: cluster ids are unique, so the (ci, pi, slot)
        # tuple sort reduces to one argsort over the meta array.
        meta_arr = np.asarray(parts[0]["meta"], dtype=np.int64)
        perm = np.argsort(meta_arr)
        meta = meta_arr[perm].tolist()
        combined = np.asarray(parts[0]["combined"], dtype=bool)[perm]
        n_sets = np.asarray(parts[0]["n_sets"], dtype=np.int64)[perm]
        set_lens = parts[0]["set_lens"]
        set_ids = parts[0]["set_ids"]
        set_posteriors = parts[0]["set_posteriors"]
        set_abundances = parts[0]["set_abundances"]
    else:
        order = sorted(
            (
                (ci, pi, slot)
                for pi, p in enumerate(parts)
                for slot, ci in enumerate(p["meta"])
            ),
        )
        meta = [ci for ci, _, _ in order]
        combined = np.array(
            [parts[pi]["combined"][slot] for _, pi, slot in order], dtype=bool
        )
        n_sets = np.array(
            [parts[pi]["n_sets"][slot] for _, pi, slot in order], dtype=np.int64
        )
        # Only combined slots own stream segments; they must land in
        # merged meta order.  Gather each combined slot's segment.
        lens_segs, post_segs, ids_segs, ab_segs = [], [], [], []
        bounds = []
        for p in parts:
            sb = np.zeros(len(p["meta"]) + 1, dtype=np.int64)
            np.cumsum(p["n_sets"], out=sb[1:])
            lb = np.zeros(p["set_lens"].size + 1, dtype=np.int64)
            np.cumsum(p["set_lens"], out=lb[1:])
            bounds.append((sb, lb))
        for _, pi, slot in order:
            p = parts[pi]
            sb, lb = bounds[pi]
            lo, hi = int(sb[slot]), int(sb[slot + 1])
            if lo == hi:
                continue
            lens_segs.append(p["set_lens"][lo:hi])
            post_segs.append(p["set_posteriors"][lo:hi])
            ids_segs.append(p["set_ids"][lb[lo] : lb[hi]])
            ab_segs.append(p["set_abundances"][lb[lo] : lb[hi]])
        cat = lambda segs, dt: (  # noqa: E731
            np.concatenate(segs) if segs else np.empty(0, dtype=dt)
        )
        set_lens = cat(lens_segs, np.int64)
        set_posteriors = cat(post_segs, np.float64)
        set_ids = cat(ids_segs, np.int64)
        set_abundances = cat(ab_segs, np.float64)

    estimator._columnar_outputs = {
        "kind": "sets",
        "meta": meta,
        "combined": combined,
        "n_sets": n_sets,
        "set_lens": set_lens,
        "set_ids": set_ids,
        "set_posteriors": set_posteriors,
        "set_abundances": set_abundances,
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

    Counters, once a call: ``indhap.clusters`` (clusters with jobs),
    ``indhap.jobs``, ``indhap.single_candidate_jobs`` (jobs left with
    one group set), ``indhap.draws`` (jobs x floor(1 / min_hap_prob))
    and ``indhap.subsets`` (the distinct subsets, phase D's tasks).

    Returns ``phase_seconds``, ``scored_clusters`` (the posterior jobs of
    phase I2), ``group_engine``, ``em_tasks`` and ``gibbs_jobs``."""
    if not (supports_batched_nested(estimator) and not estimator.infer_collapsed):
        raise NotImplementedError("independent groups only (--ind-hap-inference)")
    estimator._columnar_outputs = None
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

    with spans.Span("rpvg.subset_matrices"):
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

    # Phase I3 (host): subset sampling from each cluster's numpy stream.
    cluster_tasks, all_tasks, key_base_of, np_rng_of = _sample_subsets(
        estimator, cluster_data, cluster_groups, jobs, results, rng_seed, rank_of
    )
    spans.count("indhap.clusters", len(cluster_groups))
    spans.count("indhap.jobs", len(jobs))
    spans.count(
        "indhap.single_candidate_jobs", sum(len(groups_g) == 1 for groups_g, _ in results)
    )
    spans.count("indhap.draws", len(jobs) * math.floor(1.0 / estimator.min_hap_prob))
    spans.count("indhap.subsets", len(all_tasks))
    clock.lap("I3", "subset sampling")

    # Phase C (host): every task matrix in one threaded native call.
    fill_jobs = []
    for ci, task in all_tasks:
        collapsed = task["collapsed"]
        flat = np.empty(2 * len(collapsed), dtype=np.int64)
        flat[0::2] = 1
        flat[1::2] = collapsed
        fill_jobs.append((slot_of_ci[ci], (flat, len(collapsed))))
    with spans.Span("rpvg.subset_matrices"):
        multi_fill = native_subset_collapse_multi(
            dense_clusters, fill_jobs, estimator.prob_precision
        )
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
    posterior-weighted combination per cluster
    (:func:`_native_combine_clusters`, or ``combine_subset_tasks`` per
    cluster without the native library), each lapped on ``clock``.
    Returns the number of Gibbs jobs."""
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

    columnar = _native_combine_clusters(cluster_data, cluster_tasks, per_cluster)
    if columnar is None:
        for ci, tasks in cluster_tasks.items():
            est = cluster_data[ci][0]
            estimator.combine_subset_tasks(est, tasks, per_cluster.get(ci, []))
    estimator._columnar_outputs = columnar
    clock.lap(*PHASES[5])
    return gibbs_jobs


def _native_combine_clusters(cluster_data, cluster_tasks, per_cluster) -> Optional[Dict]:
    """Phase E of the staged nested routes in one threaded native call
    (``rpvg_nested_combine``, the fused route's combine tail): per
    cluster of ``cluster_tasks`` (ascending cluster-data order) each
    task's EM read counts, times its subset probability over the path's
    multiplicity, fold into the sets split by transcript group in
    first-seen order, and the noise count accumulates in task order; the
    arithmetic of ``combine_subset_tasks``, bit for bit.  Each estimate
    gets zero-copy views over the set streams and its noise count.
    Returns the streams as ``_merge_nested_columnar`` leaves them (every
    slot combined), or None, touching nothing, without the library or
    its symbol."""
    from rpvg_tpu_torch.infer.estimates import GroupSetViews
    from rpvg_tpu_torch.native import nested_combine

    meta = sorted(cluster_tasks)
    if not meta:
        return None
    tasks = [task for ci in meta for task in cluster_tasks[ci]]
    em = [result for ci in meta for result in per_cluster.get(ci, [])]
    n_tasks = np.fromiter((len(cluster_tasks[ci]) for ci in meta), np.int64, len(meta))
    n_col = np.fromiter((len(task["collapsed"]) for task in tasks), np.int64, len(tasks))
    col_offsets = np.zeros(len(tasks) + 1, dtype=np.int64)
    np.cumsum(n_col, out=col_offsets[1:])
    n_cols = int(col_offsets[-1])
    estimates = [cluster_data[ci][0] for ci in meta]
    out = nested_combine(
        [
            np.fromiter((info.group_id for info in est.paths), np.int64, len(est.paths))
            for est in estimates
        ],
        np.fromiter((est.total_count for est in estimates), np.float64, len(meta)),
        n_tasks,
        np.fromiter((task["subset_prob"] for task in tasks), np.float64, len(tasks)),
        n_col,
        np.fromiter(
            chain.from_iterable(task["collapsed"] for task in tasks), np.int64, n_cols
        ),
        np.fromiter(
            chain.from_iterable(
                map(task["multiplicity"].__getitem__, task["collapsed"]) for task in tasks
            ),
            np.int64,
            n_cols,
        ),
        col_offsets,
        np.concatenate([np.asarray(counts, dtype=np.float64) for counts, _ in em])
        if em else np.empty(0, dtype=np.float64),
        np.fromiter((noise for _, noise in em), np.float64, len(em)),
    )
    if out is None:
        return None
    n_sets, noise, set_lens, set_ids, set_posteriors, set_abundances = out
    set_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
    np.cumsum(n_sets, out=set_bounds[1:])
    len_bounds = np.zeros(set_lens.size + 1, dtype=np.int64)
    np.cumsum(set_lens, out=len_bounds[1:])
    id_bounds = len_bounds[set_bounds].tolist()
    set_bounds = set_bounds.tolist()
    for k, (est, noise_count) in enumerate(zip(estimates, noise.tolist())):
        lo, hi = set_bounds[k], set_bounds[k + 1]
        est.path_group_sets = GroupSetViews(set_ids, len_bounds, lo, hi)
        est.posteriors = set_posteriors[lo:hi]
        est.abundances = set_abundances[id_bounds[k] : id_bounds[k + 1]]
        est.noise_count = noise_count
    spans.count("combine.native_slots", len(meta))
    spans.count("combine.sets", int(set_lens.size))
    return {
        "kind": "sets",
        "meta": meta,
        "combined": np.ones(len(meta), dtype=bool),
        "n_sets": n_sets,
        "set_lens": set_lens,
        "set_ids": set_ids,
        "set_posteriors": set_posteriors,
        "set_abundances": set_abundances,
    }


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
    # Per-path abundance streams for the native output composer
    # (singleton group sets after reset(P, 1): one row per path).
    estimator._columnar_outputs = {
        "kind": "perpath",
        "meta": meta,
        "ab": [abundances for abundances, _ in em_results],
    }

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


def _batched_strains_fused(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Optional[Dict]:
    """The fused native route of ``strains`` on ``device``
    (``_batched_strains_fused`` of the JAX package, ``batched_models.py:
    1538-1637``): cover weights, greedy minimum path cover, cover
    sub-matrix collapse and EM of every cluster in one threaded C++ call
    (``native.strains_infer``), then with -n one read-count Gibbs run over
    every cover on ``device``.  Returns None, with nothing inferred, when
    the library is missing.  Phases: ``native``, ``combine`` (the cover
    abundances) and ``D2`` (with -n)."""
    from rpvg_tpu_torch import native

    clock = _PhaseClock(device)
    meta: List[int] = []
    dense_clusters = []
    for ci, (est, cluster_probs) in enumerate(cluster_data):
        est.reset(len(est.paths), 1)
        if not cluster_probs:
            continue
        dense_clusters.append(cluster_matrix(cluster_probs, len(est.paths)))
        meta.append(ci)

    emit = estimator.num_gibbs_samples > 0
    streams = native.strains_infer(
        dense_clusters,
        estimator.prob_precision,
        estimator.max_em_its,
        estimator.max_rel_em_conv,
        emit_matrices=emit,
    )
    if streams is None:
        clock.discard()
        return None
    clock.lap("native", "fused native pass")

    n_cover = streams["n_cover"]
    cover_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
    np.cumsum(n_cover, out=cover_bounds[1:])
    kept = streams["kept"]
    if emit:
        mat_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
        np.cumsum(kept * (n_cover + 1), out=mat_bounds[1:])
        cnt_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
        np.cumsum(kept, out=cnt_bounds[1:])

    covered_slots = [s for s in range(len(meta)) if n_cover[s] > 0]
    for slot in covered_slots:
        ci = meta[slot]
        est = cluster_data[ci][0]
        est.total_count = float(streams["totals"][slot])
        est.noise_count = float(streams["noise"][slot])
        lo, hi = int(cover_bounds[slot]), int(cover_bounds[slot + 1])
        abundances = est.abundances
        for pid, v in zip(
            streams["cover"][lo:hi].tolist(),
            streams["path_counts"][lo:hi].tolist(),
        ):
            abundances[pid] += v
    clock.lap("combine", "cover abundances")

    gibbs_jobs = 0
    if emit and covered_slots:
        rank_of = (lambda ci: ci) if ranks is None else ranks.__getitem__
        keys = prng.first_keys(rng_seed, [rank_of(meta[s]) for s in covered_slots])
        gibbs_inputs = []
        for slot in covered_slots:
            nc = int(n_cover[slot])
            matrix = streams["mats"][mat_bounds[slot] : mat_bounds[slot + 1]].reshape(
                int(kept[slot]), nc + 1
            )
            counts = streams["cnts"][cnt_bounds[slot] : cnt_bounds[slot + 1]]
            lo, hi = int(cover_bounds[slot]), int(cover_bounds[slot + 1])
            gibbs_inputs.append(
                (
                    matrix,
                    counts,
                    streams["path_counts"][lo:hi],
                    float(streams["noise"][slot]),
                    float(streams["totals"][slot]),
                )
            )
        gibbs_results = run_batched_gibbs(
            gibbs_inputs, keys, estimator.num_gibbs_samples, estimator.gibbs_thin_its, 1.0,
            device,
        )
        for slot, (noise_samples, path_samples) in zip(covered_slots, gibbs_results):
            lo, hi = int(cover_bounds[slot]), int(cover_bounds[slot + 1])
            _attach_gibbs_samples(
                cluster_data[meta[slot]][0],
                streams["cover"][lo:hi].tolist(),
                noise_samples,
                path_samples,
            )
        gibbs_jobs = len(covered_slots)
        clock.lap(PHASES[4][0], f"{PHASES[4][1]} ({gibbs_jobs} jobs)")

    estimator._columnar_outputs = {
        "kind": "cover",
        "meta": [meta[s] for s in covered_slots],
        "covers": [
            streams["cover"][cover_bounds[s] : cover_bounds[s + 1]]
            for s in covered_slots
        ],
        "ab": [
            streams["path_counts"][cover_bounds[s] : cover_bounds[s + 1]]
            for s in covered_slots
        ],
    }
    return {
        **clock.report(),
        "route": "fused native",
        "em_tasks": len(covered_slots),
        "gibbs_jobs": gibbs_jobs,
    }


def batched_strains(
    estimator, cluster_data, device: torch.device, rng_seed: int = 0, ranks=None
) -> Dict:
    """Batched ``strains`` inference on ``device`` (the staged route of
    ``batched_strains``): the greedy cover and its sub-matrix per cluster
    on the host, then one EM run over every cover, then with -n one Gibbs
    run over every cover.  Mutates the estimates in cluster_data in
    place; returns ``phase_seconds`` (C, D, D2 with -n, E), ``em_tasks``
    and ``gibbs_jobs``.  Under ``RPVG_TPU_FUSED_STRAINS`` (with the native
    library) the fused native route runs instead
    (:func:`_batched_strains_fused`)."""
    if not supports_batched_strains(estimator):
        raise NotImplementedError("only strains is ported here")
    if fused_route_asked("RPVG_TPU_FUSED_STRAINS") and native_available():
        stats = _batched_strains_fused(estimator, cluster_data, device, rng_seed, ranks)
        if stats is not None:
            return stats
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
    # Per-cover abundance streams for the native output composer.
    estimator._columnar_outputs = {
        "kind": "cover",
        "meta": meta,
        "covers": [task["min_cover"] for task in tasks],
        "ab": [abundances for abundances, _ in em_results],
    }
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
    E), ``scored_clusters`` and ``group_engine``."""
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
    }
