"""Plain reference of the ``haplotype-transcripts`` model with haplotypes
inferred per transcript (``--ind-hap-inference``, no Gibbs sampling):
from the generated inputs to the rows of ``<prefix>.txt`` and
``<prefix>_joint.txt``.

It follows rpvg's description of ``NestedPathAbundanceEstimator::
inferAbundancesIndependentGroups`` and ``sampleGroupPathIndices``
(``src/path_abundance_estimator.cpp:356-426, 548-567``).  The fragment
pass, the re-fit, the clusters and their ranks, the read-path
probabilities and the EM are those of the collapsed route
(:mod:`bench_port.reference.haplotype_transcripts`).  Per cluster, in
rank order:

1. jobs: one per transcript (the info TSV's Transcript column), in the
   order of each transcript's first path, the cluster's paths in panel
   order; a job's paths keep that order;
2. per job, the read-path matrix of its paths' columns with each read's
   noise probability, scaled to 1 - noise, the noise column appended,
   rows collapsed as in the collapsed route;
3. per job, the posterior of every multiset of ``ploidy`` of its paths
   (at ploidy 2 the pairs (0, 0), (0, 1), ..., (1, 1), ..., in that
   order), each path's prior being its share of the job's haplotype
   count (the number of haplotypes that carry it), a heterozygous
   multiset's the number of its permutations; at ploidy 2 the pairs
   below ``min_hap_prob`` times the best likelihood are dropped;
4. ``floor(1 / min_hap_prob)`` draws per job, one multiset each; draw s
   of every job together make sample s, and a sample's subset is the
   sorted union of the paths its multisets list (a homozygous pick lists
   its path twice);
5. the distinct subsets in the order they are first drawn, each
   weighted by its sampled mass, ``1 / floor(1 / min_hap_prob)`` added
   once per sample that drew it, starting from 0; subsets under
   ``min_hap_prob`` are dropped;
6. one EM per subset, and the posterior-weighted combination split by
   transcript, as in the collapsed route.

**The draws.**  rpvg draws from ``std::mt19937``, whose stream neither
package reproduces.  The system's contract for ``-r`` is one NumPy
stream per cluster, ``numpy.random.default_rng((rng_seed, rank))``
with ``rank`` the ClusterID less one.  The stream gives one block
``random((jobs, draws))`` of uniforms, row j being job j's draws in
sample order, and each draw picks the first multiset whose normalised
cumulative posterior exceeds the uniform (``searchsorted(cdf, u,
side="right")``, the cdf the cumulative sum of the posteriors over their
sum, divided by its last entry).  The reference draws the same stream
from its own posteriors: a float64 difference of about 1e-12 changes a
pick only where a uniform falls that close to a boundary, so the
estimate files agree pick for pick, and one wrong pick moves a
haplotype probability by at least ``1 / draws``.

The estimates run per cluster on the worker processes, from the dense
probability matrix on in ``dtype`` (:func:`expected`): float64 is the
reference, float32 the control."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from bench_port.reference.fragment_pass import Workers
from bench_port.reference.haplotype_transcripts import (  # noqa: F401  (cluster: the harness's entry)
    Clusters,
    Expected,
    _chunks,
    _postprocess,
    add_noise_and_normalize,
    cluster,
    dense_matrix,
    em_fractions,
    group_posteriors,
    read_collapse,
)
from bench_port.reference.probabilities import PROB_PRECISION, merged, read_probs

# Tasks of one EM call at most (their matrices' elements): the EM stacks
# every task of a padded shape at once.
EM_BATCH_ELEMENTS = 1 << 24


def transcript_jobs(paths) -> List[List[int]]:
    """The cluster's path indices by transcript, in order of each
    transcript's first path."""
    jobs: Dict[int, List[int]] = {}
    for i, path in enumerate(paths):
        jobs.setdefault(path.group_id, []).append(i)
    return list(jobs.values())


def sample_subsets(rng_seed: int, rank: int, job_sets, job_posteriors,
                   num_samples: int) -> Dict[tuple, float]:
    """The distinct subsets of one cluster in the order they are first
    drawn, with their sampled mass (the module's contract for ``-r``).
    ``job_sets[j]`` lists job j's multisets as path indices of the
    cluster, ``job_posteriors[j]`` their posteriors."""
    rng = np.random.default_rng((rng_seed, rank))
    uniforms = rng.random((len(job_sets), num_samples))
    picks = []
    for sets, posts, row in zip(job_sets, job_posteriors, uniforms):
        p = np.asarray(posts, dtype=np.float64)
        cdf = np.cumsum(p / p.sum())
        cdf /= cdf[-1]
        picks.append(np.searchsorted(cdf, row, side="right").tolist())
    inc = 1.0 / num_samples
    masses: Dict[tuple, float] = {}
    subset_of: Dict[tuple, tuple] = {}
    for draw in zip(*picks):
        key = subset_of.get(draw)
        if key is None:
            key = subset_of[draw] = tuple(sorted(
                pid for sets, pick in zip(job_sets, draw) for pid in sets[pick]))
        masses[key] = masses.get(key, 0.0) + inc
    return masses


def _em_batches(em_inputs):
    """``em_inputs`` cut into consecutive runs of at most
    :data:`EM_BATCH_ELEMENTS` matrix elements (one task at least)."""
    batch, size = [], 0
    for task in em_inputs:
        if batch and size + task[0].size > EM_BATCH_ELEMENTS:
            yield batch
            batch, size = [], 0
        batch.append(task)
        size += task[0].size
    if batch:
        yield batch


def _infer_clusters(args):
    """Worker task: the estimates of a chunk of clusters,
    (ClusterID, path group sets, posteriors, abundances, noise count,
    tasks) each."""
    chunk, frag_log_probs, run, dtype_name = args
    dtype = np.dtype(dtype_name)

    def frag_log_prob(length: int) -> float:
        return float(frag_log_probs[length])

    ploidy = int(run["ploidy"])
    min_hap_prob = float(run.get("min_hap_prob", 0.001))
    num_samples = math.floor(1.0 / min_hap_prob)
    rng_seed = int(run["rng_seed"])
    states = []
    em_inputs = []
    for cid, paths, cluster_entries in chunk:
        state = {"cid": cid, "paths": paths, "tasks": [], "total": 0.0}
        states.append(state)
        eff = [p.effective_length for p in paths]
        deduped = merged([read_probs(compact, count, eff, frag_log_prob)
                          for compact, count in cluster_entries])
        if not deduped:
            continue
        dense, noise, counts = dense_matrix(deduped, len(paths))
        state["total"] = float(counts.sum())
        dense, noise, counts = dense.astype(dtype), noise.astype(dtype), counts.astype(dtype)
        job_sets, job_posteriors = [], []
        for job in transcript_jobs(paths):
            full, job_counts = read_collapse(add_noise_and_normalize(dense[:, job], noise), counts)
            sets, posts = group_posteriors(full[:, :-1], full[:, -1], job_counts,
                                           [len(paths[pid].source_ids) for pid in job],
                                           ploidy, min_hap_prob)
            job_sets.append([[job[i] for i in sorted(s)] for s in sets])
            job_posteriors.append(posts)
        masses = sample_subsets(rng_seed, cid - 1, job_sets, job_posteriors, num_samples)
        for key, subset_prob in masses.items():
            if subset_prob < min_hap_prob:
                continue
            collapsed, multiplicity = [], {}
            for pid in key:
                if not collapsed or pid != collapsed[-1]:
                    collapsed.append(pid)
                    multiplicity[pid] = 1
                else:
                    multiplicity[pid] += 1
            em_inputs.append(read_collapse(add_noise_and_normalize(dense[:, collapsed], noise), counts))
            state["tasks"].append({"subset": key, "subset_prob": subset_prob,
                                   "collapsed": collapsed, "multiplicity": multiplicity})
    max_its = int(run.get("max_em_its", 10000))
    max_rel = float(run.get("max_rel_em_conv", 0.001))
    fracs = iter([f for batch in _em_batches(em_inputs)
                  for f in em_fractions(batch, max_its, max_rel, dtype)])
    sub_counts = iter(c for _, c in em_inputs)
    out = []
    for state in states:
        paths = state["paths"]
        group_estimates: Dict[tuple, list] = {}
        noise_count = 0.0
        sum_hap = 0.0
        for task in state["tasks"]:
            abundances, task_noise = _postprocess(next(fracs), float(next(sub_counts).astype(np.float64).sum()))
            p = task["subset_prob"]
            sum_hap += p
            noise_count += task_noise * p
            col_of = {pid: j for j, pid in enumerate(task["collapsed"])}
            by_group: Dict[int, List[int]] = {}
            for pid in task["subset"]:
                by_group.setdefault(paths[pid].group_id, []).append(pid)
            for group_paths in by_group.values():
                entry = group_estimates.setdefault(tuple(group_paths), [0.0, [0.0] * len(group_paths)])
                entry[0] += p
                for i, pid in enumerate(group_paths):
                    entry[1][i] += float(abundances[col_of[pid]]) * p / task["multiplicity"][pid]
        noise_count += (1.0 - sum_hap) * state["total"]
        out.append((state["cid"], [list(k) for k in group_estimates],
                    [v[0] for v in group_estimates.values()],
                    [a for v in group_estimates.values() for a in v[1]], noise_count,
                    len(state["tasks"])))
    return out


def expected(clusters: Clusters, run: dict, workers: Workers, dtype=np.float64) -> Expected:
    """The rows of every cluster, the estimates computed in ``dtype``
    on ``workers``."""
    ploidy = int(run["ploidy"])
    parts = workers.map(_infer_clusters, [(chunk, clusters.frag_log_probs, run, np.dtype(dtype).name)
                                          for chunk in _chunks(clusters.ranked, 4 * workers.size)])
    estimates = {r[0]: r[1:] for part in parts for r in part}
    paths_of = {cid: paths for cid, paths, _ in clusters.ranked}

    normaliser = 0.0
    for cid, (sets, _, abundances, _, _) in estimates.items():
        paths = paths_of[cid]
        it = iter(abundances)
        for group_set in sets:
            for pid in group_set:
                a = next(it)
                if paths[pid].effective_length > 0:
                    normaliser += a / paths[pid].effective_length

    def tpm(count, eff):
        return count / eff / normaliser * 1e6 if eff > 0 else 0.0

    out_paths, out_joint = {}, {}
    noise_total = 0.0
    em_tasks = 0
    for cid, paths, _ in clusters.ranked:
        sets, posts, abundances, noise_count, n_tasks = estimates.get(cid, ([], [], [], 0.0, 0))
        noise_total += noise_count
        em_tasks += n_tasks
        hap = np.zeros(len(paths))
        reads = np.zeros(len(paths))
        it = iter(abundances)
        for group_set, post in zip(sets, posts):
            slot_counts = [next(it) for _ in group_set]
            for j, pid in enumerate(group_set):
                reads[pid] += slot_counts[j]
                if j == 0 or pid != group_set[j - 1]:
                    hap[pid] += post
            if post >= PROB_PRECISION:
                names = tuple(paths[pid].name for pid in group_set)
                effs = [paths[pid].effective_length for pid in group_set]
                out_joint[names] = (cid, post, slot_counts, [tpm(c, e) for c, e in zip(slot_counts, effs)])
        for i, path in enumerate(paths):
            out_paths[path.name] = (cid, path.length, path.effective_length, float(hap[i]),
                                    float(reads[i]), tpm(reads[i], path.effective_length))
    unaligned = clusters.unaligned
    return Expected(
        paths=out_paths, joint=out_joint, unknown=noise_total + unaligned,
        unknown_joint=[noise_total / ploidy + unaligned / ploidy] * ploidy,
        tpm_normaliser=normaliser, clusters=len(clusters.ranked), em_tasks=em_tasks,
        info={"fragment_lists": clusters.fragment_lists, "unaligned": unaligned,
              "frag_loc": clusters.dist[0], "frag_scale": clusters.dist[1],
              "frag_shape": clusters.dist[2]},
    )
