"""Inference estimators of the four models (counterpart of
``rpvg_tpu/infer/estimators.py``).

The classes below and :func:`make_estimator` are verbatim copies of the
JAX package's (tests/test_torch_slice.py pins them against their
originals): the batched model functions in
:mod:`rpvg_tpu_torch.infer.batched_models` use their host bookkeeping
(source groups, subset specs, the posterior-weighted combine, the
strains cover tasks).  :class:`ClusterRNG` draws its keys from the
port's own threefry (:mod:`rpvg_tpu_torch.prng`), bit-exact with
``jax.random``.  The two Gibbs samplers the copied ``estimate`` paths
name run one cluster through the batched samplers on the CPU, and the
full enumeration is the host engine of :mod:`rpvg_tpu_torch.infer.
posteriors`; the other per-cluster engines are not ported and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rpvg_tpu_torch import prng
from rpvg_tpu_torch.constants import HAPLOTYPES_MIN_REL_LIKELIHOOD
from rpvg_tpu_torch.infer.estimates import CountSamples, PathClusterEstimates
from rpvg_tpu_torch.infer.matrices import (
    add_noise_and_normalize,
    construct_grouped_probability_matrix,
    construct_partial_probability_matrix,
    construct_probability_matrix,
    read_collapse,
)
from rpvg_tpu_torch.infer.mincover import weighted_minimum_path_cover
from rpvg_tpu_torch.infer.posteriors import path_group_posteriors_full
from rpvg_tpu_torch.probabilities import ReadPathProbs


def _not_ported(what: str, item: int):
    def raise_not_ported(*args, **kwargs):
        raise NotImplementedError(f"{what} is not yet ported (ROADMAP queue 1, item {item})")

    raise_not_ported.__name__ = what.replace(" ", "_")
    return raise_not_ported


# Per-cluster engines the copied estimate() methods name; batched
# inference never calls them.
em_abundances = _not_ported("per-cluster EM", 14)
path_group_posteriors_diploid = _not_ported("per-cluster diploid posteriors", 14)


def gibbs_read_count_samples(
    probs, counts, abundances, noise_count, total_count, rng_key, num_samples,
    thin_its=25, gamma=1.0,
):
    """One job of :func:`rpvg_tpu_torch.infer.readcount_gibbs.
    run_batched_gibbs` on the CPU: (noise samples (S,), path samples
    (S, P))."""
    from rpvg_tpu_torch.infer.readcount_gibbs import run_batched_gibbs

    [result] = run_batched_gibbs(
        [(probs, counts, np.asarray(abundances), noise_count, total_count)],
        [rng_key], int(num_samples), int(thin_its), gamma,
    )
    return result


def path_group_posteriors_gibbs(probs, noise, counts, path_counts, group_size, rng_key):
    """One cluster of :func:`rpvg_tpu_torch.infer.posteriors.
    path_group_posteriors_gibbs_batched` on the CPU: (groups,
    posteriors)."""
    import torch

    from rpvg_tpu_torch.infer.posteriors import path_group_posteriors_gibbs_batched

    [result] = path_group_posteriors_gibbs_batched(
        [(probs, noise, counts, path_counts)], group_size, [rng_key], torch.device("cpu")
    )
    return result


class ClusterRNG:
    """Per-cluster random state: a numpy generator for host-side
    sampling decisions plus a threefry key for the samplers, both
    derived from (seed, cluster_rank) as in the JAX package (the
    reference seeds mt19937 with rng_seed + rank, src/main.cpp:976)."""

    def __init__(self, seed: int, cluster_rank: int):
        self.np_rng = np.random.default_rng((seed, cluster_rank))
        self._key = prng.fold_in(prng.prng_key(seed), cluster_rank)

    def next_key(self):
        self._key, sub = prng.split(self._key)
        return sub


_SOURCE_SET_SIG_INDEX: Dict[frozenset, int] = {}


_SOURCE_GROUP_CACHE: Dict[tuple, Tuple[List[List[int]], List[int]]] = {}


class PathEstimator:
    def __init__(self, prob_precision: float = 1e-8):
        self.prob_precision = prob_precision

    def estimate(
        self,
        estimates: PathClusterEstimates,
        cluster_probs: Sequence[ReadPathProbs],
        rng: ClusterRNG,
    ) -> None:
        raise NotImplementedError

    def _group_posteriors(
        self, probs, noise, counts, path_counts, group_size, use_gibbs, min_rel_likelihood, rng
    ):
        if use_gibbs:
            return path_group_posteriors_gibbs(
                probs, noise, counts, path_counts, group_size, rng.next_key()
            )
        if group_size == 2:
            return path_group_posteriors_diploid(
                probs, noise, counts, path_counts, min_rel_likelihood
            )
        return path_group_posteriors_full(probs, noise, counts, path_counts, group_size)


class PathPosteriorEstimator(PathEstimator):
    """Marginal per-path posteriors (group size 1)."""

    def estimate(self, estimates, cluster_probs, rng):
        estimates.reset(len(estimates.paths), 1)
        if not cluster_probs:
            return
        probs, noise, counts = construct_probability_matrix(cluster_probs, len(estimates.paths))
        path_counts = [p.source_count for p in estimates.paths]
        groups, posteriors = path_group_posteriors_full(probs, noise, counts, path_counts, 1)
        estimates.path_group_sets = groups
        estimates.posteriors = list(map(float, posteriors))


class PathGroupPosteriorEstimator(PathPosteriorEstimator):
    """Ploidy-sized haplotype group posteriors (`haplotypes` model)."""

    def __init__(self, ploidy: int, use_hap_gibbs: bool, prob_precision: float = 1e-8):
        super().__init__(prob_precision)
        self.ploidy = ploidy
        self.use_hap_gibbs = use_hap_gibbs

    def estimate(self, estimates, cluster_probs, rng):
        estimates.reset(0, 0)
        if not cluster_probs:
            return
        probs, noise, counts = construct_probability_matrix(cluster_probs, len(estimates.paths))
        path_counts = [p.source_count for p in estimates.paths]
        groups, posteriors = self._group_posteriors(
            probs,
            noise,
            counts,
            path_counts,
            self.ploidy,
            self.use_hap_gibbs,
            HAPLOTYPES_MIN_REL_LIKELIHOOD,
            rng,
        )
        estimates.path_group_sets = groups
        estimates.posteriors = list(map(float, posteriors))


class PathAbundanceEstimator(PathEstimator):
    """EM expression estimation (`transcripts` model)."""

    def __init__(
        self,
        max_em_its: int = 10000,
        max_rel_em_conv: float = 0.001,
        num_gibbs_samples: int = 0,
        gibbs_thin_its: int = 25,
        prob_precision: float = 1e-8,
    ):
        super().__init__(prob_precision)
        self.max_em_its = max_em_its
        self.max_rel_em_conv = max_rel_em_conv
        self.num_gibbs_samples = num_gibbs_samples
        self.gibbs_thin_its = gibbs_thin_its

    def estimate(self, estimates, cluster_probs, rng):
        estimates.reset(len(estimates.paths), 1)
        if not cluster_probs:
            return
        probs, noise, counts = construct_probability_matrix(cluster_probs, len(estimates.paths))
        full_probs = add_noise_and_normalize(probs, noise)

        estimates.total_count = float(counts.sum())
        abundances, noise_count = em_abundances(
            full_probs, counts, estimates.total_count, self.max_em_its, self.max_rel_em_conv
        )
        estimates.abundances = list(map(float, abundances))
        estimates.noise_count = noise_count

        if self.num_gibbs_samples > 0:
            samples = CountSamples(path_ids=list(range(len(estimates.path_group_sets))))
            noise_samples, path_samples = gibbs_read_count_samples(
                full_probs,
                counts,
                abundances,
                noise_count,
                estimates.total_count,
                rng.next_key(),
                self.num_gibbs_samples,
                self.gibbs_thin_its,
            )
            samples.noise_samples = list(map(float, noise_samples))
            samples.abundance_samples = list(map(float, path_samples.reshape(-1)))
            estimates.gibbs_read_count_samples.append(samples)


class MinimumPathAbundanceEstimator(PathAbundanceEstimator):
    """Greedy minimum path cover then EM on the cover (`strains`)."""

    def prepare_cover_task(self, estimates, cluster_probs) -> Optional[dict]:
        """Host half: cover selection + collapsed sub-matrix, no EM.
        Returns None when no path covers any read (empty estimates)."""
        from rpvg_tpu_torch.constants import double_compare
        from rpvg_tpu_torch.infer.matrices import DenseCluster

        probs, noise, counts = construct_probability_matrix(cluster_probs, len(estimates.paths))

        path_weights = np.zeros(probs.shape[1], dtype=np.float64)
        cover_counts = counts.copy()
        if isinstance(cluster_probs, DenseCluster):
            # Same accumulation row by row as the sparse loop (per path
            # the additions happen in ascending row order — identical
            # floats), reading the dense matrix directly.
            cover_matrix = probs > 0
            for i in range(probs.shape[0]):
                if double_compare(float(noise[i]), 1.0):
                    cover_counts[i] = 0.0
                nz = cover_matrix[i]
                if cover_counts[i] != 0.0 and nz.any():
                    path_weights[nz] += np.log(probs[i, nz]) * cover_counts[i]
        else:
            cover_matrix = np.zeros_like(probs, dtype=bool)
            for i, rpp in enumerate(cluster_probs):
                if double_compare(noise[i], 1.0):
                    cover_counts[i] = 0.0
                for prob, ids in rpp.path_probs:
                    for pid in ids:
                        cover_matrix[i, pid] = True
                        path_weights[pid] += math.log(prob) * cover_counts[i]
        path_weights *= -1.0

        min_cover = weighted_minimum_path_cover(cover_matrix, cover_counts, path_weights)
        if not min_cover:
            return None

        sub_probs, sub_noise, sub_counts = construct_partial_probability_matrix(
            cluster_probs, min_cover, len(estimates.paths)
        )
        sub_full = add_noise_and_normalize(sub_probs, sub_noise)
        sub_full, sub_counts = read_collapse(sub_full, sub_counts, self.prob_precision)
        return {
            "matrix": sub_full,
            "counts": sub_counts,
            "min_cover": min_cover,
            "total": float(sub_counts.sum()),
        }

    def apply_cover_result(self, estimates, task, abundances, noise_count) -> None:
        for j, pid in enumerate(task["min_cover"]):
            estimates.abundances[pid] += float(abundances[j])
        estimates.noise_count = noise_count
        estimates.total_count = task["total"]

    def estimate(self, estimates, cluster_probs, rng):
        estimates.reset(len(estimates.paths), 1)
        if not cluster_probs:
            return
        task = self.prepare_cover_task(estimates, cluster_probs)
        if task is None:
            return
        sub_full, sub_counts = task["matrix"], task["counts"]
        min_cover, total = task["min_cover"], task["total"]

        abundances, noise_count = em_abundances(
            sub_full, sub_counts, total, self.max_em_its, self.max_rel_em_conv
        )

        if self.num_gibbs_samples > 0:
            samples = CountSamples(path_ids=list(min_cover))
            noise_samples, path_samples = gibbs_read_count_samples(
                sub_full,
                sub_counts,
                abundances,
                noise_count,
                total,
                rng.next_key(),
                self.num_gibbs_samples,
                self.gibbs_thin_its,
            )
            samples.noise_samples = list(map(float, noise_samples))
            samples.abundance_samples = list(map(float, path_samples.reshape(-1)))
            estimates.gibbs_read_count_samples.append(samples)

        self.apply_cover_result(estimates, task, abundances, noise_count)


class NestedPathAbundanceEstimator(PathAbundanceEstimator):
    """Haplotype posterior inference nested with per-subset EM
    (`haplotype-transcripts` model)."""

    def __init__(
        self,
        group_size: int,
        min_hap_prob: float,
        infer_collapsed: bool,
        use_group_post_gibbs: bool,
        max_em_its: int = 10000,
        max_rel_em_conv: float = 0.001,
        num_gibbs_samples: int = 0,
        gibbs_thin_its: int = 25,
        prob_precision: float = 1e-8,
    ):
        super().__init__(max_em_its, max_rel_em_conv, num_gibbs_samples, gibbs_thin_its, prob_precision)
        self.group_size = group_size
        self.min_hap_prob = min_hap_prob
        self.infer_collapsed = infer_collapsed
        self.use_group_post_gibbs = use_group_post_gibbs

    # ------------------------------------------------------------ helpers
    @staticmethod
    def find_path_groups(paths) -> List[List[int]]:
        """Group paths by transcript group id, in first-seen order."""
        groups: List[List[int]] = []
        index: Dict[int, int] = {}
        for i, path in enumerate(paths):
            g = index.setdefault(path.group_id, len(groups))
            if g == len(groups):
                groups.append([])
            groups[g].append(i)
        return groups

    @staticmethod
    def find_path_source_groups(paths) -> Tuple[List[List[int]], List[int]]:
        """Group paths by identical haplotype source-id membership; the
        returned counts collapse sources sharing a path set (reference
        findPathSourceGroups :493-546).

        The grouping depends only on the ordered sequence of per-path
        source-id sets, and panels have few distinct sets, so cluster
        patterns repeat heavily: results are memoised on that signature.
        Returned lists are shared across clusters — treat as read-only."""
        sig_index = _SOURCE_SET_SIG_INDEX
        try:
            sig = tuple(sig_index.setdefault(p.source_ids, len(sig_index)) for p in paths)
        except TypeError:  # unhashable source_ids (plain set): no memo
            sig = None
        if sig is not None:
            cached = _SOURCE_GROUP_CACHE.get(sig)
            if cached is not None:
                return cached

        source_id_paths: Dict[int, List[int]] = {}
        for i, path in enumerate(paths):
            for sid in path.source_ids:
                source_id_paths.setdefault(sid, []).append(i)

        # First-seen order over source ids; sources sharing a path set
        # collapse into one group with a multiplicity count.
        groups: List[List[int]] = []
        counts: List[int] = []
        index: Dict[tuple, int] = {}
        for plist in source_id_paths.values():
            key = tuple(plist)
            g = index.get(key)
            if g is None:
                index[key] = len(groups)
                groups.append(plist)
                counts.append(1)
            else:
                counts[g] += 1
        if sig is not None and len(_SOURCE_GROUP_CACHE) < 1_000_000:
            _SOURCE_GROUP_CACHE[sig] = (groups, counts)
        return groups, counts

    # ------------------------------------------------------------ drivers
    def estimate(self, estimates, cluster_probs, rng):
        if self.infer_collapsed:
            self._infer_collapsed_groups(estimates, cluster_probs, rng)
        else:
            self._infer_independent_groups(estimates, cluster_probs, rng)

    def _group_posterior_matrix(self, cluster_probs, groups, num_paths):
        from rpvg_tpu_torch.infer.matrices import cluster_matrix, native_subset_collapse

        dense, d_noise, d_counts = cluster_matrix(cluster_probs, num_paths)
        native = native_subset_collapse(
            dense, d_noise, d_counts, [list(map(list, groups))], self.prob_precision
        )
        if native is not None:
            full, counts = native[0]
        else:
            probs, noise, counts = construct_grouped_probability_matrix(
                cluster_probs, groups, num_paths
            )
            full = add_noise_and_normalize(probs, noise)
            full, counts = read_collapse(full, counts, self.prob_precision)
        noise = full[:, -1].copy()
        return full[:, :-1], noise, counts

    def _infer_collapsed_groups(self, estimates, cluster_probs, rng):
        estimates.reset(0, 0)
        if not cluster_probs:
            return

        source_groups, source_counts = self.find_path_source_groups(estimates.paths)
        probs, noise, counts = self._group_posterior_matrix(
            cluster_probs, source_groups, len(estimates.paths)
        )

        groups, posteriors = self._group_posteriors(
            probs,
            noise,
            counts,
            source_counts,
            self.group_size,
            self.use_group_post_gibbs,
            self.min_hap_prob,
            rng,
        )

        # Select group-set subsets with posterior >= min_hap_prob, expand
        # to path subsets, renormalise (reference selectPathSubsetIndices).
        subset_probs: Dict[tuple, float] = {}
        total_posterior = 0.0
        for group_set, posterior in zip(groups, posteriors):
            if posterior >= self.min_hap_prob:
                path_subset: List[int] = []
                for g in group_set:
                    path_subset.extend(source_groups[g])
                key = tuple(sorted(path_subset))
                subset_probs[key] = subset_probs.get(key, 0.0) + float(posterior)
                total_posterior += float(posterior)
        subset_probs = {k: v / total_posterior for k, v in subset_probs.items()}

        self._infer_path_subset_abundance(estimates, cluster_probs, rng, subset_probs)

    def _infer_independent_groups(self, estimates, cluster_probs, rng):
        estimates.reset(0, 0)
        if not cluster_probs:
            return

        path_groups = self.find_path_groups(estimates.paths)
        num_samples = math.floor(1.0 / self.min_hap_prob)
        subset_samples: List[List[int]] = [[] for _ in range(num_samples)]

        for group in path_groups:
            probs, noise, counts = self._subset_matrix(cluster_probs, group, len(estimates.paths))
            group_counts = [estimates.paths[i].source_count for i in group]
            groups, posteriors = self._group_posteriors(
                probs,
                noise,
                counts,
                group_counts,
                self.group_size,
                self.use_group_post_gibbs,
                self.min_hap_prob,
                rng,
            )
            # Sample one group set per subset sample slot.
            posteriors = np.asarray(posteriors, dtype=np.float64)
            posteriors = posteriors / posteriors.sum()
            choices = rng.np_rng.choice(len(groups), size=num_samples, p=posteriors)
            for sample_idx, choice in enumerate(choices):
                for local_idx in sorted(groups[choice]):
                    subset_samples[sample_idx].append(group[local_idx])

        subset_probs: Dict[tuple, float] = {}
        for subset in subset_samples:
            key = tuple(sorted(subset))
            subset_probs[key] = subset_probs.get(key, 0.0) + 1.0 / num_samples

        self._infer_path_subset_abundance(estimates, cluster_probs, rng, subset_probs)

    def _subset_matrix(self, cluster_probs, path_ids, num_paths):
        probs, noise, counts = construct_partial_probability_matrix(
            cluster_probs, path_ids, num_paths
        )
        full = add_noise_and_normalize(probs, noise)
        full, counts = read_collapse(full, counts, self.prob_precision)
        noise = full[:, -1].copy()
        return full[:, :-1], noise, counts

    def prepare_subset_specs(self, subset_probs):
        """Task bookkeeping for every selected path subset (no matrices
        yet): collapse repeated path ids (a homozygous diplotype lists a
        path twice); multiplicity splits its abundance later."""
        tasks = []
        for subset, subset_prob in subset_probs.items():
            if subset_prob < self.min_hap_prob:
                continue
            collapsed: List[int] = []
            multiplicity: Dict[int, int] = {}
            for pid in subset:
                if not collapsed or pid != collapsed[-1]:
                    collapsed.append(pid)
                    multiplicity[pid] = 1
                else:
                    multiplicity[pid] += 1
            tasks.append(
                {
                    "subset": subset,
                    "subset_prob": subset_prob,
                    "collapsed": collapsed,
                    "multiplicity": multiplicity,
                }
            )
        return tasks

    def fill_subset_matrices(self, cluster_probs, num_paths, tasks):
        """Fill task["matrix"]/task["counts"]: each subset's matrix is a
        column gather of the dense cluster matrix, noise-normalised and
        row-collapsed — elementwise identical to
        construct_partial_probability_matrix but O(R * |subset|) per
        task instead of re-scanning every sparse probability record."""
        from rpvg_tpu_torch.infer.matrices import native_subset_collapse

        dense, noise, counts = construct_probability_matrix(
            cluster_probs, num_paths
        )
        native = native_subset_collapse(
            dense, noise, counts,
            [[[pid] for pid in task["collapsed"]] for task in tasks],
            self.prob_precision,
        )
        if native is not None:
            for task, (sub_full, sub_counts) in zip(tasks, native):
                task["matrix"] = sub_full
                task["counts"] = sub_counts
        else:
            for task in tasks:
                sub_full = add_noise_and_normalize(dense[:, task["collapsed"]], noise)
                sub_full, sub_counts = read_collapse(
                    sub_full, counts, self.prob_precision
                )
                task["matrix"] = sub_full
                task["counts"] = sub_counts

    def prepare_subset_tasks(self, estimates, cluster_probs, subset_probs):
        """Build the EM inputs for every selected path subset.  Returns
        a list of task dicts consumed by :meth:`combine_subset_tasks`."""
        tasks = self.prepare_subset_specs(subset_probs)
        if tasks:
            self.fill_subset_matrices(cluster_probs, len(estimates.paths), tasks)
        return tasks

    def combine_subset_tasks(self, estimates, tasks, em_results):
        """Posterior-weighted combination of per-subset EM results
        (reference inferPathSubsetAbundance :608-750, combine tail)."""
        group_estimates: Dict[tuple, List] = {}
        sum_hap_prob = 0.0

        for task, (abundances, noise_count) in zip(tasks, em_results):
            subset_prob = task["subset_prob"]
            sum_hap_prob += subset_prob
            estimates.noise_count += noise_count * subset_prob

            col_of = {pid: j for j, pid in enumerate(task["collapsed"])}
            by_group: Dict[int, List[int]] = {}
            for pid in task["subset"]:
                by_group.setdefault(estimates.paths[pid].group_id, []).append(pid)

            for group_paths in by_group.values():
                key = tuple(group_paths)
                entry = group_estimates.setdefault(key, [0.0, [0.0] * len(group_paths)])
                entry[0] += subset_prob
                for i, pid in enumerate(group_paths):
                    entry[1][i] += (
                        float(abundances[col_of[pid]])
                        * subset_prob
                        / task["multiplicity"][pid]
                    )

        estimates.path_group_sets = []
        estimates.posteriors = []
        estimates.abundances = []
        for key, (posterior, path_abundances) in group_estimates.items():
            estimates.path_group_sets.append(list(key))
            estimates.posteriors.append(posterior)
            estimates.abundances.extend(path_abundances)

        estimates.noise_count += (1.0 - sum_hap_prob) * estimates.total_count

    def _infer_path_subset_abundance(self, estimates, cluster_probs, rng, subset_probs):
        """EM per sampled path subset, posterior-weighted combination of
        abundances and Gibbs-sample allocation (reference
        inferPathSubsetAbundance :608-750)."""
        estimates.total_count = float(sum(rpp.read_count for rpp in cluster_probs))

        tasks = self.prepare_subset_tasks(estimates, cluster_probs, subset_probs)
        em_results = []
        remaining_gibbs = self.num_gibbs_samples
        remaining_prob = 1.0

        for task in tasks:
            sub_full = task["matrix"]
            sub_counts = task["counts"]
            subset_prob = task["subset_prob"]
            collapsed = task["collapsed"]

            total = float(sub_counts.sum())
            abundances, noise_count = em_abundances(
                sub_full, sub_counts, total, self.max_em_its, self.max_rel_em_conv
            )
            em_results.append((abundances, noise_count))

            if remaining_gibbs > 0:
                n_here = rng.np_rng.binomial(
                    remaining_gibbs, min(1.0, subset_prob / remaining_prob)
                )
                remaining_gibbs -= n_here
                remaining_prob -= subset_prob
                if n_here > 0:
                    samples = CountSamples(path_ids=list(collapsed))
                    noise_samples, path_samples = gibbs_read_count_samples(
                        sub_full,
                        sub_counts,
                        abundances,
                        noise_count,
                        total,
                        rng.next_key(),
                        int(n_here),
                        self.gibbs_thin_its,
                    )
                    samples.noise_samples = list(map(float, noise_samples))
                    samples.abundance_samples = list(map(float, path_samples.reshape(-1)))
                    estimates.gibbs_read_count_samples.append(samples)

        self.combine_subset_tasks(estimates, tasks, em_results)


def make_estimator(
    inference_model: str,
    *,
    ploidy: int = 2,
    use_hap_gibbs: bool = False,
    min_hap_prob: float = 0.001,
    ind_hap_inference: bool = False,
    max_em_its: int = 10000,
    max_rel_em_conv: float = 0.001,
    num_gibbs_samples: int = 0,
    gibbs_thin_its: int = 25,
    prob_precision: float = 1e-8,
) -> PathEstimator:
    """Model dispatch (reference src/main.cpp:766-788)."""
    if inference_model == "haplotypes":
        return PathGroupPosteriorEstimator(ploidy, use_hap_gibbs, prob_precision)
    if inference_model == "transcripts":
        return PathAbundanceEstimator(
            max_em_its, max_rel_em_conv, num_gibbs_samples, gibbs_thin_its, prob_precision
        )
    if inference_model == "strains":
        return MinimumPathAbundanceEstimator(
            max_em_its, max_rel_em_conv, num_gibbs_samples, gibbs_thin_its, prob_precision
        )
    if inference_model == "haplotype-transcripts":
        return NestedPathAbundanceEstimator(
            ploidy,
            min_hap_prob,
            not ind_hap_inference,
            use_hap_gibbs,
            max_em_its,
            max_rel_em_conv,
            num_gibbs_samples,
            gibbs_thin_its,
            prob_precision,
        )
    raise ValueError(f"unknown inference model: {inference_model}")
