"""Inference estimators of the ``haplotype-transcripts`` model
(counterpart of ``rpvg_tpu/infer/estimators.py``).

The classes below are verbatim copies of the JAX package's
``PathEstimator``, ``PathAbundanceEstimator`` and
``NestedPathAbundanceEstimator`` (tests/test_torch_slice.py pins them
against their originals): the batched inference in
:mod:`rpvg_tpu_torch.infer.batched_models` uses their host bookkeeping
(source groups, subset specs, the posterior-weighted combine).  The
per-cluster ``estimate`` paths they also define reach engines that are
not ported yet; those names resolve to functions that raise
``NotImplementedError``.  There is no ``ClusterRNG``: the ported
configuration draws no random numbers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from rpvg_tpu.infer.estimates import CountSamples, PathClusterEstimates
from rpvg_tpu.infer.matrices import (
    add_noise_and_normalize,
    construct_grouped_probability_matrix,
    construct_partial_probability_matrix,
    construct_probability_matrix,
    read_collapse,
)
from rpvg_tpu.probabilities import ReadPathProbs


def _not_ported(what: str, item: int):
    def raise_not_ported(*args, **kwargs):
        raise NotImplementedError(f"{what} is not yet ported (ROADMAP queue 1, item {item})")

    raise_not_ported.__name__ = what.replace(" ", "_")
    return raise_not_ported


# Per-cluster engines the copied estimate() methods name; batched
# inference never calls them.
em_abundances = _not_ported("per-cluster EM", 14)
gibbs_read_count_samples = _not_ported("read-count Gibbs sampling", 12)
path_group_posteriors_diploid = _not_ported("per-cluster diploid posteriors", 14)
path_group_posteriors_full = _not_ported("full group enumeration", 10)
path_group_posteriors_gibbs = _not_ported("posterior Gibbs sampling", 13)


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
        from rpvg_tpu.infer.matrices import cluster_matrix, native_subset_collapse

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
        from rpvg_tpu.infer.matrices import native_subset_collapse

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



# ROADMAP queue 1 item that ports each other inference model.
NOT_PORTED_MODELS = {"transcripts": 8, "strains": 9, "haplotypes": 10}


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
    """Model dispatch (reference src/main.cpp:766-788).  Only
    ``haplotype-transcripts`` is ported."""
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
    if inference_model in NOT_PORTED_MODELS:
        raise NotImplementedError(
            f"-i {inference_model} is not yet ported "
            f"(ROADMAP queue 1, item {NOT_PORTED_MODELS[inference_model]})"
        )
    raise ValueError(f"unknown inference model: {inference_model}")
