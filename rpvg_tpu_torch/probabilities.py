"""Per-fragment read-path probabilities.

Turns a fragment's deduplicated alignment-path list into a noise
probability plus a sparse list of (probability, [cluster path idx...])
entries with probabilities collapsed within the configured precision.
Behavioural contract: reference/src/read_path_probabilities.cpp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .constants import NOISE_SCORE_LOG_BASE, SCORE_LOG_BASE, double_compare
from .fragments import FragmentLengthDist
from .mathutils import add_log, phred_to_prob
from .projection import AlignmentPath

_LOWEST = -np.finfo(np.float64).max


@dataclass(slots=True)
class PathInfo:
    """Per-path metadata within a cluster (reference
    src/path_cluster_estimates.hpp:15-33)."""

    name: str = ""
    group_id: int = 0
    source_count: int = 1
    source_ids: frozenset = field(default_factory=frozenset)
    length: int = 0
    effective_length: float = 0.0

    def copy(self) -> "PathInfo":
        return PathInfo(
            self.name,
            self.group_id,
            self.source_count,
            self.source_ids,
            self.length,
            self.effective_length,
        )


class ReadPathProbs:
    """Noise probability + sparse path probabilities for one distinct
    fragment alignment-path list."""

    __slots__ = ("read_count", "noise_prob", "path_probs", "prob_precision")

    def __init__(self, read_count: int, prob_precision: float = 1e-8):
        self.read_count = read_count
        self.noise_prob = 1.0
        self.path_probs: List[Tuple[float, List[int]]] = []
        self.prob_precision = prob_precision

    # ------------------------------------------------------------ builders
    @staticmethod
    def calc_align_path_log_probs(
        align_paths: Sequence[AlignmentPath],
        fragment_length_dist: FragmentLengthDist,
        is_single_end: bool,
    ) -> List[float]:
        """Per alignment path: score_sum * log-base, plus the fragment
        length log-likelihood for paired reads; trailing noise entry uses
        the noise log base (reference :39-67)."""
        out = []
        for ap in align_paths[:-1]:
            log_prob = ap.score_sum * SCORE_LOG_BASE
            if not is_single_end:
                log_prob += fragment_length_dist.log_prob(ap.frag_length)
            out.append(log_prob)
        out.append(align_paths[-1].score_sum * NOISE_SCORE_LOG_BASE)
        return out

    def add_path_probs(
        self,
        align_paths: Sequence[AlignmentPath],
        align_paths_ids: Sequence[Sequence[int]],
        clustered_path_index: Dict[int, int],
        cluster_paths: Sequence[PathInfo],
        fragment_length_dist: FragmentLengthDist,
        is_single_end: bool,
        min_noise_prob: float,
        collapse_groups: bool = False,
        group_name_index: Optional[Dict[str, int]] = None,
    ) -> None:
        """Reference :74-221."""
        assert len(align_paths) > 1
        assert not self.path_probs

        if align_paths[0].min_mapq <= 0:
            return

        self.noise_prob = max(
            self.prob_precision, max(min_noise_prob, phred_to_prob(align_paths[0].min_mapq))
        )

        log_probs = self.calc_align_path_log_probs(
            align_paths, fragment_length_dist, is_single_end
        )

        self.noise_prob += (1.0 - self.noise_prob) * math.exp(log_probs[-1])

        if align_paths[-1].score_sum == 0:
            assert double_compare(self.noise_prob, 1.0)
            return

        n_paths = len(cluster_paths)
        read_path_log_probs = [_LOWEST] * n_paths
        max_align_lengths = [0.0] * n_paths

        for i in range(len(align_paths_ids) - 1):
            for path_id in align_paths_ids[i]:
                path_idx = clustered_path_index[int(path_id)]
                eff_len = cluster_paths[path_idx].effective_length
                if double_compare(eff_len, 0.0):
                    continue
                log_prob = log_probs[i] - math.log(eff_len)
                align_length = align_paths[i].align_length
                # A fragment can hit the same path several times (mpmap
                # linearisations, partial matches): keep the longest
                # alignment, break ties by probability (reference :127-141).
                if align_length > max_align_lengths[path_idx]:
                    read_path_log_probs[path_idx] = log_prob
                    max_align_lengths[path_idx] = align_length
                elif align_length == max_align_lengths[path_idx]:
                    read_path_log_probs[path_idx] = max(
                        read_path_log_probs[path_idx], log_prob
                    )

        if collapse_groups:
            assert group_name_index
            grouped = [_LOWEST] * len(group_name_index)
            for i, lp in enumerate(read_path_log_probs):
                g = group_name_index[cluster_paths[i].name]
                grouped[g] = add_log(
                    grouped[g], lp + math.log(cluster_paths[i].source_count)
                )
            read_path_log_probs = grouped

        log_sum = _LOWEST
        for lp in read_path_log_probs:
            log_sum = add_log(log_sum, lp)

        low_prob_sum = 0.0
        for i, lp in enumerate(read_path_log_probs):
            prob = math.exp(lp - log_sum)
            if prob >= self.prob_precision:
                for entry_idx, (entry_prob, entry_ids) in enumerate(self.path_probs):
                    if abs(entry_prob - prob) < self.prob_precision:
                        merged = (entry_prob * len(entry_ids) + prob) / (len(entry_ids) + 1)
                        entry_ids.append(i)
                        self.path_probs[entry_idx] = (merged, entry_ids)
                        break
                else:
                    self.path_probs.append((prob, [i]))
            else:
                low_prob_sum += prob

        self.path_probs = [
            (prob * (1.0 - self.noise_prob), ids) for prob, ids in self.path_probs
        ]
        self.noise_prob += low_prob_sum * (1.0 - self.noise_prob)
        self.path_probs.sort(key=lambda entry: (entry[0], entry[1]))

    # -------------------------------------------------------------- dedup
    def quick_merge_identical(self, other: "ReadPathProbs") -> bool:
        """Merge counts when probabilities agree within precision
        (reference :223-250)."""
        if abs(self.noise_prob - other.noise_prob) >= self.prob_precision:
            return False
        if len(self.path_probs) != len(other.path_probs):
            return False
        for (p1, ids1), (p2, ids2) in zip(self.path_probs, other.path_probs):
            if abs(p1 - p2) >= self.prob_precision or ids1 != ids2:
                return False
        self.read_count += other.read_count
        return True

    def sort_key(self) -> tuple:
        """Ordering mirroring reference operator< (:283-322)."""
        return (
            self.noise_prob,
            len(self.path_probs),
            tuple((p, len(ids), tuple(ids)) for p, ids in self.path_probs),
            self.read_count,
        )

    def __repr__(self):
        return (
            f"ReadPathProbs(count={self.read_count}, noise={self.noise_prob:.6g}, "
            f"probs={self.path_probs})"
        )
