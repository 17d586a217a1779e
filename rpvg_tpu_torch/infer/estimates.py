"""Result containers for per-cluster inference (reference
reference/src/path_cluster_estimates.hpp)."""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations_with_replacement
from typing import List

import numpy as np

from ..probabilities import PathInfo


@dataclass(slots=True)
class CountSamples:
    """Gibbs read-count samples for a path subset."""

    path_ids: List[int] = field(default_factory=list)
    noise_samples: List[float] = field(default_factory=list)
    # Flattened (sample, path) major order: sample k, path j at k*P+j.
    abundance_samples: List[float] = field(default_factory=list)


@dataclass(slots=True)
class PathClusterEstimates:
    paths: List[PathInfo] = field(default_factory=list)
    path_group_sets: List[List[int]] = field(default_factory=list)
    posteriors: List[float] = field(default_factory=list)
    abundances: List[float] = field(default_factory=list)
    noise_count: float = 0.0
    total_count: float = 0.0
    gibbs_read_count_samples: List[CountSamples] = field(default_factory=list)

    def reset(self, num_components: int, group_size: int) -> None:
        """Enumerate all multisets of `group_size` path indices in
        lexicographic order and zero the estimate arrays (reference
        resetEstimates/generateGroupsRecursive)."""
        self.path_group_sets = []
        self.posteriors = []
        self.abundances = []
        self.noise_count = 0.0
        self.total_count = 0.0
        self.gibbs_read_count_samples = []
        if group_size > 0:
            self.path_group_sets = [
                list(combo)
                for combo in combinations_with_replacement(range(num_components), group_size)
            ]
            self.posteriors = [0.0] * len(self.path_group_sets)
            self.abundances = [0.0] * (len(self.path_group_sets) * group_size)


class GroupSetViews:
    """Zero-copy sequence of path group sets over the fused kernel's
    flat set-id stream: element i is a numpy slice (ascending path
    indices).  Behaves like the equivalent list of lists for len/iter/
    indexing/equality, so estimator consumers and differential tests
    are unaffected while the combine loop skips materialising ~n_sets
    Python lists per cluster."""

    __slots__ = ("_ids", "_bounds", "_lo", "_n")

    def __init__(self, ids, bounds, lo: int, hi: int):
        self._ids = ids
        self._bounds = bounds
        self._lo = lo
        self._n = hi - lo

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        s = self._lo + i
        return self._ids[self._bounds[s] : self._bounds[s + 1]]

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def __eq__(self, other):
        try:
            if len(other) != self._n:
                return False
            return all(
                len(a) == len(b) and bool((np.asarray(a) == np.asarray(b)).all())
                for a, b in zip(self, other)
            )
        except TypeError:
            return NotImplemented

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"GroupSetViews({[list(map(int, g)) for g in self]})"
