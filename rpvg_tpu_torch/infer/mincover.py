"""Greedy weighted minimum path cover for the `strains` model
(reference MinimumPathAbundanceEstimator::weightedMinimumPathCover,
reference/src/path_abundance_estimator.cpp:297-340)."""

from __future__ import annotations

from typing import List

import numpy as np


def weighted_minimum_path_cover(
    read_path_cover: np.ndarray, read_counts: np.ndarray, path_weights: np.ndarray
) -> List[int]:
    """Pick paths maximising covered-read-count / weight until every
    read with nonzero count is covered.  Returns sorted path indices."""
    assert read_path_cover.shape == (read_counts.size, path_weights.size)

    if read_path_cover.shape[1] == 1:
        return [0]

    uncovered = read_counts.astype(np.float64).copy()
    cover = read_path_cover.astype(np.float64)
    picked: List[int] = []

    while uncovered.max() > 0:
        with np.errstate(invalid="ignore", divide="ignore"):
            scores = (uncovered @ cover) / path_weights
        best = -1
        best_score = 0.0
        for i, score in enumerate(scores):
            if score > best_score:
                best_score = score
                best = i
        assert best >= 0
        picked.append(best)
        uncovered *= ~read_path_cover[:, best].astype(bool)

    picked.sort()
    return picked
