"""Quality-adjusted alignment scoring tables.

Reproduces the GSSW-style HMM-derived quality-adjusted score matrix and
per-quality full-length bonuses precomputed at static init in the
reference (reference/src/utils.hpp:507-597), vectorised with
numpy.  Scores depend only on (quality, base-pair class); rpvg only ever
uses the matched-base diagonal at (i=0, j=0), exposed here as
``QUAL_MATCH_SCORES``.
"""

from __future__ import annotations

import math

import numpy as np

from .constants import FULL_LENGTH_BONUS, MATCH_SCORE, MISMATCH_SCORE, SCORE_LOG_BASE

MAX_QUAL = 255


def _qual_adjusted_matrix(gc_content: float = 0.5, max_qual: int = MAX_QUAL) -> np.ndarray:
    """(max_qual+1, 5, 5) int8 score tensor (reference utils.hpp:514-573)."""
    nt_freqs = np.array(
        [
            0.5 * (1 - gc_content),
            0.5 * gc_content,
            0.5 * gc_content,
            0.5 * (1 - gc_content),
        ]
    )

    base_scores = np.full((4, 4), -float(MISMATCH_SCORE))
    np.fill_diagonal(base_scores, float(MATCH_SCORE))

    # Emission probabilities of the align state of the underlying HMM.
    align_prob = np.exp(SCORE_LOG_BASE * base_scores) * np.outer(nt_freqs, nt_freqs)
    # Total emission mass under a base error (all wrong observed bases).
    align_complement_prob = align_prob.sum(axis=1, keepdims=True) - align_prob

    lowest_meaningful_qual = math.ceil(-10.0 * math.log10(0.75))

    quals = np.arange(max_qual + 1, dtype=np.float64)
    err = 10.0 ** (-quals / 10.0)

    num = (1.0 - err)[:, None, None] * align_prob[None] + (err / 3.0)[:, None, None] * (
        align_complement_prob[None]
    )
    den = nt_freqs[None, :, None] * (
        (1.0 - err)[:, None, None] * nt_freqs[None, None, :]
        + (err / 3.0)[:, None, None] * (1.0 - nt_freqs)[None, None, :]
    )
    scores = np.round(np.round(np.log(num / den) / SCORE_LOG_BASE))

    out = np.zeros((max_qual + 1, 5, 5), dtype=np.int64)
    out[:, :4, :4] = scores.astype(np.int64)
    out[quals < lowest_meaningful_qual] = 0
    out[:, 4, :] = 0
    out[:, :, 4] = 0
    return out.astype(np.int8)


def _qual_adjusted_bonuses(max_qual: int = MAX_QUAL) -> np.ndarray:
    """Per-quality full-length bonuses (reference utils.hpp:575-594)."""
    p_full_len = math.exp(SCORE_LOG_BASE * FULL_LENGTH_BONUS) / (
        1.0 + math.exp(SCORE_LOG_BASE * FULL_LENGTH_BONUS)
    )
    # +1 so the minimum Illumina qual (2) scores zero.
    lowest_meaningful_qual = math.ceil(-10.0 * math.log10(0.75)) + 1

    out = np.zeros(max_qual + 1, dtype=np.int8)
    for q in range(lowest_meaningful_qual, max_qual + 1):
        err = 10.0 ** (-q / 10.0)
        score = (
            math.log(
                ((1.0 - err * 4.0 / 3.0) * p_full_len + (err * 4.0 / 3.0) * (1.0 - p_full_len))
                / (1.0 - p_full_len)
            )
            / SCORE_LOG_BASE
        )
        out[q] = round(score)
    return out


QUAL_SCORE_TENSOR = _qual_adjusted_matrix()
# Matched-base score per quality: entry (q, A, A); the only slice rpvg uses
# (reference alignment_path_finder.cpp:45-48 indexes qual_score_matrix[25*q]).
QUAL_MATCH_SCORES = QUAL_SCORE_TENSOR[:, 0, 0].astype(np.int32)
QUAL_FULL_LENGTH_BONUSES = _qual_adjusted_bonuses().astype(np.int32)


def alignment_score(quality: bytes, start_offset: int, length: int, score_not_qual: bool) -> int:
    """Optimal (all-match) score of quality[start:start+length].

    Without qualities (or when quality adjustment is disabled) each base
    scores 1 (reference alignment_path_finder.cpp:51-68)."""
    if score_not_qual or not quality:
        return length
    assert start_offset + length <= len(quality)
    window = np.frombuffer(quality, dtype=np.uint8)[start_offset : start_offset + length]
    return int(QUAL_MATCH_SCORES[window].sum())


def optimal_alignment_score(quality: bytes, seq_length: int, score_not_qual: bool) -> int:
    """Best possible score for a read: per-base matches plus both
    full-length bonuses (reference alignment_path_finder.cpp:70-84)."""
    if score_not_qual or not quality:
        return seq_length * MATCH_SCORE + 2 * FULL_LENGTH_BONUS
    assert len(quality) == seq_length
    score = alignment_score(quality, 0, seq_length, score_not_qual)
    score += int(QUAL_FULL_LENGTH_BONUSES[quality[0]]) + int(QUAL_FULL_LENGTH_BONUSES[quality[-1]])
    return score
