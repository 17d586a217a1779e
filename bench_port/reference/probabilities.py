"""Read-path probabilities as rpvg computes them
(``src/read_path_probabilities.cpp``), from one distinct alignment-path
list of the reference fragment pass: a noise probability, and the
probability of each of the cluster's paths, paths of one probability
(within the precision) sharing an entry."""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

from bench_port.reference.fragment_pass import NOISE_SCORE_LOG_BASE, SCORE_LOG_BASE, add_log

PROB_PRECISION = 1e-8
MIN_NOISE_PROB = 1e-4
LOWEST = -1.7976931348623157e308


class ReadProbs(NamedTuple):
    noise: float
    entries: Tuple[Tuple[float, Tuple[int, ...]], ...]   # (probability, cluster path indices)
    count: float

    def sort_key(self) -> tuple:
        return (self.noise, len(self.entries),
                tuple((p, len(ids), ids) for p, ids in self.entries), self.count)

    def same_as(self, other: "ReadProbs") -> bool:
        """Within the precision of each other, entry for entry."""
        return (abs(self.noise - other.noise) < PROB_PRECISION
                and len(self.entries) == len(other.entries)
                and all(abs(p - q) < PROB_PRECISION and a == b
                        for (p, a), (q, b) in zip(self.entries, other.entries)))


def read_probs(compact: Sequence[tuple], count: float, effective_lengths: Sequence[float],
               frag_log_prob: Callable[[int], float]) -> ReadProbs:
    """``compact``: the list's alignment paths (cluster path indices,
    noise flag, is_simple, min mapq, score, aligned length, fragment
    length), the noise record last."""
    mapq = compact[0][3]
    if mapq <= 0:
        return ReadProbs(1.0, (), count)
    noise = max(PROB_PRECISION, max(MIN_NOISE_PROB, 10.0 ** (-mapq / 10.0)))
    noise_score = compact[-1][4]
    noise += (1.0 - noise) * math.exp(noise_score * NOISE_SCORE_LOG_BASE)
    if noise_score == 0:
        return ReadProbs(noise, (), count)

    n = len(effective_lengths)
    log_probs = [LOWEST] * n
    longest = [0] * n
    for ids, _, _, _, score, align_length, frag_length in compact[:-1]:
        log_prob = score * SCORE_LOG_BASE + frag_log_prob(frag_length)
        for i in ids:
            if effective_lengths[i] == 0.0:
                continue
            value = log_prob - math.log(effective_lengths[i])
            # A pair that lies on a path more than one way counts by its
            # longest alignment there, then its likeliest.
            if align_length > longest[i]:
                log_probs[i], longest[i] = value, align_length
            elif align_length == longest[i]:
                log_probs[i] = max(log_probs[i], value)
    total = LOWEST
    for value in log_probs:
        total = add_log(total, value)

    entries: List[list] = []
    low = 0.0
    for i, value in enumerate(log_probs):
        prob = math.exp(value - total)
        if prob < PROB_PRECISION:
            low += prob
            continue
        for entry in entries:
            if abs(entry[0] - prob) < PROB_PRECISION:
                entry[0] = (entry[0] * len(entry[1]) + prob) / (len(entry[1]) + 1)
                entry[1].append(i)
                break
        else:
            entries.append([prob, [i]])
    scaled = sorted((p * (1.0 - noise), tuple(ids)) for p, ids in entries)
    noise += low * (1.0 - noise)
    return ReadProbs(noise, tuple(scaled), count)


def merged(probs: List[ReadProbs]) -> List[ReadProbs]:
    """Sorted, each merged into the one before it where they agree
    (counts summed)."""
    out: List[ReadProbs] = []
    for rp in sorted(probs, key=ReadProbs.sort_key):
        if out and out[-1].same_as(rp):
            out[-1] = out[-1]._replace(count=out[-1].count + rp.count)
        else:
            out.append(rp)
    return out
