"""The pantranscriptome as the reference sees it, read from the generated
files: node lengths from the graph JSON, each path's walk from the panel
JSON, and every place a node occurs.

A walk is a sequence of oriented nodes (``2 * id + is_reverse``, as the
``.rpa`` file stores them).  Where the panel is bidirectional, every
path is also searched read backwards (its reversed walk, each node
flipped), as rpvg's bidirectional GBWT holds it: a read of the other
strand then finds the path.  ``sequences`` lists the walks searched,
``path_of`` the path each belongs to."""

from __future__ import annotations

import json
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.special import erf, erfc, ndtr, owens_t

SQRT_HALF = math.sqrt(0.5)
LOG_SKEW_CONST = math.log(2.0 / math.sqrt(2.0 * math.pi))


class Panel:
    def __init__(self, graph_path: str, panel_path: str):
        with open(graph_path) as handle:
            nodes = json.load(handle)["node"]
        self.node_length: Dict[int, int] = {int(n["id"]): len(n["sequence"]) for n in nodes}
        with open(panel_path) as handle:
            panel = json.load(handle)
        self.names: List[str] = [p["name"] for p in panel["paths"]]
        forward = [tuple(2 * int(nid) + int(rev) for nid, rev in p["nodes"]) for p in panel["paths"]]
        self.lengths = np.array([sum(self.node_length[n >> 1] for n in walk) for walk in forward],
                                dtype=np.int64)
        self.sequences: List[Tuple[int, ...]] = list(forward)
        self.path_of: List[int] = list(range(len(forward)))
        if panel.get("bidirectional", False):
            self.sequences += [tuple(n ^ 1 for n in reversed(walk)) for walk in forward]
            self.path_of += list(range(len(forward)))
        self.occurrences: Dict[int, List[Tuple[int, int]]] = {}
        for s, walk in enumerate(self.sequences):
            for i, node in enumerate(walk):
                self.occurrences.setdefault(node, []).append((s, i))

    def __len__(self) -> int:
        return len(self.names)

    def length_of(self, node: int) -> int:
        return self.node_length[node >> 1]

    def find(self, walk: Sequence[int]) -> List[Tuple[int, int]]:
        """(sequence, index of the walk's first node) of every place the
        walk occurs."""
        walk = tuple(walk)
        k = len(walk)
        return [(s, i) for s, i in self.occurrences.get(walk[0], ())
                if self.sequences[s][i:i + k] == walk]

    def count(self, walk: Sequence[int]) -> int:
        return len(self.find(walk)) if walk else 0


def effective_lengths(lengths: np.ndarray, loc: float, scale: float, shape: float) -> np.ndarray:
    """Each length less the mean fragment length truncated to [1, length],
    at least 1 (0 for an empty path): rpvg's effective length under a
    skew-normal fragment-length distribution (``src/paths_index.cpp``,
    the truncated mean of ``src/utils.hpp``), here in closed form:
    E[Z; u < Z < v] = 2 [phi(u) Phi(a u) - phi(v) Phi(a v)]
    + sqrt(2 / pi) d [Phi(b v) - Phi(b u)], b = sqrt(1 + a^2), d = a / b,
    over P(u < Z < v) = F(v) - F(u), F(z) = Phi(z) - 2 T(z, a)."""
    out = np.zeros(lengths.size, dtype=np.float64)
    for length in np.unique(lengths):
        if length == 0:
            continue
        u, v = (1.0 - loc) / scale, (float(length) - loc) / scale
        b = np.sqrt(1.0 + shape * shape)
        d = shape / b

        def pdf(z):
            return 2.0 * np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi) * ndtr(shape * z)

        def cdf(z):
            return ndtr(z) - 2.0 * owens_t(z, shape)

        partial = pdf(u) - pdf(v) + np.sqrt(2.0 / np.pi) * d * (ndtr(b * v) - ndtr(b * u))
        mean = loc + scale * partial / (cdf(v) - cdf(u))
        out[lengths == length] = max(1.0, float(length) - mean) if np.isfinite(mean) else 1.0
    return out


def _log_std_normal_cdf_tail(z: float) -> float:
    """log Phi(z) below -20: the asymptotic series of rpvg's
    ``src/utils.hpp``."""
    log_lhs = -0.5 * z * z - math.log(-z) - 0.5 * math.log(2.0 * math.pi)
    total, last, numerator, factor, sign, i = 1.0, 0.0, 1.0, 1.0, 1.0, 0
    step = 1.0 / (z * z)
    while abs(last - total) > 2.220446049250313e-16:
        i += 1
        last = total
        sign = -sign
        factor *= step
        numerator *= 2 * i - 1
        total += sign * numerator * factor
    return log_lhs + math.log(total)


def _std_normal_cdf(z: np.ndarray) -> np.ndarray:
    x = z * SQRT_HALF
    a = np.abs(x)
    near = a < SQRT_HALF
    y = np.where(near, 0.5 + 0.5 * erf(x), 0.5 * erfc(a))
    return np.where(~near & (x > 0), 1.0 - y, y)


def frag_log_densities(max_length: int, loc: float, scale: float, shape: float) -> np.ndarray:
    """log of the skew-normal fragment-length density at 0 .. max_length,
    as rpvg tabulates it: log(2 / sqrt(2 pi)) + log Phi(shape z) -
    log(scale) - z^2 / 2, log Phi by rpvg's branches (-Phi(-z) above 6,
    the asymptotic series below -20).  The table is one NumPy expression
    over all lengths, erf and erfc from ``scipy.special``: rpvg's rules
    that merge probabilities within an absolute 1e-8 and stop the EM at
    a relative 1e-3 turn a last-bit difference here into gaps of 1e-5 in
    a cluster's estimates, so its rounding has to be the common one
    (PERF.md)."""
    z = (np.arange(max_length + 1, dtype=np.float64) - loc) / scale
    w = shape * z
    log_cdf = np.empty_like(w)
    hi, low = w > 6.0, w <= -20.0
    mid = ~(hi | low)
    log_cdf[hi] = -_std_normal_cdf(-w[hi])
    with np.errstate(divide="ignore"):
        log_cdf[mid] = np.log(_std_normal_cdf(w[mid]))
    log_cdf[low] = [_log_std_normal_cdf_tail(float(v)) for v in w[low]]
    return LOG_SKEW_CONST + log_cdf - math.log(scale) - 0.5 * z * z
