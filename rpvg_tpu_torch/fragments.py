"""Fragment length model: normal or skew-normal, with method-of-moments
initialised maximum-likelihood fitting from a length histogram.

Behavioural contract follows the reference
(reference/src/fragment_length_dist.cpp): MOM init per Azzalini
(1985), alternating golden-section maximisation of alpha and mu with the
analytic sigma update (Azzalini eq. 8), and a precomputed log-prob
buffer up to loc + sd * sd_max_multi.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from . import mathutils as mu
from .constants import double_compare


@dataclass
class FragmentLengthDist:
    loc: float = 0.0
    scale: float = 0.0
    shape: float = 0.0
    max_length: int = 0
    log_prob_buffer: np.ndarray = field(default_factory=lambda: np.zeros(0))

    # ---------------------------------------------------------------- ctor
    @classmethod
    def from_params(
        cls, loc: float, scale: float, shape: float = 0.0, sd_max_multi: int = 10
    ) -> "FragmentLengthDist":
        dist = cls(loc=float(loc), scale=float(scale), shape=float(shape))
        assert dist.is_valid()
        dist._set_max_length(sd_max_multi)
        dist._fill_log_prob_buffer(dist.max_length)
        return dist

    @classmethod
    def from_normal(cls, mean: float, sd: float, sd_max_multi: int = 10) -> "FragmentLengthDist":
        return cls.from_params(mean, sd, 0.0, sd_max_multi)

    @classmethod
    def from_counts(
        cls, frag_length_counts: Sequence[int], skew_normal: bool = True
    ) -> "FragmentLengthDist":
        """Fit from a histogram indexed by fragment length (index 0 must
        be empty).  Mirrors reference fragment_length_dist.cpp:60-285."""
        counts = np.asarray(frag_length_counts, dtype=np.float64)
        assert counts.size > 0 and counts[0] == 0

        lengths = np.arange(counts.size, dtype=np.float64)
        sample_size = counts.sum()
        frag_length_sum = float((lengths * counts).sum())

        if sample_size < 2:
            return cls(loc=frag_length_sum, scale=0.0, shape=0.0)

        if sample_size < 1000:
            print(
                f"WARNING: Only {int(sample_size)} unambiguous read pairs available to "
                "re-estimate fragment length distribution parameters from alignment paths.",
                file=sys.stderr,
            )

        if not skew_normal:
            loc = frag_length_sum / sample_size
            var = float(((lengths - loc) ** 2 * counts).sum()) / (sample_size - 1)
            dist = cls(loc=loc, scale=math.sqrt(var), shape=0.0)
        else:
            fitted = None
            if os.environ.get("RPVG_TPU_NATIVE_EM", "1") != "0":
                # C++ twin of the alternating golden-section fit — same
                # algorithm, scalar math; ~40x faster than the vectorised
                # Python path on typical histograms.
                try:
                    from .native import fit_skew_normal_mle

                    fitted = fit_skew_normal_mle(counts)
                except Exception:
                    fitted = None
            if fitted is None:
                fitted = _fit_skew_normal_mle(counts, lengths)
            loc, scale, shape = fitted
            dist = cls(loc=loc, scale=scale, shape=shape)

        assert dist.is_valid()
        dist.max_length = counts.size
        dist._fill_log_prob_buffer(counts.size)
        return dist

    @classmethod
    def from_alignment_stream(
        cls, alignments, sd_max_multi: int = 10
    ) -> Optional["FragmentLengthDist"]:
        """Scan an iterable of alignment dicts for embedded fragment
        length distribution parameters (mpmap/gam annotations)."""
        for aln in alignments:
            parsed = cls.parse_alignment(aln)
            if parsed is not None:
                loc, scale = parsed
                return cls.from_params(loc, scale, 0.0, sd_max_multi)
        return None

    @staticmethod
    def parse_alignment(aln: dict) -> Optional[tuple]:
        """Extract (loc, scale) from an alignment record.

        Supports the `fragment_length_distribution` proto field
        ("n:mean:sd:..." with n > 0) and the mpmap annotation form
        "-I <mean> -D <sd>" (reference fragment_length_dist.cpp:287-357)."""
        fld = aln.get("fragment_length_distribution")
        if fld and not fld.startswith("0"):
            parts = fld.split(":")
            assert float(parts[0]) > 0
            return float(parts[1]), float(parts[2])
        annotation = aln.get("annotation") or {}
        fld = annotation.get("fragment_length_distribution")
        if fld:
            parts = fld.split(" ")
            assert parts[0] == "-I" and parts[2] == "-D"
            return float(parts[1]), float(parts[3])
        return None

    # ------------------------------------------------------------- queries
    def is_valid(self) -> bool:
        return self.loc >= 0 and self.scale > 0

    def log_prob(self, value: int) -> float:
        if value < self.log_prob_buffer.size:
            return float(self.log_prob_buffer[value])
        if double_compare(self.shape, 0.0):
            return mu.log_normal_pdf(float(value), self.loc, self.scale)
        return mu.log_skew_normal_pdf(float(value), self.loc, self.scale, self.shape)

    def log_prob_array(self, max_value: int) -> np.ndarray:
        """Device-friendly log-prob table for lengths 0..max_value."""
        out = np.empty(max_value + 1, dtype=np.float64)
        n = min(self.log_prob_buffer.size, max_value + 1)
        out[:n] = self.log_prob_buffer[:n]
        for v in range(n, max_value + 1):
            out[v] = self.log_prob(v)
        return out

    # ------------------------------------------------------------ internal
    def _set_max_length(self, sd_max_multi: int) -> None:
        delta = self.shape / math.sqrt(1.0 + self.shape * self.shape)
        sd = self.scale * (1.0 - 2.0 * delta * delta / math.pi)
        self.max_length = int(math.ceil(self.loc + sd * sd_max_multi))
        assert self.max_length > 0

    def _fill_log_prob_buffer(self, size: int) -> None:
        values = np.arange(size + 1, dtype=np.float64)
        if double_compare(self.shape, 0.0):
            self.log_prob_buffer = mu.log_normal_pdf_vec(values, self.loc, self.scale)
        else:
            self.log_prob_buffer = mu.log_skew_normal_pdf_vec(
                values, self.loc, self.scale, self.shape
            )


def _fit_skew_normal_mle(counts: np.ndarray, lengths: np.ndarray) -> tuple:
    """Skew-normal MLE via MOM init + alternating golden-section search
    (reference fragment_length_dist.cpp:103-278)."""
    k0 = counts.sum()
    k1 = float((lengths * counts).sum())
    k2 = float((lengths**2 * counts).sum())
    k3 = float((lengths**3 * counts).sum())

    m1 = k1 / k0
    m2 = k2 / k0 - m1 * m1
    m3 = k3 / k0 - 3.0 * m1 * m2 - m1**3

    mean, sd = m1, math.sqrt(m2)
    skew = m3 / sd**3

    alpha = 0.0
    sigma = 0.0
    if skew != 0.0 and k0 > 2.0:
        # Cap the sample skew below the theoretical skew-normal maximum.
        gam = min(abs(skew), 0.9952717464311565) ** (2.0 / 3.0)
        abs_delta = math.sqrt(
            (math.pi / 2.0) * (gam / (gam + ((4.0 - math.pi) / 2.0) ** (2.0 / 3.0)))
        )
        abs_alpha = abs_delta / math.sqrt(1.0 - abs_delta * abs_delta)
        alpha = -abs_alpha if skew < 0.0 else abs_alpha
    delta = alpha / math.sqrt(1.0 + alpha * alpha)
    if sd != 0.0 and k0 > 1.0:
        sigma = sd / math.sqrt(1.0 - 2.0 * delta * delta / math.pi)
    mean_offset = sigma * delta * math.sqrt(2.0 / math.pi)
    mu_est = mean - mean_offset

    # MOM alpha often starts far too large; clamp for faster convergence.
    if abs(alpha) > 1000.0 * sigma:
        alpha = math.copysign(1000.0 * sigma, alpha)

    nz = counts > 0
    nz_lengths = lengths[nz]
    nz_counts = counts[nz]

    def log_likelihood(m: float, s: float, a: float) -> float:
        return float((nz_counts * mu.log_skew_normal_pdf_vec(nz_lengths, m, s, a)).sum())

    tol = 1e-4
    prev_mu = mu_est + 2.0 * tol
    prev_alpha = alpha + 2.0 * tol
    factor = 1.3  # < 1 + golden ratio so the boundary stays finite

    def expand_bracket(f, center: float, ll: float) -> tuple:
        """Grow radii around `center` until the function drops below the
        center value (or overflows to inf)."""
        left = 1.0
        while True:
            v = f(center - left)
            if not (v >= ll and not math.isinf(v)):
                break
            if math.isinf(left * factor):
                break
            left *= factor
        right = 1.0
        while True:
            v = f(center + right)
            if not (v >= ll and not math.isinf(v)):
                break
            if math.isinf(right * factor):
                break
            right *= factor
        return left, right

    it = 0
    while it < 100 and (abs(prev_mu - mu_est) >= tol or abs(prev_alpha - alpha) >= tol):
        it += 1
        prev_mu, prev_alpha = mu_est, alpha

        f_alpha = lambda a: log_likelihood(mu_est, sigma, a)  # noqa: E731
        left, right = expand_bracket(f_alpha, alpha, f_alpha(alpha))
        alpha = mu.golden_section_search(f_alpha, alpha - left, alpha + right, tol / 4.0)

        f_mu = lambda m: log_likelihood(m, sigma, alpha)  # noqa: E731
        left, right = expand_bracket(f_mu, mu_est, f_mu(mu_est))
        mu_est = mu.golden_section_search(f_mu, mu_est - left, mu_est + right, tol / 4.0)

        # Analytic sigma (Azzalini 1985 eq. 8).
        sigma = math.sqrt(float(((lengths - mu_est) ** 2 * counts).sum()) / k0)

    return mu_est, sigma, alpha
