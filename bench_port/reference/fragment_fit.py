"""The fragment-length re-fit as rpvg computes it
(``src/fragment_length_dist.cpp:103-278``, ``src/utils.hpp:142-294``):
the skew-normal maximum-likelihood fit from moment estimates by
alternating golden-section searches on the shape and the location, the
scale in closed form between them.

The search stops at a tolerance of 1e-4, so the fitted parameters, and
every probability after them, depend on the rounding of each
log-likelihood the search compares: this version sums in the order and
with the scalar operations of rpvg's loops (one multiply and one add per
term, no fused operations), not in NumPy's pairwise order."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

SQRT_HALF = 0.70710678118654757
LOG_SKEW_CONST = -0.2257913526447274  # log(2 / sqrt(2 pi))


def _std_normal_cdf(z: float) -> float:
    x = z * SQRT_HALF
    a = abs(x)
    if a < SQRT_HALF:
        return 0.5 + 0.5 * math.erf(x)
    y = 0.5 * math.erfc(a)
    return 1.0 - y if x > 0 else y


def _log_std_normal_cdf(z: float) -> float:
    if z > 6.0:
        return -_std_normal_cdf(-z)
    if z > -20.0:
        return math.log(_std_normal_cdf(z))
    # Asymptotic series of the lower tail.
    log_lhs = -0.5 * z * z - math.log(-z) - 0.5 * math.log(2.0 * math.pi)
    rhs, last, numerator, denom_factor = 1.0, 0.0, 1.0, 1.0
    denom_cons = 1.0 / (z * z)
    sign = 1.0
    i = 0
    while abs(last - rhs) > 2.220446049250313e-16:
        i += 1
        last = rhs
        sign = -sign
        denom_factor *= denom_cons
        numerator *= 2 * i - 1
        rhs += sign * numerator * denom_factor
    return log_lhs + math.log(rhs)


def _log_likelihood(lengths: Sequence[float], counts: Sequence[float], m: float, s: float,
                    a: float) -> float:
    total = 0.0
    log_s = math.log(s)
    for x, c in zip(lengths, counts):
        z = (x - m) / s
        total += c * (LOG_SKEW_CONST + _log_std_normal_cdf(a * z) - log_s - 0.5 * z * z)
    return total


def _golden_section_search(f, x_min: float, x_max: float, tolerance: float) -> float:
    inv_phi = (math.sqrt(5.0) - 1.0) / 2.0
    steps = math.ceil(math.log(tolerance / (x_max - x_min)) / math.log(inv_phi))
    x_lo = x_min + inv_phi * inv_phi * (x_max - x_min)
    x_hi = x_min + inv_phi * (x_max - x_min)
    f_lo, f_hi = f(x_lo), f(x_hi)
    for _ in range(steps):
        if f_lo < f_hi:
            x_min, x_lo = x_lo, x_hi
            x_hi = x_min + inv_phi * (x_max - x_min)
            f_lo, f_hi = f_hi, f(x_hi)
        else:
            x_max, x_hi = x_hi, x_lo
            x_lo = x_min + inv_phi * inv_phi * (x_max - x_min)
            f_hi, f_lo = f_lo, f(x_lo)
    return (x_min + x_hi) / 2.0 if f_lo > f_hi else (x_lo + x_max) / 2.0


def _expand_bracket(f, center: float, ll: float) -> Tuple[float, float]:
    factor = 1.3
    radii = []
    for direction in (-1.0, 1.0):
        r = 1.0
        while True:
            v = f(center + direction * r)
            if not (v >= ll) or math.isinf(v) or math.isinf(r * factor):
                break
            r *= factor
        radii.append(r)
    return radii[0], radii[1]


def fit_skew_normal(counts: np.ndarray) -> Tuple[float, float, float]:
    """(location, scale, shape) of the histogram ``counts`` (index =
    fragment length)."""
    counts = [float(c) for c in counts]
    k0 = k1 = k2 = k3 = 0.0
    for i, c in enumerate(counts):
        x = float(i)
        k0 += c
        k1 += x * c
        k2 += x * x * c
        k3 += x * x * x * c
    m1 = k1 / k0
    m2 = k2 / k0 - m1 * m1
    m3 = k3 / k0 - 3.0 * m1 * m2 - m1 * m1 * m1
    sd = math.sqrt(m2)
    skew = m3 / (sd * sd * sd)

    alpha = sigma = 0.0
    if skew != 0.0 and k0 > 2.0:
        gam = math.pow(min(abs(skew), 0.9952717464311565), 2.0 / 3.0)
        abs_delta = math.sqrt((math.pi / 2.0)
                              * (gam / (gam + math.pow((4.0 - math.pi) / 2.0, 2.0 / 3.0))))
        abs_alpha = abs_delta / math.sqrt(1.0 - abs_delta * abs_delta)
        alpha = -abs_alpha if skew < 0.0 else abs_alpha
    delta = alpha / math.sqrt(1.0 + alpha * alpha)
    if sd != 0.0 and k0 > 1.0:
        sigma = sd / math.sqrt(1.0 - 2.0 * delta * delta / math.pi)
    mu = m1 - sigma * delta * math.sqrt(2.0 / math.pi)
    if abs(alpha) > 1000.0 * sigma:
        alpha = math.copysign(1000.0 * sigma, alpha)

    lengths = [float(i) for i, c in enumerate(counts) if c > 0]
    weights = [c for c in counts if c > 0]
    tol = 1e-4
    prev_mu, prev_alpha = mu + 2.0 * tol, alpha + 2.0 * tol
    it = 0
    while it < 100 and (abs(prev_mu - mu) >= tol or abs(prev_alpha - alpha) >= tol):
        it += 1
        prev_mu, prev_alpha = mu, alpha

        def f_alpha(a):
            return _log_likelihood(lengths, weights, mu, sigma, a)

        left, right = _expand_bracket(f_alpha, alpha, f_alpha(alpha))
        alpha = _golden_section_search(f_alpha, alpha - left, alpha + right, tol / 4.0)

        def f_mu(m):
            return _log_likelihood(lengths, weights, m, sigma, alpha)

        left, right = _expand_bracket(f_mu, mu, f_mu(mu))
        mu = _golden_section_search(f_mu, mu - left, mu + right, tol / 4.0)

        acc = 0.0
        for i, c in enumerate(counts):
            d = float(i) - mu
            acc += d * d * c
        sigma = math.sqrt(acc / k0)
    return mu, sigma, alpha


def refit(counts: np.ndarray) -> Tuple[float, float, float]:
    """The re-estimated distribution the probabilities use: (location,
    scale, shape) of the histogram of unique unambiguous pairs."""
    loc, scale, shape = fit_skew_normal(counts)
    if not (loc >= 0 and scale > 0):
        raise ValueError("the fragment-length fit is not valid")
    return loc, scale, shape
