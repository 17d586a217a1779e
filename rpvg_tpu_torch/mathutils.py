"""Host-side numeric substrate: normal / skew-normal family, log-space
helpers and 1-D optimisation.

Behavioural contract follows the reference math layer
(reference/src/utils.hpp:126-302, src/owens_t.hpp) which itself is
validated against scipy; we use scipy.special.owens_t directly for the
Owen's T function.  All functions operate in float64.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
from scipy import special as _sp

_SQRT1_2 = math.sqrt(0.5)
_INV_SQRT_2PI = 0.3989422804014327
_LOG_SKEW_CONST = math.log(2.0 * _INV_SQRT_2PI)


def phred_to_prob(phred: float) -> float:
    return 10.0 ** (-float(phred) / 10.0)


def prob_to_phred(prob: float) -> float:
    return -10.0 * math.log10(prob)


def std_normal_pdf(z: float) -> float:
    return math.exp(-0.5 * z * z) * _INV_SQRT_2PI


def std_normal_cdf(z: float) -> float:
    """Standard normal CDF with the cephes-style branch for accuracy in
    the tails (reference src/utils.hpp:142-162)."""
    x = z * _SQRT1_2
    a = abs(x)
    if a < _SQRT1_2:
        return 0.5 + 0.5 * math.erf(x)
    y = 0.5 * math.erfc(a)
    if x > 0:
        return 1.0 - y
    return y


def log_std_normal_cdf(z: float) -> float:
    """log(Phi(z)) with an asymptotic series for the deep left tail
    (reference src/utils.hpp:164-196)."""
    if z > 6.0:
        return -std_normal_cdf(-z)  # log(1 - eps) ~ -eps
    if z > -20.0:
        return math.log(std_normal_cdf(z))
    # Asymptotic expansion: Phi(z) ~ phi(z)/(-z) * sum_k (-1)^k (2k-1)!! / z^(2k)
    log_lhs = -0.5 * z * z - math.log(-z) - 0.5 * math.log(2.0 * math.pi)
    rhs = 1.0
    last = 0.0
    numerator = 1.0
    denom_factor = 1.0
    denom_cons = 1.0 / (z * z)
    sign = 1.0
    i = 0
    while abs(last - rhs) > np.finfo(np.float64).eps:
        i += 1
        last = rhs
        sign = -sign
        denom_factor *= denom_cons
        numerator *= 2 * i - 1
        rhs += sign * numerator * denom_factor
    return log_lhs + math.log(rhs)


def log_normal_pdf(x: float, loc: float, scale: float) -> float:
    z = (x - loc) / scale
    return math.log(_INV_SQRT_2PI) - math.log(scale) - 0.5 * z * z


def log_skew_normal_pdf(x: float, loc: float, scale: float, shape: float) -> float:
    z = (x - loc) / scale
    return _LOG_SKEW_CONST + log_std_normal_cdf(shape * z) - math.log(scale) - 0.5 * z * z


def skew_normal_pdf(x: float, loc: float, scale: float, shape: float) -> float:
    z = (x - loc) / scale
    return 2.0 * _INV_SQRT_2PI * math.exp(-0.5 * z * z) * std_normal_cdf(shape * z) / scale


def owens_t(h: float, a: float) -> float:
    return float(_sp.owens_t(h, a))


def skew_normal_cdf(x: float, loc: float, scale: float, shape: float) -> float:
    z = (x - loc) / scale
    return std_normal_cdf(z) - 2.0 * owens_t(z, shape)


def truncated_skew_normal_expected_value(
    loc: float, scale: float, shape: float, lo: float, hi: float
) -> float:
    """E[X | lo <= X <= hi] for X ~ SkewNormal(loc, scale, shape).

    Flecher, Allard & Naveau (2012), eq. (10); matches reference
    src/utils.hpp:236-247."""
    u = (lo - loc) / scale
    v = (hi - loc) / scale
    beta = math.sqrt(1.0 + shape * shape)
    delta = shape / beta
    val = skew_normal_pdf(u, 0.0, 1.0, shape) - skew_normal_pdf(v, 0.0, 1.0, shape)
    val += 2.0 * _INV_SQRT_2PI * delta * (std_normal_cdf(v * beta) - std_normal_cdf(u * beta))
    val /= skew_normal_cdf(v, 0.0, 1.0, shape) - skew_normal_cdf(u, 0.0, 1.0, shape)
    return loc + scale * val


def add_log(log_x: float, log_y: float) -> float:
    """log(exp(log_x) + exp(log_y)) without leaving log space."""
    if log_x > log_y:
        return log_x + math.log1p(math.exp(log_y - log_x))
    return log_y + math.log1p(math.exp(log_x - log_y))


def golden_section_search(
    f: Callable[[float], float], x_min: float, x_max: float, tolerance: float
) -> float:
    """Maximise a unimodal function on [x_min, x_max] (reference
    src/utils.hpp:250-294: precomputed step count, returns interval
    midpoint)."""
    inv_phi = (math.sqrt(5.0) - 1.0) / 2.0
    steps = int(math.ceil(math.log(tolerance / (x_max - x_min)) / math.log(inv_phi)))
    x_lo = x_min + inv_phi * inv_phi * (x_max - x_min)
    x_hi = x_min + inv_phi * (x_max - x_min)
    f_lo = f(x_lo)
    f_hi = f(x_hi)
    for _ in range(steps):
        if f_lo < f_hi:
            x_min = x_lo
            x_lo = x_hi
            x_hi = x_min + inv_phi * (x_max - x_min)
            f_lo = f_hi
            f_hi = f(x_hi)
        else:
            x_max = x_hi
            x_hi = x_lo
            x_lo = x_min + inv_phi * inv_phi * (x_max - x_min)
            f_hi = f_lo
            f_lo = f(x_lo)
    if f_lo > f_hi:
        return (x_min + x_hi) / 2.0
    return (x_lo + x_max) / 2.0


def std_normal_cdf_vec(z: np.ndarray) -> np.ndarray:
    """Vectorised standard normal CDF with the same branch structure as
    the scalar version (erf near zero, erfc in the tails)."""
    x = z * _SQRT1_2
    a = np.abs(x)
    near = a < _SQRT1_2
    y = np.where(near, 0.5 + 0.5 * _sp.erf(x), 0.5 * _sp.erfc(a))
    flip = (~near) & (x > 0)
    return np.where(flip, 1.0 - y, y)


def log_std_normal_cdf_vec(z: np.ndarray) -> np.ndarray:
    """Vectorised log(Phi(z)); the deep left tail (z <= -20) falls back
    to the scalar asymptotic series (rare)."""
    z = np.asarray(z, dtype=np.float64)
    out = np.empty_like(z)
    hi = z > 6.0
    low = z <= -20.0
    mid = ~(hi | low)
    if hi.any():
        out[hi] = -std_normal_cdf_vec(-z[hi])
    if mid.any():
        with np.errstate(divide="ignore"):
            out[mid] = np.log(std_normal_cdf_vec(z[mid]))
    if low.any():
        out[low] = [log_std_normal_cdf(float(v)) for v in np.atleast_1d(z[low])]
    return out


def log_skew_normal_pdf_vec(
    x: np.ndarray, loc: float, scale: float, shape: float
) -> np.ndarray:
    z = (np.asarray(x, dtype=np.float64) - loc) / scale
    return _LOG_SKEW_CONST + log_std_normal_cdf_vec(shape * z) - math.log(scale) - 0.5 * z * z


def log_normal_pdf_vec(x: np.ndarray, loc: float, scale: float) -> np.ndarray:
    z = (np.asarray(x, dtype=np.float64) - loc) / scale
    return math.log(_INV_SQRT_2PI) - math.log(scale) - 0.5 * z * z


def num_permutations(values: Sequence[int]) -> int:
    """Number of distinct orderings credited to a multiset group in the
    posterior prior (reference src/utils.hpp:95-117: n! / (n - u + 1)!
    where u is the number of unique values)."""
    n = len(values)
    if n == 1:
        return 1
    unique = len(set(values))
    return int(round(math.gamma(n + 1) / math.gamma(n - unique + 2)))
