"""Random keys and counter-based random bits without JAX.

Two generators live here:

* **threefry2x32**, bit-exact with ``jax.random``'s default PRNG as the
  JAX package runs it (x64 on, ``jax_threefry_partitionable`` on, the
  default of JAX 0.9): :func:`prng_key`, :func:`fold_in` and
  :func:`split` give the per-cluster keys that seed the Gibbs samplers
  (``ClusterRNG`` and ``cluster_gibbs_keys`` /
  ``cluster_gibbs_key_chains`` of the JAX package).  Keys are numpy
  ``uint32`` arrays of shape (..., 2).
* **Philox4x32-10** (Salmon et al., SC'11; Random123), the stream of the
  CUDA samplers and their plain PyTorch versions.  :func:`philox4x32`
  is written once on 64-bit integer arithmetic, so the same function runs
  on numpy ``int64`` arrays and on torch ``int64`` tensors (on any
  device); ``csrc/philox.cuh`` is its CUDA twin.  A draw is addressed by
  a counter, never by a running state, so sampling more never changes
  what was sampled before.
"""

from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFFFFFF

# ------------------------------------------------------------ threefry2x32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x0, x1)
    under ``key`` (uint32 (..., 2), broadcast against the counts), as
    ``jax._src.prng._threefry2x32_lowering`` computes it."""
    key = np.asarray(key, dtype=np.uint32)
    k0, k1 = key[..., 0], key[..., 1]
    ks = [k0, k1, k0 ^ k1 ^ np.uint32(_PARITY)]
    x = [np.asarray(x0, dtype=np.uint32) + ks[0], np.asarray(x1, dtype=np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with x64 on: the seed's two 32-bit
    halves, high word first."""
    value = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([value >> 32, value & _MASK32], dtype=np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    (0, data mod 2^32).  ``data`` may be an array (one key per value)."""
    data = np.asarray(data).astype(np.int64) & _MASK32
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros_like(data, dtype=np.uint32), data.astype(np.uint32))
    return np.stack([b0, b1], axis=-1)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` in the partitionable layout: key i
    is the hash of the count pair (0, i).  ``key`` may be a stack of keys
    (..., 2); the result is (..., num, 2)."""
    key = np.asarray(key, dtype=np.uint32)[..., None, :]
    counts = np.arange(num, dtype=np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, np.zeros_like(counts), counts)
    return np.stack([b0, b1], axis=-1)


def key_chains(seed: int, ranks, depth: int) -> np.ndarray:
    """keys[i, j]: the (j + 1)-th ``ClusterRNG.next_key()`` of cluster
    ranks[i] (``cluster_gibbs_key_chains``): fold the rank into the
    seed's key, then split ``depth`` times, keeping the second key of
    each split and carrying the first.  (n, depth, 2) uint32."""
    carry = fold_in(prng_key(seed), np.asarray(list(ranks), dtype=np.int64))
    out = np.empty(carry.shape[:-1] + (depth, 2), dtype=np.uint32)
    for j in range(depth):
        pair = split(carry)
        carry, out[..., j, :] = pair[..., 0, :], pair[..., 1, :]
    return out


def first_keys(seed: int, ranks) -> np.ndarray:
    """The key each cluster's first ``next_key()`` yields
    (``cluster_gibbs_keys``): (n, 2) uint32."""
    return key_chains(seed, ranks, 1)[:, 0]


def key_seed(key) -> int:
    """The 64-bit seed a native sampler and a Philox stream take from a
    key: its first word high, its second low (``run_native_gibbs``)."""
    key = np.asarray(key).astype(np.uint64)
    return int((key[0] << np.uint64(32)) | key[1])


# ------------------------------------------------------------ Philox4x32-10

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10


def _mulhilo(m: int, x):
    """(high, low) 32-bit words of the 64-bit product m * x (m a 32-bit
    constant, x 32-bit values in int64), with no intermediate above
    2^49, so int64 arithmetic never overflows."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    lo_part = x * m_lo            # < 2^48
    hi_part = x * m_hi            # < 2^48
    mid = lo_part + ((hi_part & 0xFFFF) << 16)   # < 2^49
    return (hi_part >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key
    (k0, k1): four 32-bit words.  Every argument is a 32-bit value held
    in 64-bit integers (numpy int64 arrays, torch int64 tensors or Python
    ints), broadcast together."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


# 2^-52: a 52-bit integer plus one half, times this, is exact.
_TWO_M52 = 1.0 / 4503599627370496.0


def uniform_pair(words, to_double):
    """Two doubles in (0, 1) from Philox's four words: words (0, 1) and
    (2, 3) each as a 64-bit integer whose top 52 bits, plus one half, are
    scaled by 2^-52 (exact, so never 0 or 1).  ``to_double`` converts an
    int64 array or tensor to float64 (exact below 2^53)."""
    w0, w1, w2, w3 = words
    a = (w0 << 20) + (w1 >> 12)
    b = (w2 << 20) + (w3 >> 12)
    return (to_double(a) + 0.5) * _TWO_M52, (to_double(b) + 0.5) * _TWO_M52


def seed_words(seeds):
    """(k0, k1) int64 arrays of 64-bit seeds (uint64 or int64 array):
    the high and the low 32-bit word."""
    seeds = np.asarray(seeds).astype(np.uint64)
    return (
        (seeds >> np.uint64(32)).astype(np.int64),
        (seeds & np.uint64(_MASK32)).astype(np.int64),
    )
