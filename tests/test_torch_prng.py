"""The port's random keys and bits without JAX: threefry2x32 keys
bit-equal to ``jax.random`` as the JAX package runs it (x64 on, the
installed JAX's default ``jax_threefry_partitionable``), and Philox4x32-10
against Random123's published known answers, in numpy and on torch
tensors."""

import jax
import numpy as np
import pytest
import torch

import rpvg_tpu  # noqa: F401  (turns x64 on, as the JAX package runs)
from rpvg_tpu.infer import batched_models as ref_batched_models
from rpvg_tpu.infer.estimators import ClusterRNG as RefClusterRNG
from rpvg_tpu_torch import prng
from rpvg_tpu_torch.infer.estimators import ClusterRNG
from rpvg_tpu_torch.ops import gibbs_cuda

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 + 5, 2**40 + 3]


def test_installed_jax_splits_partitionably():
    """The keys below follow the installed JAX's default layout."""
    assert jax.config.jax_enable_x64
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(prng.prng_key(seed), np.asarray(jax.random.PRNGKey(seed)))


def test_pinned_keys():
    assert prng.prng_key(42).tolist() == [0, 42]
    assert prng.prng_key(2**40 + 3).tolist() == [256, 3]
    folded = prng.fold_in(prng.prng_key(42), 7)
    assert folded.tolist() == [2547012911, 1371500959]
    assert prng.split(folded).tolist() == [
        [1029767004, 2691955506], [3913626572, 2520847663]
    ]


@pytest.mark.parametrize("seed", [0, 42, 2**40 + 3])
def test_fold_in_matches_jax_over_ranks(seed):
    ranks = np.arange(4096)
    base = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.vmap(lambda r: jax.random.fold_in(base, r))(ranks))
    assert np.array_equal(prng.fold_in(prng.prng_key(seed), ranks), ref)


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(num):
    key = prng.fold_in(prng.prng_key(99), 5)
    ref = np.asarray(jax.random.split(jax.random.fold_in(jax.random.PRNGKey(99), 5), num))
    assert np.array_equal(prng.split(key, num), ref)


@pytest.mark.parametrize("seed,depth", [(0, 1), (31, 8), (2**33 + 7, 64)])
def test_key_chains_match_the_jax_package(seed, depth):
    ranks = [0, 1, 2, 17, 4095, 123456]
    assert np.array_equal(
        prng.key_chains(seed, ranks, depth),
        ref_batched_models.cluster_gibbs_key_chains(seed, ranks, depth),
    )
    assert np.array_equal(
        prng.first_keys(seed, ranks), ref_batched_models.cluster_gibbs_keys(seed, ranks)
    )


def test_cluster_rng_matches_the_jax_package():
    port, ref = ClusterRNG(77, 12), RefClusterRNG(77, 12)
    for _ in range(5):
        assert np.array_equal(port.next_key(), np.asarray(ref.next_key()))
    assert port.np_rng.binomial(10, 0.3) == ref.np_rng.binomial(10, 0.3)


def test_key_seed_packs_words_high_first():
    assert prng.key_seed(np.array([1, 2], dtype=np.uint32)) == (1 << 32) | 2
    assert prng.key_seed(np.array([2**32 - 1, 0], dtype=np.uint32)) == (2**32 - 1) << 32


# Random123 kat_vectors: philox4x32 10, counter, key, expected output.
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (
        (0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
    ),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


@pytest.mark.parametrize("counter,key,expected", KNOWN_ANSWERS)
def test_philox_known_answers_numpy(counter, key, expected):
    args = [np.array([v], dtype=np.int64) for v in (*counter, *key)]
    assert [int(w[0]) for w in prng.philox4x32(*args)] == list(expected)


def test_philox_known_answers_torch():
    """All three vectors at once on int64 tensors (the plain samplers'
    arithmetic)."""
    columns = list(zip(*[(*counter, *key) for counter, key, _ in KNOWN_ANSWERS]))
    args = [torch.tensor(col, dtype=torch.int64) for col in columns]
    words = prng.philox4x32(*args)
    got = list(zip(*[w.tolist() for w in words]))
    assert got == [expected for _, _, expected in KNOWN_ANSWERS]


def test_uniforms_are_open_and_exact():
    lo = prng.uniform_pair([np.zeros(1, np.int64)] * 4, lambda a: a.astype(np.float64))
    hi = prng.uniform_pair([np.full(1, 2**32 - 1, np.int64)] * 4, lambda a: a.astype(np.float64))
    assert lo[0][0] == lo[1][0] == 2.0**-53
    assert hi[0][0] == hi[1][0] == 1.0 - 2.0**-53


def test_uniforms_agree_between_numpy_and_torch_routes():
    """gibbs_cuda.uniforms runs the rounds in numpy on the CPU; the torch
    route (any other device) must draw the same doubles."""
    c1 = torch.arange(50, dtype=torch.int64)
    k0 = torch.full((50,), 123456789, dtype=torch.int64)
    k1 = torch.full((50,), 987654321, dtype=torch.int64)
    via_numpy = gibbs_cuda.uniforms(7, c1, 3, 1 << 24, k0, k1)
    via_torch = prng.uniform_pair(
        prng.philox4x32(7, c1, 3, 1 << 24, k0, k1), lambda a: a.to(torch.float64)
    )
    assert torch.equal(via_numpy[0], via_torch[0]) and torch.equal(via_numpy[1], via_torch[1])
    u = torch.cat(via_numpy)
    assert bool(((u > 0) & (u < 1)).all())
