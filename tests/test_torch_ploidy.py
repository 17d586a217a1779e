"""Ploidy k != 2 on the port, on the CPU: the full group enumeration
(``group_scores_plain``, ``full_posteriors_batched`` and the host engine
``path_group_posteriors_full``) and the k-slot posterior sampler's plain
version against the JAX package (the slice end to end is
tests/test_torch_ploidy_slice.py).

Tolerances: group scores within rtol 1e-10 with identical -inf (the
sums over rows run in another order); posteriors within rtol 1e-9 /
atol 1e-13 with identical group lists.  The k-slot sampler draws from
Philox, the JAX package's from threefry, so the two are held to each
other in distribution: total variation < 0.05 and the same dominant
group (tests/test_gibbs_crossbackend.py's bound)."""

import math

import numpy as np
import pytest
import torch

import rpvg_tpu  # noqa: F401  (x64 on)
from rpvg_tpu.infer import posteriors as ref_posteriors
from rpvg_tpu_torch import prng
from rpvg_tpu_torch.infer import posteriors
from rpvg_tpu_torch.mathutils import num_permutations
from rpvg_tpu_torch.ops import group_scores_cuda, posterior_gibbs_k_cuda
from rpvg_tpu_torch.testing import enumeration_cluster_set, posterior_wide_cluster

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SEED = 31


def _tv(a, b):
    return 0.5 * sum(abs(a.get(g, 0.0) - b.get(g, 0.0)) for g in set(a) | set(b))


def _as_dict(groups, posts):
    return {tuple(g): float(p) for g, p in zip(groups, posts)}


# ------------------------------------------------ the full enumeration


@pytest.mark.parametrize("k", [1, 3, 4, 5])
def test_group_scores_plain_matches_jax(k):
    """``group_scores_plain`` against ``_group_scores_chunk`` on the same
    padded batch, with a row of zero noise and near-zero probabilities
    (groups scored -inf) and padded rows and paths."""
    rng = np.random.default_rng(100 + k)
    B, R, P = 3, 24, 8
    probs = rng.random((B, R, P)) * (rng.random((B, R, P)) < 0.6)
    noise = rng.uniform(1e-4, 0.05, (B, R))
    counts = rng.integers(1, 6, (B, R)).astype(np.float64)
    noise[0, 3], probs[0, 3], probs[0, 3, 2] = 0.0, 0.0, 0.4
    probs[1, 20:], noise[1, 20:], counts[1, 20:] = 0.0, 1.0, 0.0
    probs[2, :, 6:] = 0.0
    idx = group_scores_cuda.group_table(P, k)
    ref = np.asarray(ref_posteriors._group_scores_chunk(probs, noise, counts, idx))
    port = group_scores_cuda.group_scores_plain(
        *(torch.from_numpy(a) for a in (probs, noise, counts, idx))
    ).numpy()
    assert port.shape == ref.shape == (B, math.comb(P + k - 1, k))
    assert np.array_equal(np.isneginf(port), np.isneginf(ref)) and np.isneginf(ref).any()
    finite = np.isfinite(ref)
    np.testing.assert_allclose(port[finite], ref[finite], rtol=1e-10, atol=0)


@pytest.mark.parametrize("k", [1, 3, 4, 5])
def test_full_posteriors_batched_matches_jax_and_host_engine(k):
    clusters = enumeration_cluster_set(10, seed=110 + k, group_size=k, max_rows=64)
    scored = posteriors.SCORED_CLUSTERS["cpu"]
    port = posteriors.full_posteriors_batched(clusters, k, CPU)
    assert posteriors.SCORED_CLUSTERS["cpu"] == scored + len(clusters)
    ref = ref_posteriors.full_posteriors_batched(clusters, k)
    for cluster, (groups, post), (ref_groups, ref_post) in zip(clusters, port, ref):
        assert groups == ref_groups
        np.testing.assert_allclose(post, ref_post, rtol=1e-9, atol=1e-13)
        host_groups, host_post = posteriors.path_group_posteriors_full(*cluster, k)
        assert groups == host_groups
        np.testing.assert_allclose(post, host_post, rtol=1e-9, atol=1e-13)
        assert sum(post) == pytest.approx(1.0)


def test_full_posteriors_host_fallback_over_the_group_limit(monkeypatch):
    """A cluster whose padded enumeration exceeds the limit runs the host
    engine, counted with its seconds; the others still go through the
    scorer (as tests/test_inference.py forces it in the JAX package)."""
    clusters = enumeration_cluster_set(4, seed=120, group_size=3, max_rows=20)
    # At most 8 paths (comb(8 + 2, 3) = 120 groups) stay on the scorer.
    monkeypatch.setattr(posteriors, "_FULL_ENUM_GROUP_LIMIT", 120)
    monkeypatch.setattr(ref_posteriors, "_FULL_ENUM_GROUP_LIMIT", 120)
    before = dict(posteriors.HOST_ENUMERATION)
    port = posteriors.full_posteriors_batched(clusters, 3, CPU)
    fell_back = sum(
        math.comb(posteriors._ceil_pow2(c[0].shape[1]) + 2, 3) > 120 for c in clusters
    )
    assert 0 < fell_back < len(clusters)
    assert posteriors.HOST_ENUMERATION["clusters"] == before["clusters"] + fell_back
    assert posteriors.HOST_ENUMERATION["seconds"] > before["seconds"]
    ref = ref_posteriors.full_posteriors_batched(clusters, 3)
    for (groups, post), (ref_groups, ref_post) in zip(port, ref):
        assert groups == [list(g) for g in ref_groups]
        np.testing.assert_allclose(post, ref_post, rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_path_group_posteriors_full_matches_jax(k):
    """The host engine (its group-size-2 branch scores pairs on the CPU)
    against the JAX package's."""
    (cluster,) = enumeration_cluster_set(3, seed=130 + k, group_size=k, max_paths=9)[2:]
    groups, post = posteriors.path_group_posteriors_full(*cluster, k)
    ref_groups, ref_post = ref_posteriors.path_group_posteriors_full(*cluster, k)
    assert groups == [list(g) for g in ref_groups]
    np.testing.assert_allclose(post, ref_post, rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 7])
def test_log_permutations_rows_is_num_permutations(k):
    groups = group_scores_cuda.group_table(6, k)
    expected = [math.log(num_permutations(list(row))) for row in groups]
    np.testing.assert_array_equal(posteriors._log_permutations_rows(groups), expected)


def test_ragged_clusters_and_tables():
    """Tables are shared per P; offsets address every cluster's rows and
    scores; the plain route fills every score once; the kernel's blocks
    cover every group once, a cluster of 7,000 paths too."""
    clusters = enumeration_cluster_set(6, seed=140, group_size=3, max_rows=30)
    clusters.append(clusters[3])
    packed = group_scores_cuda.make_clusters([c[:3] for c in clusters], 3, CPU)
    host = packed.host
    P = host["n_cols"]
    assert host["table_offsets"][3] == host["table_offsets"][6]
    assert list(host["n_groups"]) == [math.comb(int(p) + 2, 3) for p in P]
    scores = group_scores_cuda.group_scores(packed).numpy()
    assert scores.shape == (host["out_offsets"][-1],)
    np.testing.assert_array_equal(
        scores[host["out_offsets"][3] : host["out_offsets"][4]],
        scores[host["out_offsets"][6] : host["out_offsets"][7]],
    )
    groups = list(host["n_groups"]) + [7000]
    cluster, first, split = group_scores_cuda.plan_blocks(list(host["n_rows"]) + [3], groups)
    assert sorted(set(cluster.tolist())) == list(range(len(P) + 1))
    assert sum(min(256 // split[c], groups[c] - f) for c, f in zip(cluster, first)) == sum(groups)


# ---------------------------------------------- the k-slot sampler


@pytest.fixture
def crossbackend_cluster():
    """tests/test_gibbs_crossbackend.py's 60 x 6 cluster plus noise."""
    rng = np.random.default_rng(21)
    R, P = 60, 6
    probs = rng.random((R, P + 1)) * 0.5
    probs /= probs.sum(axis=1, keepdims=True)
    counts = rng.integers(1, 12, size=R).astype(np.float64)
    return probs[:, :-1], probs[:, -1], counts, [1] * P


def test_plain_k_slot_sampler_matches_jax_distribution(crossbackend_cluster):
    key = prng.prng_key(33)
    groups, post = posteriors.path_group_posteriors_gibbs_batched(
        [crossbackend_cluster], 3, [key], CPU
    )[0]
    ref_groups, ref_post = ref_posteriors.path_group_posteriors_gibbs(
        *crossbackend_cluster, 3, key
    )
    port, ref = _as_dict(groups, post), _as_dict(ref_groups, ref_post)
    assert _tv(port, ref) < 0.05
    assert max(port, key=port.get) == max(ref, key=ref.get)
    assert sum(post) == pytest.approx(1.0)
    assert all(list(g) == sorted(g) for g in groups)


def _k_jobs(clusters, k, sizing, seed=7):
    keys = prng.split(prng.prng_key(seed), len(clusters))
    return posterior_gibbs_k_cuda.make_jobs(
        [(p, n, c, posteriors.calc_path_log_frequencies(pc)) for p, n, c, pc in clusters],
        k, sizing, [prng.key_seed(key) for key in keys], CPU,
    )


def _chain_samples(jobs, out, b):
    h = jobs.host
    steps = int(h["n_burn"][b] + h["n_its"][b])
    return out[h["out_offsets"][b] : h["out_offsets"][b + 1]].reshape(
        int(h["n_chains"][b]), steps, jobs.group_size
    )


def test_plain_k_slot_sampler_prefix_property():
    """A run with fewer iterations is the prefix of a longer one."""
    clusters = enumeration_cluster_set(5, seed=150, group_size=3, max_paths=12, max_rows=40)
    short = _k_jobs(clusters, 3, [(4, 5, 7)] * len(clusters))
    long = _k_jobs(clusters, 3, [(4, 5, 19)] * len(clusters))
    out_short = posterior_gibbs_k_cuda.posterior_gibbs_k(short).numpy()
    out_long = posterior_gibbs_k_cuda.posterior_gibbs_k(long).numpy()
    for b in range(len(clusters)):
        a, z = _chain_samples(short, out_short, b), _chain_samples(long, out_long, b)
        np.testing.assert_array_equal(a, z[:, : a.shape[1]])


def test_plain_k_slot_sampler_cluster_independent_of_neighbours():
    clusters = enumeration_cluster_set(6, seed=151, group_size=4, max_paths=20, max_rows=40)
    clusters.append(posterior_wide_cluster(40, seed=152, n_rows=12))
    sizing = [(3, 4, 6)] * len(clusters)
    together = _k_jobs(clusters, 4, sizing)
    out = posterior_gibbs_k_cuda.posterior_gibbs_k(together).numpy()
    keys = prng.split(prng.prng_key(7), len(clusters))
    for b in (2, len(clusters) - 1):
        alone = posterior_gibbs_k_cuda.make_jobs(
            [(*clusters[b][:3], posteriors.calc_path_log_frequencies(clusters[b][3]))], 4,
            [sizing[b]], [prng.key_seed(keys[b])], CPU,
        )
        np.testing.assert_array_equal(
            _chain_samples(together, out, b),
            _chain_samples(alone, posterior_gibbs_k_cuda.posterior_gibbs_k(alone).numpy(), 0),
        )


def test_plain_k_slot_sampler_edge_clusters():
    """One path (every slot draws path 0); a row of zero noise and zero
    probabilities on most paths (their logits -inf, never drawn); k = 1;
    every sample a valid path index, each chain's start uniform."""
    clusters = enumeration_cluster_set(3, seed=153, group_size=3, max_paths=9, max_rows=10)
    for k in (1, 3, 5):
        jobs = _k_jobs(clusters, k, [(5, 3, 8)] * 3)
        out = posterior_gibbs_k_cuda.posterior_gibbs_k(jobs).numpy()
        assert (_chain_samples(jobs, out, 0) == 0).all()
        blocked = _chain_samples(jobs, out, 2)[:, 1:]
        assert (blocked >= 0).all() and (blocked < clusters[2][0].shape[1]).all()
        if k > 1:
            # The zero row forbids groups without path 0 once a chain has
            # mixed in: each later group holds path 0 in some slot.
            assert (blocked[:, 2:] == 0).any(axis=2).all()
        results = posteriors._group_sample_posteriors(out, jobs.host, k)
        for groups, freqs in results:
            assert abs(float(np.sum(freqs)) - 1.0) < 1e-12
            assert all(list(g) == sorted(g) and len(g) == k for g in groups)


def test_launch_plans_cover_every_cluster_once():
    """Every cluster in one launch; a team of 32-1,024 threads by its logs
    per slot step (R + nonzeros), a cluster of CTAs past 1,024 threads'
    worth; staged when each CTA's rows and list slice fit, and each
    launch's shared memory within the limit."""
    rows, cols = [1, 20, 150, 400, 3000], [1, 28, 200, 120, 120]
    nonzeros = [1, 300, 9000, 24000, 100000]
    plan = posterior_gibbs_k_cuda.plan_launches(rows, cols, nonzeros, 3)
    covered = np.sort(np.concatenate([lc.tasks for lc in plan]))
    np.testing.assert_array_equal(covered, np.arange(5))
    team = {int(t): (lc.threads, lc.ctas, lc.staged) for lc in plan for t in lc.tasks}
    assert team[0] == (32, 1, True) and team[1] == (64, 1, True)
    assert team[2] == (1024, 2, True) and team[3] == (1024, 4, False)
    assert team[4] == (1024, 8, False)
    for lc in plan:
        assert lc.smem_bytes <= posterior_gibbs_k_cuda.SMEM_LIMIT
        assert lc.threads in (32, 64, 128, 256, 512, 1024) and lc.ctas in (1, 2, 4, 8)
    # Given the largest CTA slice, it decides, not the whole cluster.
    sliced = posterior_gibbs_k_cuda.plan_launches([400, 3000], [120, 120], [24000, 100000], 3,
                                                   [6000, 12500])
    assert [(lc.ctas, lc.staged) for lc in sliced] == [(8, True), (4, True)]


@pytest.mark.parametrize("ctas", [1, 2, 8])
def test_nonzero_lists_give_the_dense_logits(ctas):
    """The kernel's logits from the nonzero lists (Z over the rows' logs,
    plus each list entry's log difference; -inf for a path with a zero
    entry in a row of base 0) equal the dense sum of counts x log(base +
    probs / k) over all rows within rtol 1e-12, -inf where it is -inf;
    every entry sits in its CTA's row slice, in (path, row) order."""
    clusters = enumeration_cluster_set(6, seed=160 + ctas, group_size=3, max_paths=24, max_rows=40)
    k = 3
    for probs, noise, counts, _ in clusters:
        R, P = probs.shape
        rows, q, ptr = posterior_gibbs_k_cuda.nonzero_lists(probs, k, ctas)
        rows_per = -(-R // ctas)
        assert ptr.size == ctas * P + 1 and ptr[-1] == np.count_nonzero(probs)
        lf = np.log(np.arange(1.0, P + 1.0) / P)
        rng = np.random.default_rng(R * 31 + P)
        for group in (rng.integers(0, P, k), np.zeros(k, dtype=np.int64)):
            for j in range(k):
                acc = np.zeros(R)
                for i in range(k):
                    acc = acc + (probs[:, group[i]] if i != j else 0.0)
                base = noise + acc / k
                with np.errstate(divide="ignore", invalid="ignore"):
                    x = base[:, None] + probs / k
                    dense = (counts[:, None] * np.where(x > 0, np.log(np.maximum(x, 1e-300)), -np.inf)).sum(axis=0) + lf
                    dense = np.where(np.isnan(dense), -np.inf, dense)
                    lb = np.where(base > 0, np.log(np.maximum(base, 1e-300)), -np.inf)
                good = base > 0
                z = float((counts[good] * lb[good]).sum())
                n_bad = int((~good).sum())
                logits = np.full(P, z)
                hits = np.zeros(P, dtype=np.int64)
                for c in range(ctas):
                    for p in range(P):
                        for e in range(ptr[c * P + p], ptr[c * P + p + 1]):
                            r = c * rows_per + int(rows[e])
                            assert 0 <= rows[e] < rows_per and probs[r, p] != 0
                            assert q[e] == probs[r, p] / k
                            lx = np.log(base[r] + q[e])
                            if good[r]:
                                logits[p] += counts[r] * (lx - lb[r])
                            else:
                                logits[p] += counts[r] * lx
                                hits[p] += 1
                logits = np.where(hits < n_bad, -np.inf, logits + lf)
                np.testing.assert_array_equal(np.isneginf(logits), np.isneginf(dense))
                finite = np.isfinite(dense)
                np.testing.assert_allclose(logits[finite], dense[finite], rtol=1e-12, atol=0)


def test_cpu_tensors_take_plain_versions_without_launch():
    clusters = enumeration_cluster_set(3, seed=154, group_size=3, max_rows=10)
    launches = group_scores_cuda.LAUNCHES, posterior_gibbs_k_cuda.LAUNCHES
    posteriors.full_posteriors_batched(clusters, 3, CPU)
    jobs = _k_jobs(clusters, 3, [(2, 2, 3)] * 3)
    assert torch.equal(
        posterior_gibbs_k_cuda.posterior_gibbs_k(jobs),
        posterior_gibbs_k_cuda.posterior_gibbs_k_plain(jobs),
    )
    assert (group_scores_cuda.LAUNCHES, posterior_gibbs_k_cuda.LAUNCHES) == launches
