"""The port's Gibbs samplers on the CPU against the JAX package.

* The CPU route (the port's copies of the native mt19937 samplers) is
  bitwise the JAX package's on the same keys.
* The plain PyTorch versions of the CUDA samplers (Philox streams) are
  held to the distributional bounds of tests/test_gibbs_crossbackend.py
  against the JAX package's samplers (``RPVG_TPU_NATIVE_EM=0``).
* The plain read-count sampler's counter-based stream: S and 2S samples
  share their first S samples bitwise; a job's samples do not depend on
  the other jobs beside it; edge jobs."""

import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import rpvg_tpu  # noqa: F401  (x64 on)
from rpvg_tpu.infer import posteriors as ref_posteriors
from rpvg_tpu.infer import readcount_gibbs as ref_readcount_gibbs
from rpvg_tpu.infer.batched_models import cluster_gibbs_keys
from rpvg_tpu_torch import prng
from rpvg_tpu_torch.infer import estimators, posteriors, readcount_gibbs
from rpvg_tpu_torch.infer.batching import pack_ragged
from rpvg_tpu_torch.ops import gibbs_cuda, posterior_gibbs_cuda
from rpvg_tpu_torch.testing import counted, gibbs_edge_jobs, gibbs_job_set

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture
def cluster():
    """tests/test_gibbs_crossbackend.py's 60 x 7 fixture."""
    rng = np.random.default_rng(21)
    R, P = 60, 6
    probs = rng.random((R, P + 1)) * 0.5
    probs /= probs.sum(axis=1, keepdims=True)
    counts = rng.integers(1, 12, size=R).astype(np.float64)
    return probs, counts


def _gibbs_jobs(seed, n):
    return gibbs_job_set(n, seed)[:n]


def _jobs_on(inputs, keys, samples):
    tasks = pack_ragged([(item[0], item[1]) for item in inputs], CPU)
    return gibbs_cuda.make_jobs(
        tasks, np.arange(len(inputs)), [readcount_gibbs.initial_fractions(i) for i in inputs],
        [prng.key_seed(k) for k in keys], samples,
    )


# ------------------------------------------------- the CPU route, bitwise


def test_cpu_route_is_bitwise_the_jax_packages():
    inputs = _gibbs_jobs(3, 40)
    keys = list(cluster_gibbs_keys(5, range(40)))
    samples = [int(s) for s in np.random.default_rng(4).integers(1, 9, size=40)]
    port = readcount_gibbs.run_batched_gibbs(inputs, keys, samples, 7, 1.0, CPU)
    ref = ref_readcount_gibbs.run_batched_gibbs(inputs, keys, samples, 7)
    for (pn, pp), (rn, rp) in zip(port, ref):
        assert np.array_equal(pn, rn) and np.array_equal(pp, rp)


def test_single_cluster_wrappers_are_bitwise_the_jax_packages(cluster):
    probs, counts = cluster
    total = float(counts.sum())
    abundances = np.full(6, total / 6)
    key = prng.fold_in(prng.prng_key(8), 3)
    port = estimators.gibbs_read_count_samples(probs, counts, abundances, 1.0, total, key, 5, 4)
    ref = ref_readcount_gibbs.gibbs_read_count_samples(
        probs, counts, abundances, 1.0, total, key, 5, 4
    )
    assert all(np.array_equal(a, b) for a, b in zip(port, ref))
    groups, post = estimators.path_group_posteriors_gibbs(
        probs[:, :-1], probs[:, -1], counts, [1] * 6, 2, key
    )
    ref_groups, ref_post = ref_posteriors.path_group_posteriors_gibbs(
        probs[:, :-1], probs[:, -1], counts, [1] * 6, 2, key
    )
    assert groups == ref_groups and np.array_equal(post, ref_post)


def test_posterior_native_route_is_bitwise_the_jax_packages():
    rng = np.random.default_rng(9)
    inputs = []
    for R, P in [(5, 3), (30, 9), (12, 1), (60, 14)]:
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.7)
        inputs.append((probs, rng.uniform(1e-4, 0.1, R), rng.integers(1, 6, R).astype(float),
                       rng.integers(1, 4, P).tolist()))
    keys = list(cluster_gibbs_keys(11, range(len(inputs))))
    port = posteriors.path_group_posteriors_gibbs_batched(inputs, 2, keys, CPU)
    ref = ref_posteriors._posterior_gibbs_native(inputs, keys)
    for (pg, pp), (rg, rp) in zip(port, ref):
        assert pg == rg and np.array_equal(pp, rp)


def test_dedup_pairs_reads_the_native_buffer_as_the_native_route_does(monkeypatch):
    """``_dedup_pairs`` repeats the verbatim ``_posterior_gibbs_native``'s
    read of the native pair-dedup buffer: on the pairs the native sampler
    drew, both give the same groups and frequencies (each pair sorted,
    then counted, as numpy does it), so a change to the buffer's format
    fails here for both copies."""
    from rpvg_tpu_torch import native

    rng = np.random.default_rng(12)
    inputs = []
    for R, P in [(8, 4), (40, 11), (5, 1), (70, 23)]:
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.6)
        inputs.append((probs, rng.uniform(1e-4, 0.1, R), rng.integers(1, 6, R).astype(float),
                       rng.integers(1, 4, P).tolist()))
    keys = list(cluster_gibbs_keys(13, range(len(inputs))))
    lib = native.load_library()
    drawn = {}

    class Recorder:
        """The library, with the sampler's output buffer kept."""

        def __getattr__(self, name):
            return getattr(lib, name)

        def __setattr__(self, name, value):
            setattr(lib, name, value)

        def rpvg_posterior_gibbs_ragged(self, *args):
            lib.rpvg_posterior_gibbs_ragged(*args)
            n, view = args[8], np.ctypeslib.as_array
            offsets = view(args[7], shape=(n + 1,)).copy()
            drawn.update(offsets=offsets, chains=view(args[3], shape=(n,)).copy(),
                         its=view(args[5], shape=(n,)).copy(),
                         samples=view(args[10], shape=(int(offsets[-1]),)).copy())

    monkeypatch.setattr(native, "load_library", lambda *a, **k: Recorder())
    native_route = posteriors._posterior_gibbs_native(inputs, keys)
    monkeypatch.undo()
    ours = posteriors._dedup_pairs(drawn["samples"], drawn["offsets"], drawn["chains"], drawn["its"])
    assert len(ours) == len(native_route) == len(inputs)
    for b, ((groups, freqs), (ref_groups, ref_freqs)) in enumerate(zip(ours, native_route)):
        assert groups == ref_groups and np.array_equal(freqs, ref_freqs)
        pairs = drawn["samples"][drawn["offsets"][b] : drawn["offsets"][b + 1]].reshape(-1, 2)
        unique, counts = np.unique(np.sort(pairs, axis=1), axis=0, return_counts=True)
        assert groups == unique.tolist()
        np.testing.assert_array_equal(freqs, counts / float(len(pairs)))


def test_other_group_sizes_name_item_10():
    """Group sizes other than 2 (ROADMAP queue 1, item 10) run the k-slot
    sampler: no clusters give no results, and a cluster at group size 3
    takes the plain version on the CPU, not the pair-score samplers."""
    assert posteriors.path_group_posteriors_gibbs_batched([], 3, [], CPU) == []
    cluster = _edge_posterior()
    with counted() as counts:
        (groups, freqs), = posteriors.path_group_posteriors_gibbs_batched(
            [cluster], 3, [prng.prng_key(3)], CPU
        )
    assert counts["gibbs.pair.launches"] == 0
    assert all(len(g) == 3 and list(g) == sorted(g) for g in groups)
    assert float(np.sum(freqs)) == pytest.approx(1.0)


# ------------------------------------------------- the plain versions


def test_plain_readcount_sampler_matches_jax_distribution(cluster):
    """400 samples at thin 50 from each sampler, as 40 chains of 10 from
    the same start on independent keys (the JAX package's vmapped
    sampler, and the plain version): per path and noise within 6
    standard errors and KS p > 1e-3."""
    probs, counts = cluster
    total = float(counts.sum())
    P = probs.shape[1] - 1
    abundances = np.full(P, total / P)
    item = (probs, counts, abundances, 1.0, total)
    chains, samples, thin = 40, 10, 50
    keys = prng.split(prng.prng_key(77), chains)
    jobs = _jobs_on([item] * chains, keys, [samples] * chains)
    fracs = gibbs_cuda.gibbs_read_counts_plain(jobs, thin, 1.0).numpy()
    noise_p, paths_p = readcount_gibbs._fold_low_abundance(fracs.reshape(-1, P + 1), total)

    init = readcount_gibbs.initial_fractions(item)
    stack = lambda a: np.repeat(a[None], chains, axis=0)  # noqa: E731
    ref_fracs = np.asarray(
        ref_readcount_gibbs._gibbs_read_counts_vmapped(
            prng.split(prng.prng_key(78), chains), stack(probs), stack(counts), stack(init),
            np.ones((chains, P + 1)), 1.0, samples, thin,
        ),
        dtype=np.float64,
    )
    noise_j, paths_j = ref_readcount_gibbs._fold_low_abundance(ref_fracs.reshape(-1, P + 1), total)
    for a, b in [(noise_p, noise_j)] + [(paths_p[:, p], paths_j[:, p]) for p in range(P)]:
        se = np.sqrt(a.var() / len(a) + b.var() / len(b))
        assert abs(a.mean() - b.mean()) < max(6 * se, 1e-6 * total), (a.mean(), b.mean(), se)
        assert ks_2samp(a, b).pvalue > 1e-3


def test_plain_posterior_sampler_matches_jax_distribution(cluster, monkeypatch):
    """Total variation < 0.05 and the same top group against the JAX
    package's threefry chains, on the same fixture."""
    probs_full, counts = cluster
    probs, noise = probs_full[:, :-1], probs_full[:, -1]
    key = prng.prng_key(33)
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    groups_p, post_p = posteriors.path_group_posteriors_gibbs_batched(
        [(probs, noise, counts, [1] * 6)], 2, [key], CPU
    )[0]
    groups_j, post_j = ref_posteriors.path_group_posteriors_gibbs(
        probs, noise, counts, [1] * 6, 2, key
    )
    dist_p = {tuple(g): p for g, p in zip(groups_p, post_p)}
    dist_j = {tuple(g): p for g, p in zip(groups_j, post_j)}
    tv = 0.5 * sum(abs(dist_p.get(g, 0.0) - dist_j.get(g, 0.0)) for g in set(dist_p) | set(dist_j))
    assert tv < 0.05, tv
    assert max(dist_p, key=dist_p.get) == max(dist_j, key=dist_j.get)
    assert sum(post_p) == pytest.approx(1.0)


def test_plain_readcount_prefix_property():
    """S and 2S samples: the first S are bitwise the same."""
    inputs = _gibbs_jobs(12, 6)
    keys = list(prng.split(prng.prng_key(4), 6))
    short = gibbs_cuda.gibbs_read_counts_plain(_jobs_on(inputs, keys, [3] * 6), 5, 1.0)
    long = gibbs_cuda.gibbs_read_counts_plain(_jobs_on(inputs, keys, [6] * 6), 5, 1.0)
    offsets = np.cumsum([0] + [3 * item[0].shape[1] for item in inputs])
    long_offsets = np.cumsum([0] + [6 * item[0].shape[1] for item in inputs])
    for i in range(6):
        head = long[long_offsets[i] : long_offsets[i] + offsets[i + 1] - offsets[i]]
        assert torch.equal(short[offsets[i] : offsets[i + 1]], head)


def test_plain_readcount_job_independent_of_its_neighbours():
    inputs = _gibbs_jobs(13, 5)
    keys = list(prng.split(prng.prng_key(6), 5))
    together = gibbs_cuda.gibbs_read_counts_plain(_jobs_on(inputs, keys, [2, 4, 1, 3, 2]), 6, 1.0)
    alone = gibbs_cuda.gibbs_read_counts_plain(_jobs_on(inputs[1:2], keys[1:2], [4]), 6, 1.0)
    start = 2 * inputs[0][0].shape[1]
    assert torch.equal(together[start : start + alone.numel()], alone)


def _edge_jobs():
    return gibbs_edge_jobs(np.random.default_rng(17))


def test_plain_readcount_edge_jobs():
    inputs = _edge_jobs()
    keys = list(prng.split(prng.prng_key(21), len(inputs)))
    S = 200
    out = gibbs_cuda.gibbs_read_counts_plain(_jobs_on(inputs, keys, [S] * len(inputs)), 2, 1.0)
    out = out.numpy()
    at = 0
    fracs = []
    for item in inputs:
        C = item[0].shape[1]
        f = out[at : at + S * C].reshape(S, C)
        at += S * C
        assert np.isfinite(f).all() and (f > 0).all()
        np.testing.assert_allclose(f.sum(axis=1), 1.0, rtol=1e-12)
        fracs.append(f)
    assert (fracs[0] == 1.0).all()
    # Rows split by binomials (a count of 10^4 in one row; counts of
    # 300-900): the Dirichlet(counts + 1) means of the native sampler.
    for j in (3, 4):
        ref = readcount_gibbs.run_batched_gibbs(inputs[j : j + 1], keys[j : j + 1], S, 2, 1.0, CPU)[0]
        native = np.column_stack([ref[1], ref[0]]) / inputs[j][4]
        se = np.sqrt(fracs[j].var(axis=0) / S + native.var(axis=0) / S)
        assert (np.abs(fracs[j].mean(axis=0) - native.mean(axis=0)) < 6 * se + 1e-9).all()


def test_plain_readcount_rows_of_many_reads_match_native():
    """Rows of 5, 256, 257 and 4,096 reads (categorical trials, a binary
    search of the row's CDF each) and of 10^5 (binomial splits, past
    MAX_TRIALS) in one job of 12 columns: the plain version's sample means
    within 6 standard errors of the native sampler's at 200 samples."""
    rng = np.random.default_rng(29)
    probs = rng.dirichlet(np.full(12, 0.5), size=5)
    counts = np.array([5.0, 256.0, 257.0, 4096.0, 1e5])
    assert counts[3] <= gibbs_cuda.MAX_TRIALS < counts[4]
    total = float(counts.sum())
    item = (probs, counts, np.full(11, total / 12), total / 12, total)
    keys = [prng.prng_key(30)]
    S = 200
    fracs = gibbs_cuda.gibbs_read_counts_plain(_jobs_on([item], keys, [S]), 2, 1.0).numpy()
    fracs = fracs.reshape(S, 12)
    assert np.isfinite(fracs).all() and (fracs > 0).all()
    np.testing.assert_allclose(fracs.sum(axis=1), 1.0, rtol=1e-12)
    ref = readcount_gibbs.run_batched_gibbs([item], keys, S, 2, 1.0, CPU)[0]
    native = np.column_stack([ref[1], ref[0]]) / total
    se = np.sqrt(fracs.var(axis=0) / S + native.var(axis=0) / S)
    assert (np.abs(fracs.mean(axis=0) - native.mean(axis=0)) < 6 * se + 1e-9).all()


def test_binomial_plain_moments():
    """Inversion (n p < 10) and BTRS (n p >= 10), flipped above p = 0.5:
    mean and variance of 4,000 draws each."""
    cases = [(8, 0.3), (30, 0.1), (200, 0.4), (10000, 0.35), (50, 0.9)]
    m = 4000
    for i, (n, p) in enumerate(cases):
        keys = (torch.full((m,), 5 + i, dtype=torch.int64), torch.full((m,), 9, dtype=torch.int64))
        x = gibbs_cuda.binomial_plain(
            torch.full((m,), n, dtype=torch.int64), torch.full((m,), p, dtype=torch.float64),
            keys, 0, torch.arange(m), 2,
        ).double()
        mean, var = n * p, n * p * (1 - p)
        assert ((x >= 0) & (x <= n)).all()
        assert abs(x.mean().item() - mean) < 6 * np.sqrt(var / m), (n, p)
        assert abs(x.var().item() / var - 1.0) < 0.15, (n, p)


def test_gamma_plain_moments():
    m = 4000
    for i, (count, gamma) in enumerate([(0.0, 1.0), (3.0, 1.0), (40.0, 1.0), (0.0, 0.5)]):
        keys = (torch.full((m,), 3 + i, dtype=torch.int64), torch.full((m,), 1, dtype=torch.int64))
        g = gibbs_cuda.gamma_plain(
            torch.full((m,), count, dtype=torch.float64), gamma, keys, 4, torch.arange(m)
        )
        shape = count + gamma
        assert (g > 0).all()
        assert abs(g.mean().item() - shape) < 6 * np.sqrt(shape / m), (count, gamma)


def test_plain_posterior_sampler_edge_clusters():
    """P = 1 (always the pair (0, 0)); a cluster whose pair scores are all
    -inf but one row; the chain layout (chains x its pairs)."""
    rng = np.random.default_rng(2)
    one = (rng.random((4, 1)), np.full(4, 0.01), np.ones(4), [1])
    probs = rng.random((6, 5))
    inputs = [one, (probs, np.full(6, 0.05), np.arange(1.0, 7.0), [1, 2, 1, 1, 3])]
    keys = list(prng.split(prng.prng_key(3), 2))
    jobs = posteriors.posterior_gibbs_jobs(inputs, keys, CPU)
    out = posterior_gibbs_cuda.posterior_gibbs_plain(jobs).numpy()
    chains, its = jobs.host["n_chains"], jobs.host["n_its"]
    assert out.size == int(2 * (chains * its).sum())
    assert (out[: 2 * chains[0] * its[0]] == 0).all()
    assert ((out >= 0) & (out < 5)).all()
    results = posteriors._dedup_pairs(out, jobs.host["out_offsets"], chains, its)
    assert results[0] == ([[0, 0]], pytest.approx(np.array([1.0])))
    assert sum(results[1][1]) == pytest.approx(1.0)
    assert all(a <= b for a, b in results[1][0])


def test_cpu_tensors_take_plain_versions_without_launch():
    inputs = _gibbs_jobs(14, 3)
    keys = list(prng.split(prng.prng_key(1), 3))
    jobs = _jobs_on(inputs, keys, [2, 2, 2])
    with counted() as counts:
        assert torch.equal(
            gibbs_cuda.gibbs_read_counts(jobs, 3, 1.0),
            gibbs_cuda.gibbs_read_counts_plain(jobs, 3, 1.0),
        )
    assert counts["gibbs.readcount.launches"] == 0
    pjobs = posteriors.posterior_gibbs_jobs([_edge_posterior()], [keys[0]], CPU)
    with counted() as counts:
        assert torch.equal(
            posterior_gibbs_cuda.posterior_gibbs(pjobs),
            posterior_gibbs_cuda.posterior_gibbs_plain(pjobs),
        )
    assert counts["gibbs.pair.launches"] == 0


def _edge_posterior():
    rng = np.random.default_rng(8)
    return (rng.random((5, 4)), np.full(5, 0.02), np.ones(5), [1, 1, 1, 1])


def test_launch_plans_cover_every_job_once():
    """Every job in one launch; staged on the fewest CTAs of a cluster
    (up to 8) whose row slices' CDFs and P fit shared memory, else
    unstaged on one; its team covers one CTA's rows, columns and half its
    trials (or is the largest).  The pair sampler's launches hold every
    cluster: a one-path one in the small launch, a 100-path one in the
    large, a 200-path one unstaged."""
    rows = np.array([1, 3, 40, 300, 2000, 5, 200, 12000])
    cols = np.array([1, 9, 61, 12, 30, 300, 100, 12])
    trials = np.array([1, 40, 4000, 900, 2000, 5, 200, 100])
    plan = gibbs_cuda.plan_launches(rows, cols, trials)
    assert sorted(np.concatenate([lc.tasks for lc in plan]).tolist()) == list(range(rows.size))
    for lc in plan:
        share = -(-rows[lc.tasks] // lc.ctas)
        width = np.maximum(np.maximum(share, cols[lc.tasks]), -(-trials[lc.tasks] // (2 * lc.ctas)))
        assert (width <= lc.threads).all() or lc.threads == gibbs_cuda._TEAMS[-1]
        assert lc.smem_bytes <= gibbs_cuda.SMEM_LIMIT
        assert (gibbs_cuda.shared_bytes(share, cols[lc.tasks], lc.staged) <= lc.smem_bytes).all()
        assert lc.staged or lc.ctas == 1
    route = {int(t): (lc.ctas, lc.staged) for lc in plan for t in lc.tasks}
    assert route[4] == (8, True) and route[6] == (2, True) and route[7] == (1, False)
    assert {route[i] for i in (0, 1, 2, 3, 5)} == {(1, True)}
    team = {int(t): lc.threads for lc in plan for t in lc.tasks}
    assert team[2] == 512 and team[0] == 32 and team[3] == 512
    pplan, _, _ = posterior_gibbs_cuda.plan_launches([1, 100, 200], [10, 12, 14])
    assert [lc.tasks.tolist() for lc in pplan] == [[0], [1], [2]]
    assert [(lc.staged, lc.smem_bytes) for lc in pplan] == [
        (True, 16), (True, int(posterior_gibbs_cuda.table_bytes(100))), (False, 0)]


def test_profile_tool_probes_each_barrier_of_an_iteration():
    """tools/torch_gibbs_profile.py builds each sampler with its clock64
    marks on: the read-count iteration's two block barriers and the
    k-slot step's three each have a mark before and after them, every
    mark once; a kernel without marks (an earlier version) gets one
    after each block barrier of its loop."""
    import importlib.util
    import os
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_gibbs_profile", os.path.join(repo, "tools", "torch_gibbs_profile.py")
    )
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name, barriers, marks in (("gibbs_readcount", 2, 6), ("gibbs_posterior_k", 3, 6)):
        with open(os.path.join(repo, "rpvg_tpu_torch", "csrc", f"{name}.cu")) as handle:
            src = handle.read()
        profiled, flags, count = tool.profiled_source(src, name)
        assert flags == ("-DRPVG_GIBBS_PROFILE",) and count == marks
        loop = src.split(tool.LOOP_HEADS[name], 1)[1]
        found = re.findall(r"PROF_MARK\((\d)\);\s*(?:__syncthreads\(\);|if \(ctas > 1\) \{"
                           r"[^}]*\}[^}]*\}\s*)\s*PROF_MARK\((\d)\);", loop)
        assert len(found) == barriers, name
        assert sorted(re.findall(r"PROF_MARK\((\d)\)", loop)) == [str(i) for i in range(marks)]
        assert "g_prof" in profiled and "rpvg_prof_read" in profiled
    old = "for (int64_t it = 0; it < iterations; ++it) {\n  a();\n  __syncthreads();\n  b();\n" \
          "  __syncthreads();\n}\n"
    profiled, flags, count = tool.profiled_source("#include <cstdint>\n" + old, "gibbs_readcount")
    assert flags == () and count == 2
    assert [profiled.count(f"PROF_MARK({i});") for i in range(3)] == [1, 1, 0]
