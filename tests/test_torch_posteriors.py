"""The port's diploid pair scoring and posteriors against the JAX
package's, on the same numpy inputs made from a seed; the pair Gibbs
sampler's CDFs, draws and block plan (``csrc/gibbs_posterior.cu``) in
plain PyTorch."""

import numpy as np
import pytest
import torch

from rpvg_tpu.infer import posteriors as ref_post
from rpvg_tpu.infer.matrices import calc_path_log_frequencies
from rpvg_tpu_torch.infer import posteriors
from rpvg_tpu_torch.ops import posterior_gibbs_cuda
from rpvg_tpu_torch.testing import counted

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _clusters(seed, shapes):
    """Per cluster (probs (R, P), noise (R,), counts (R,), path_counts)."""
    rng = np.random.default_rng(seed)
    out = []
    for R, P in shapes:
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.6)
        noise = rng.uniform(1e-4, 0.2, size=R)
        counts = rng.integers(1, 12, size=R).astype(np.float64)
        path_counts = rng.integers(1, 4, size=P).tolist()
        out.append((probs, noise, counts, path_counts))
    return out


def _padded(clusters, R_pad, P_pad):
    B = len(clusters)
    probs = np.zeros((B, R_pad, P_pad))
    noise = np.ones((B, R_pad))
    counts = np.zeros((B, R_pad))
    log_freqs = np.full((B, P_pad), -np.inf)
    for b, (p, n, c, pc) in enumerate(clusters):
        R, P = p.shape
        probs[b, :R, :P] = p
        noise[b, :R] = n
        counts[b, :R] = c
        log_freqs[b, :P] = calc_path_log_frequencies(pc)
    return probs, noise, counts, log_freqs


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_scores_match_xla(seed):
    clusters = _clusters(seed, [(3, 2), (7, 5), (20, 8), (32, 3)])
    probs, noise, counts, log_freqs = _padded(clusters, 32, 8)
    # Rows whose every pair argument is 0 (noise 0, no path mass) give -inf.
    probs[1, 2, :] = 0.0
    noise[1, 2] = 0.0
    ref = np.asarray(ref_post._diploid_pair_scores_batched(probs, noise, counts, log_freqs))
    port = posteriors._diploid_pair_scores_batched(
        *(torch.from_numpy(a) for a in (probs, noise, counts, log_freqs))
    ).numpy()
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    finite = np.isfinite(ref)
    assert finite.any() and np.isneginf(ref).any()
    np.testing.assert_allclose(port[finite], ref[finite], rtol=1e-10)


def _assert_same_posteriors(port, ref):
    assert len(port) == len(ref)
    for (p_groups, p_post), (r_groups, r_post) in zip(port, ref):
        assert [list(g) for g in p_groups] == [list(g) for g in r_groups]
        np.testing.assert_allclose(np.asarray(p_post), np.asarray(r_post), rtol=1e-9)


SHAPES = [(1, 1), (2, 3), (5, 4), (9, 6), (17, 7), (40, 12), (70, 9), (3, 2), (12, 16)]


@pytest.mark.parametrize("native_em", ["1", "0"])
def test_diploid_posteriors_match_reference(native_em, monkeypatch):
    """Reference and port on their native routes ("1": the C++ library
    scores, selects and normalises) and on their plain ones ("0": XLA
    and torch scores, Python selection)."""
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", native_em)
    clusters = _clusters(3, SHAPES)
    ref = ref_post.diploid_posteriors_batched(clusters, 1e-3)
    port = posteriors.diploid_posteriors_batched(clusters, 1e-3, CPU)
    _assert_same_posteriors(port, ref)


def test_giant_cluster_blocked_path(monkeypatch):
    """A lowered element guard sends clusters through the column-blocked
    per-cluster scorer in both packages (reference: XLA route, mesh off)."""
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    monkeypatch.setenv("RPVG_TPU_AUTOSHARD", "0")
    monkeypatch.setenv("RPVG_TPU_PAIR_TENSOR_LIMIT", "2048")
    clusters = _clusters(4, [(40, 12), (70, 20), (5, 3)])
    calls = []
    blocked = posteriors._diploid_pair_scores_block

    def spy(*args):
        calls.append(args[4].shape)
        return blocked(*args)

    monkeypatch.setattr(posteriors, "_diploid_pair_scores_block", spy)
    ref = ref_post.diploid_posteriors_batched(clusters, 1e-3)
    port = posteriors.diploid_posteriors_batched(clusters, 1e-3, CPU)
    assert calls, "no cluster took the column-blocked path"
    _assert_same_posteriors(port, ref)


def test_native_select_matches_python_select():
    rng = np.random.default_rng(6)
    mats = [rng.normal(size=(P, P)) * 5 for P in (1, 3, 8)]
    native = posteriors._native_diploid_select(mats, 1e-3)
    for mat, (groups, post) in zip(mats, native):
        py_groups, py_post = posteriors._diploid_select(mat, 1e-3)
        assert groups == py_groups
        np.testing.assert_allclose(post, py_post, rtol=1e-12)


def test_scored_clusters_counted_by_device():
    clusters = _clusters(8, [(4, 3), (6, 2)])
    with counted() as counts:
        posteriors.diploid_posteriors_batched(clusters, 1e-3, CPU)
    assert counts["posteriors.scored.cpu"] == 2
    assert counts["posteriors.scored.cuda"] == 0


# ------------------------------------------- the pair sampler's draws


def _cdf_rows(kind, P, n, rng):
    """(n, P) CDF rows as the kernel builds them from pair scores of one
    kind: random, uniform (no finite maximum), tied, with zero-mass
    columns, or one dominant column."""
    scores = rng.normal(0.0, 3.0, (n, P))
    if kind == "uniform":
        scores[:] = -np.inf
    elif kind == "ties":
        scores = np.round(scores)
    elif kind == "zero_mass":
        scores[rng.random((n, P)) < 0.6] = -np.inf
        scores[np.arange(n), rng.integers(0, P, n)] = 0.0
    elif kind == "peaked":
        scores[np.arange(n), rng.integers(0, P, n)] = 80.0
    s = torch.from_numpy(scores)
    m = s.max(dim=1).values
    finite = torch.isfinite(m)
    terms = torch.where(finite[:, None], torch.exp(s - m[:, None]), 1.0)
    return posterior_gibbs_cuda.warp_scan_cdfs(terms)


@pytest.mark.parametrize("P", [1, 2, 31, 33, 120, 200])
@pytest.mark.parametrize("kind", ["random", "uniform", "ties", "zero_mass", "peaked"])
def test_kernel_draws_are_lower_bounds(kind, P):
    """The kernel's draw (a branch-free halving search) gives
    torch.searchsorted's lower bound, clamped to P - 1, on seeded CDFs as
    the kernel builds them; uniforms on the CDF's own entries and past
    the last entry too."""
    rng = np.random.default_rng(P + 7 * len(kind))
    cdf = _cdf_rows(kind, P, 64, rng)
    assert (cdf[:, 1:] >= cdf[:, :-1]).all()
    edges = [np.full(64, j / P) for j in range(P)][:8] + [np.full(64, 1 - 2.0**-53)]
    for u in [rng.random(64) for _ in range(16)] + edges + [cdf[:, 0].numpy(), cdf[:, -1].numpy()]:
        u = torch.from_numpy(np.clip(u, 2.0**-53, 1 - 2.0**-53))
        got = posterior_gibbs_cuda.halving_search(cdf, u)
        expected = torch.searchsorted(cdf, u[:, None]).squeeze(1).clamp(max=P - 1)
        assert torch.equal(got, expected)


def test_warp_scan_cdfs_match_running_sums():
    """The kernel's warp-scan CDFs are nondecreasing, end at 1 and lie
    within 1e-14 of the sequential running sums; P = 1 is [1]."""
    rng = np.random.default_rng(3)
    for P in (1, 5, 32, 33, 64, 150):
        terms = torch.from_numpy(rng.exponential(size=(20, P)))
        cdf = posterior_gibbs_cuda.warp_scan_cdfs(terms)
        running = torch.cumsum(terms, dim=1) / terms.sum(dim=1, keepdim=True)
        assert (cdf[:, 1:] >= cdf[:, :-1]).all()
        np.testing.assert_allclose(cdf.numpy(), running.numpy(), rtol=0, atol=1e-14)
        np.testing.assert_allclose(cdf[:, -1].numpy(), 1.0, rtol=0, atol=1e-15)


def test_pair_sampler_blocks_hold_every_cluster_once():
    """The pair sampler's plan: every cluster in one block of one launch;
    a block's clusters within its shared memory (tables apart), 256 chains
    and 256 rows; staged clusters' tables within the launch's shared
    memory, unstaged ones apart in the scratch; small clusters share
    blocks, a cluster past 48 KB has one of its own."""
    rng = np.random.default_rng(4)
    cols = np.concatenate([rng.integers(1, 40, 300), [64, 70, 120, 150, 152, 153, 200, 400]])
    chains = 10 + np.round(0.02 * cols).astype(np.int64)
    launches, starts, offsets = posterior_gibbs_cuda.plan_launches(cols, chains)
    need = posterior_gibbs_cuda.table_bytes(cols)
    seen = np.zeros(cols.size, dtype=np.int64)
    shared = 0
    for lc, bounds in zip(launches, starts):
        assert lc.threads == posterior_gibbs_cuda.THREADS
        assert lc.smem_bytes <= posterior_gibbs_cuda.SMEM_LIMIT
        assert bounds[0] == 0 and bounds[-1] == lc.tasks.size and (np.diff(bounds) > 0).all()
        spans = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            block = lc.tasks[lo:hi]
            seen[block] += 1
            if lc.staged and lc.smem_bytes > posterior_gibbs_cuda.SMALL_SMEM:
                assert block.size == 1
            shared += block.size > 1
            assert chains[block].sum() <= posterior_gibbs_cuda.BLOCK_CHAINS or block.size == 1
            assert cols[block].sum() <= posterior_gibbs_cuda.BLOCK_ROWS or block.size == 1
            if lc.staged:
                spans = sorted((int(offsets[c]), int(offsets[c] + need[c])) for c in block)
                assert spans[-1][1] <= lc.smem_bytes
                assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        if not lc.staged:
            spans = sorted((int(offsets[c]), int(offsets[c] + need[c])) for c in lc.tasks)
            assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert (need[lc.tasks] > posterior_gibbs_cuda.SMEM_LIMIT).all()
    assert (seen == 1).all()
    assert shared > 0
