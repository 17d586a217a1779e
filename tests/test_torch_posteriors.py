"""The port's diploid pair scoring and posteriors against the JAX
package's, on the same numpy inputs made from a seed."""

import numpy as np
import pytest
import torch

from rpvg_tpu.infer import posteriors as ref_post
from rpvg_tpu.infer.matrices import calc_path_log_frequencies
from rpvg_tpu_torch.infer import posteriors

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
    """Reference on its default native route ("1") and on its XLA route
    ("0"); the port scores with torch either way (selection goes native
    or Python with the reference)."""
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
    before = dict(posteriors.SCORED_CLUSTERS)
    clusters = _clusters(8, [(4, 3), (6, 2)])
    posteriors.diploid_posteriors_batched(clusters, 1e-3, CPU)
    assert posteriors.SCORED_CLUSTERS["cpu"] == before["cpu"] + 2
    assert posteriors.SCORED_CLUSTERS["cuda"] == before["cuda"]
