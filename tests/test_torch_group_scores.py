"""The group scorer's factoring (``csrc/group_scores.cu``) in plain
PyTorch, on the CPU: ``group_scores_factored_plain`` against the port's
transcription ``group_scores_plain`` and the JAX package's
``_group_scores_chunk`` on the same numpy inputs, the scoring grid's
block plan, and the profile tool's count of the logs the kernel takes.

Tolerance: rtol 1e-10 with identical -inf (the factoring sums the same
terms in another order, and the last slot's log once per row)."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import rpvg_tpu  # noqa: F401  (x64 on)
from rpvg_tpu.infer import posteriors as ref_posteriors
from rpvg_tpu_torch.ops import group_scores_cuda
from rpvg_tpu_torch.testing import enumeration_cluster_set

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _profile_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_group_scores_profile.py")
    spec = importlib.util.spec_from_file_location("torch_group_scores_profile", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _cluster(case, k, seed):
    """(probs, noise, counts) of one of the edge cases."""
    rng = np.random.default_rng(seed)
    R, P = {"noise_zero": (40, 7), "zero_columns": (30, 9), "one_path": (12, 1),
            "zero_counts": (50, 6), "many_rows": (3000, 8)}[case]
    probs = rng.random((R, P)) * (rng.random((R, P)) < 0.4)
    probs[np.arange(R), rng.integers(0, P, size=R)] += rng.random(R)
    noise = rng.uniform(1e-4, 0.05, R)
    counts = rng.geometric(0.4, size=R).astype(np.float64)
    if case == "noise_zero":
        # Zero noise: a row with mass on path 2 alone (-inf for every group
        # without it), one with none (-inf everywhere), one in the middle
        # of a word.
        noise[[0, 5, 33]] = 0.0
        probs[0], probs[0, 2] = 0.0, 0.7
        probs[5] = 0.0
    if case == "zero_columns":
        probs[:, [1, 4, 8]] = 0.0
    if case == "zero_counts":
        counts[::3] = 0.0
        noise[3] = 0.0
        probs[3], probs[3, 1] = 0.0, 0.5
    return probs, noise, counts


CASES = ["noise_zero", "zero_columns", "one_path", "zero_counts", "many_rows"]


@pytest.mark.parametrize("k", [1, 3, 4, 5])
@pytest.mark.parametrize("case", CASES)
def test_factored_scores_match_plain_and_jax(case, k):
    """The factored sum equals the plain sum and the JAX function's
    within rtol 1e-10, with -inf and NaN (a zero count times -inf) in the
    same places."""
    probs, noise, counts = _cluster(case, k, seed=200 + 10 * k + CASES.index(case))
    P = probs.shape[1]
    idx = group_scores_cuda.group_table(P, k)
    t = [torch.from_numpy(a) for a in (probs, noise, counts)]
    factored = group_scores_cuda.group_scores_factored_plain(*t, k).numpy()
    plain = group_scores_cuda.group_scores_plain(t[0][None], t[1][None], t[2][None],
                                                 torch.from_numpy(idx))[0].numpy()
    ref = np.asarray(ref_posteriors._group_scores_chunk(probs[None], noise[None], counts[None],
                                                        idx))[0]
    assert factored.shape == (math.comb(P + k - 1, k),)
    for other in (plain, ref):
        assert np.array_equal(np.isneginf(factored), np.isneginf(other))
        assert np.array_equal(np.isnan(factored), np.isnan(other))
        finite = np.isfinite(other)
        np.testing.assert_allclose(factored[finite], other[finite], rtol=1e-10, atol=0)
    if case == "noise_zero":
        assert np.isneginf(factored).all()
    if case == "zero_counts":
        assert np.isnan(factored).any() and np.isfinite(factored).any()


@pytest.mark.parametrize("k", [1, 3, 4, 5])
def test_factored_scores_match_plain_on_seeded_clusters(k):
    """The seeded enumeration clusters (one of 512 rows, one with -inf
    groups) through the factoring and through the ragged plain route."""
    clusters = enumeration_cluster_set(12, seed=220 + k, group_size=k)
    packed = group_scores_cuda.make_clusters([c[:3] for c in clusters], k, CPU)
    plain = group_scores_cuda.group_scores_ragged_plain(packed).numpy()
    factored = np.concatenate([
        group_scores_cuda.group_scores_factored_plain(*(torch.from_numpy(a) for a in c[:3]), k)
        .numpy() for c in clusters
    ])
    assert np.array_equal(np.isneginf(factored), np.isneginf(plain)) and np.isneginf(plain).any()
    finite = np.isfinite(plain)
    np.testing.assert_allclose(factored[finite], plain[finite], rtol=1e-10, atol=0)


def test_block_plan_covers_every_group_once():
    """Every group of every cluster in exactly one block of the scoring
    grid, 256 / S groups a block, S warps per tile from 8 row words on,
    4 words a warp or more; the clusters whose warps walk the most words
    first, a cluster's blocks together; the pre-pass words cover every row
    once."""
    rows = np.array([3, 600, 1, 45, 45, 0, 31, 33, 4000, 130])
    cols = np.array([5, 12, 1, 28, 3, 4, 64, 2, 6, 9])
    n_groups = np.array([math.comb(int(P) + 2, 3) for P in cols])
    cluster, first, split = group_scores_cuda.plan_blocks(rows, n_groups)
    assert split.tolist() == [1, 4, 1, 1, 1, 1, 1, 1, 8, 1]
    size = 256 // split
    covered = np.zeros(int(n_groups.sum()), dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(n_groups)[:-1]])
    for c, f in zip(cluster, first):
        assert f % size[c] == 0
        covered[starts[c] + f : starts[c] + min(f + size[c], n_groups[c])] += 1
    assert (covered == 1).all()
    order = list(dict.fromkeys(cluster.tolist()))
    per_warp = -(-(-(-rows // 32)) // split)
    assert [per_warp[c] for c in order] == sorted(per_warp[order], reverse=True)
    assert order[:2] == [8, 1] and len(order) == len(np.flatnonzero(np.diff(cluster) != 0)) + 1
    inputs = [(np.ones((int(R), int(P))), np.ones(int(R)), np.ones(int(R)))
              for R, P in zip(rows, cols)]
    packed = group_scores_cuda.make_clusters(inputs, 3, CPU)
    h = packed.host
    assert list(np.bincount(h["word_cluster"], minlength=rows.size)) == list(-(-rows // 32))
    assert h["part_offsets"][-1] == int((-(-rows // 32) * cols).sum())
    assert h["mask_offsets"][-1] == int((-(-rows // 32) * (cols + 1)).sum())


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_profile_tool_counts_the_rows_the_factoring_logs(k):
    """tools/torch_group_scores_profile.py's rows U per group (the logs
    the bound counts) are the rows ``group_scores_factored_plain`` gives
    a log of their own."""
    tool = _profile_tool()
    probs, noise, counts = _cluster("zero_counts", k, seed=240 + k)
    words = tool.factored_rows(probs, noise, counts, k)
    R = probs.shape[0]
    in_u = ((words[:, np.arange(R) // 32] >> (np.arange(R) % 32).astype(np.uint32)) & 1).T
    bad = ~(noise > 0)
    live = (probs != 0) & ((counts != 0) | bad)[:, None]
    idx = group_scores_cuda.group_table(probs.shape[1], k)
    expected = np.broadcast_to(bad[:, None], (R, idx.shape[0])).copy()
    for j in range(k - 1):
        expected |= live[:, idx[:, j]]
    assert np.array_equal(in_u.astype(bool), expected)
    dense, factored, busy = tool.factored_logs([(probs, noise, counts)], k)
    assert dense == R * idx.shape[0]
    assert factored == R * probs.shape[1] + int(expected.sum())
    assert 0.0 < busy <= 1.0


def test_kernel_log_is_within_a_few_ulp_of_numpy():
    """``csrc/log_f64.cuh``'s log (its numpy mirror ``table_log``, same
    table and steps) within 4 ulp of numpy's log from the least denormal
    to the largest float64, 0 exactly at 1, and relatively accurate next
    to 1, where a score of groups near probability 1 is strict."""
    rng = np.random.default_rng(7)
    near_one = 1.0 + np.arange(-3000, 3000) * 2.0**-52
    x = np.concatenate([
        rng.uniform(0.0, 1.0, 50000), np.exp(rng.uniform(-744.0, 709.0, 50000)),
        1.0 + rng.uniform(-1e-6, 1e-6, 20000), near_one,
        [5e-324, 1e-310, 2.2250738585072014e-308, 0.5, 2.0, np.sqrt(2.0), np.sqrt(0.5),
         1.7976931348623157e308],
    ])
    x = x[x > 0]
    ours, ref = group_scores_cuda.table_log(x), np.log(x)
    assert (np.abs(ours - ref) <= 4 * np.spacing(np.abs(ref))).all()
    assert group_scores_cuda.table_log(np.array([1.0]))[0] == 0.0
    table = group_scores_cuda.log_table()
    assert table.shape == (91, 2) and tuple(table[37]) == (1.0, 0.0)
