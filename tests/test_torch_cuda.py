"""The CUDA kernels (both EM kernels, the Gibbs samplers, the group scorer) against their
plain PyTorch versions, and the models' device halves on the card.  Every test here needs a CUDA device: they are
marked ``gpu`` and skip on a host without one.  The module imports no
jax (the card's host has none), so on the card it runs without the
suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from rpvg_tpu_torch import prng, spans
from rpvg_tpu_torch.infer import batching, posteriors, readcount_gibbs
from rpvg_tpu_torch.infer.batching import fold_fractions, pack_ragged, run_batched_em
from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda, gibbs_cuda, posterior_gibbs_cuda
from rpvg_tpu_torch.testing import (
    counted,
    edge_case_tasks,
    em_task_set,
    gibbs_edge_jobs,
    gibbs_job,
    gibbs_job_set,
    gibbs_jobs_on,
    padded_block_set,
    posterior_cluster_set,
    posterior_wide_cluster,
    random_task,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the EM kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _folded(fracs, tasks, task_list):
    return np.concatenate([np.append(*r) for r in fold_fractions(fracs, tasks, task_list)])


@pytest.mark.parametrize("max_its", [10000, 50])
def test_kernel_matches_plain(cuda, max_its):
    task_list = em_task_set(512, seed=31)
    tasks = pack_ragged(task_list, cuda)
    planned = len(em_cuda.plan_launches(tasks.shapes[:, 0], tasks.shapes[:, 1]))
    with counted() as counts:
        k_fracs, k_iters = em_cuda.em_fixed_point(tasks, max_its, 1e-3)
    with counted() as plain_counts:
        p_fracs, p_iters = em_cuda.em_fixed_point_plain(tasks, max_its, 1e-3)
    torch.cuda.synchronize()
    assert (counts["em.ragged.launches"], counts["em.ragged.tasks"]) == (planned, len(task_list))
    assert not plain_counts
    kernel = _folded(k_fracs, tasks, task_list)
    plain = _folded(p_fracs, tasks, task_list)
    np.testing.assert_allclose(kernel, plain, rtol=1e-6, atol=1e-9)
    assert int(k_iters.max()) <= max_its


def test_kernel_is_deterministic(cuda):
    tasks = pack_ragged(em_task_set(256, seed=32), cuda)
    first, _ = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    second, _ = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    assert torch.equal(first, second)


def test_run_batched_em_on_cuda_matches_cpu(cuda):
    task_list = em_task_set(128, seed=33)
    with counted() as counts:
        port = run_batched_em(task_list, 10000, 1e-3, cuda)
    assert counts["em.ragged.tasks"] == len(task_list)
    on_cpu = run_batched_em(task_list, 10000, 1e-3, torch.device("cpu"))
    for (p_counts, p_noise), (n_counts, n_noise) in zip(port, on_cpu):
        np.testing.assert_allclose(p_counts, n_counts, rtol=1e-6, atol=1e-9)
        assert p_noise == pytest.approx(n_noise, rel=1e-6, abs=1e-9)


def test_pair_scores_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(34)
    clusters = []
    for R, P in [(3, 2), (9, 5), (40, 12)]:
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.6)
        clusters.append(
            (probs, rng.uniform(1e-4, 0.2, R), rng.integers(1, 9, R).astype(float),
             rng.integers(1, 4, P).tolist())
        )
    with counted() as counts:
        on_cuda = posteriors.diploid_posteriors_batched(clusters, 1e-3, cuda)
    assert counts["posteriors.scored.cuda"] == len(clusters)
    on_cpu = posteriors.diploid_posteriors_batched(clusters, 1e-3, torch.device("cpu"))
    for (g_cuda, p_cuda), (g_cpu, p_cpu) in zip(on_cuda, on_cpu):
        assert g_cuda == g_cpu
        np.testing.assert_allclose(p_cuda, p_cpu, rtol=1e-9)


def test_kernel_wide_and_tall_tasks_match_plain(cuda):
    """Tasks past the kernel's fast paths: more columns than threads in a
    block (unsliced column sums) and more rows than fit q in shared
    memory (q in global scratch)."""
    rng = np.random.default_rng(35)
    task_list = [random_task(rng, R, C) for R, C in [(2500, 5), (40, 200), (3000, 150), (3, 9)]]
    tasks = pack_ragged(task_list, cuda)
    k_fracs, k_iters = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    p_fracs, p_iters = em_cuda.em_fixed_point_plain(tasks, 10000, 1e-3)
    np.testing.assert_allclose(
        _folded(k_fracs, tasks, task_list), _folded(p_fracs, tasks, task_list),
        rtol=1e-6, atol=1e-9,
    )
    assert torch.equal(k_iters.cpu(), p_iters.cpu())


def _largest_staged_rows(C):
    R = 1
    while 8 * int(em_cuda.staged_doubles([R + 1], [C])[0]) <= em_cuda.SMEM_LIMIT:
        R += 1
    return R


@pytest.mark.parametrize(
    "case",
    ["edge_cases", "largest_main_path_task_10000_iterations", "just_over_shared_memory"],
)
def test_kernel_matches_plain_at_edge_shapes(cuda, case):
    """R = 1, C = 1, an all-zero row and a zero-count row; the largest
    main-path task (348 x 61) held to all 10,000 iterations (a negative
    tolerance never converges); a task one row past what shared memory
    holds at 61 columns (P read from global memory)."""
    rng = np.random.default_rng(40)
    max_its, tol = 10000, 1e-3
    if case == "edge_cases":
        task_list = edge_case_tasks(rng) + [random_task(rng, 1, 1)]
    elif case == "largest_main_path_task_10000_iterations":
        task_list, tol = [random_task(rng, 348, 61)], -1.0
    else:
        task_list = [random_task(rng, _largest_staged_rows(61) + 1, 61), random_task(rng, 3, 9)]
    tasks = pack_ragged(task_list, cuda)
    plan = em_cuda.plan_launches(tasks.shapes[:, 0], tasks.shapes[:, 1])
    if case == "just_over_shared_memory":
        assert [(lc.threads, lc.staged) for lc in plan] == [(1024, False), (32, True)]
    k_fracs, k_iters = em_cuda.em_fixed_point(tasks, max_its, tol)
    p_fracs, p_iters = em_cuda.em_fixed_point_plain(tasks, max_its, tol)
    np.testing.assert_allclose(
        _folded(k_fracs, tasks, task_list), _folded(p_fracs, tasks, task_list),
        rtol=1e-6, atol=1e-9,
    )
    assert torch.equal(k_iters.cpu(), p_iters.cpu())
    if tol < 0:
        assert int(k_iters[0]) == max_its


# ------------------------------------------------ the multi-bucket kernel


def _fused_groups(task_list, device, monkeypatch):
    """The fused launch groups ``dispatch_em_device`` plans for the
    tasks, as (chunks, blocks on ``device``) per launch."""
    monkeypatch.setenv("RPVG_TPU_FUSE_EM", "1")
    groups = batching.plan_em_groups(task_list, range(len(task_list)))
    return [
        (
            [chunk for chunk, _, _ in group],
            [batching.build_block(task_list, *plan, device) for plan in group],
        )
        for group in groups
    ]


def _folded_groups(groups, fracs_per_group, task_list):
    results = [None] * len(task_list)
    for (chunks, _), fracs in zip(groups, fracs_per_group):
        batching.gather_em_device(list(zip(chunks, fracs)), task_list, results)
    return np.concatenate([np.append(*r) for r in results])


@pytest.mark.parametrize("max_its", [10000, 50])
def test_fused_kernel_matches_plain(cuda, max_its, monkeypatch):
    task_list = em_task_set(512, seed=36)
    groups = _fused_groups(task_list, cuda, monkeypatch)
    assert any(len(blocks) >= 2 for _, blocks in groups)
    kernel, plain = [], []
    for _, blocks in groups:
        k_fracs, k_iters = em_fused_cuda.em_fixed_point_padded(blocks, max_its, 1e-3)
        p_fracs, p_iters = em_fused_cuda.em_fixed_point_padded_plain(blocks, max_its, 1e-3)
        kernel.append(k_fracs)
        plain.append(p_fracs)
        assert torch.equal(torch.cat(k_iters).cpu(), torch.cat(p_iters).cpu())
    np.testing.assert_allclose(
        _folded_groups(groups, kernel, task_list), _folded_groups(groups, plain, task_list),
        rtol=1e-6, atol=1e-9,
    )


@pytest.mark.parametrize("max_its", [10000, 50])
def test_fused_kernel_bitwise_equal_to_ragged(cuda, max_its, monkeypatch):
    """Both kernels run a task's extent through the same loop as the same
    team, so padding changes no bit."""
    task_list = em_task_set(512, seed=41)
    groups = _fused_groups(task_list, cuda, monkeypatch)
    fused = _folded_groups(
        groups,
        [em_fused_cuda.em_fixed_point_padded(blocks, max_its, 1e-3)[0] for _, blocks in groups],
        task_list,
    )
    tasks = pack_ragged(task_list, cuda)
    r_fracs, _ = em_cuda.em_fixed_point(tasks, max_its, 1e-3)
    np.testing.assert_array_equal(fused, _folded(r_fracs, tasks, task_list))


def test_fused_kernel_is_deterministic(cuda, monkeypatch):
    groups = _fused_groups(em_task_set(256, seed=37), cuda, monkeypatch)
    for _, blocks in groups:
        first, _ = em_fused_cuda.em_fixed_point_padded(blocks, 10000, 1e-3)
        second, _ = em_fused_cuda.em_fixed_point_padded(blocks, 10000, 1e-3)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_kernel_one_call_over_shaped_blocks_with_dummy(cuda):
    blocks = [tuple(torch.from_numpy(a).to(cuda) for a in b) for b in padded_block_set(38)]
    extents = em_fused_cuda.cluster_extents(blocks)
    planned = len(em_cuda.plan_launches(extents[:, 0], extents[:, 1]))
    with counted() as counts:
        k_fracs, k_iters = em_fused_cuda.em_fixed_point_padded(blocks, 10000, 1e-3)
    assert counts["em.padded.launches"] == planned
    assert counts["em.padded.blocks"] == len(blocks)
    assert counts["em.padded.tasks"] == sum(b[0].shape[0] for b in blocks)
    p_fracs, p_iters = em_fused_cuda.em_fixed_point_padded_plain(blocks, 10000, 1e-3)
    for k, p, ki, pi in zip(k_fracs, p_fracs, k_iters, p_iters):
        np.testing.assert_allclose(k.cpu().numpy(), p.cpu().numpy(), rtol=1e-6, atol=1e-9)
        assert torch.equal(ki.cpu(), pi.cpu())
    assert not k_fracs[0][-1].any() and int(k_iters[0][-1]) == 10


def test_fused_kernel_tall_and_wide_blocks_match_plain_and_ragged(cuda, monkeypatch):
    """A block of R_pad 8192 (q in global scratch) and one of C_pad 256
    (more columns than threads: unsliced column sums), in one launch;
    each task also against the ragged kernel."""
    rng = np.random.default_rng(39)
    task_list = [random_task(rng, R, C) for R, C in [(3000, 5), (2500, 7), (40, 200), (90, 150)]]
    groups = _fused_groups(task_list, cuda, monkeypatch)
    assert [[(b[0].shape[1], b[0].shape[2]) for b in blocks] for _, blocks in groups] == [
        [(8192, 8), (128, 256)]
    ]
    kernel, plain = [], []
    for _, blocks in groups:
        k_fracs, k_iters = em_fused_cuda.em_fixed_point_padded(blocks, 10000, 1e-3)
        p_fracs, p_iters = em_fused_cuda.em_fixed_point_padded_plain(blocks, 10000, 1e-3)
        assert torch.equal(torch.cat(k_iters).cpu(), torch.cat(p_iters).cpu())
        kernel.append(k_fracs)
        plain.append(p_fracs)
    fused = _folded_groups(groups, kernel, task_list)
    np.testing.assert_allclose(fused, _folded_groups(groups, plain, task_list), rtol=1e-6, atol=1e-9)
    tasks = pack_ragged(task_list, cuda)
    r_fracs, _ = em_cuda.em_fixed_point(tasks, 10000, 1e-3)
    np.testing.assert_allclose(fused, _folded(r_fracs, tasks, task_list), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("fuse", ["0", "1"])
def test_transcripts_slice_on_cuda_matches_cpu(cuda, fuse, tmp_path, monkeypatch):
    import os

    from rpvg_tpu_torch import cli, sim
    from rpvg_tpu_torch.compare import compare_estimate_files

    monkeypatch.setenv("RPVG_TPU_FUSE_EM", fuse)
    # The golden dataset of tests/test_golden.py, made through the port.
    panel = sim.build_panel(
        num_transcripts=4, num_haplotypes=2, exons_per_transcript=3,
        exon_length=80, variant_sites=1, seed=101,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 300, read_length=60, frag_mean=150, frag_sd=12, seed=103,
    )
    aln = str(tmp_path / "aln.json")
    sim.write_alignment_json(records, aln)
    graph, paths = str(tmp_path / "graph.json"), str(tmp_path / "panel.json")
    panel.write_graph_json(graph)
    panel.write_panel_json(paths)
    for backend in ("cuda", "cpu"):
        argv = ["-g", graph, "-p", paths, "-a", aln, "-o", str(tmp_path / backend),
                "-i", "transcripts", "-r", "99", "--score-not-qual", "--backend", backend]
        assert cli.main(argv) == 0
        if backend == "cuda":
            counters = spans.recent_runs(1)[0]["counters"]
    assert counters.get("em.padded.launches" if fuse == "1" else "em.ragged.launches", 0) > 0
    report = compare_estimate_files(
        os.path.join(tmp_path, "cuda.txt"), os.path.join(tmp_path, "cpu.txt"), 1e-6, 1e-6
    )
    assert report["rows"] > 0


# ------------------------------------------------ the Gibbs samplers


def _over_shared_memory_job(rows):
    """A job of ``rows`` x 12 whose CDFs and P do not fit one CTA's shared
    memory (at 3,000 rows they fit four CTAs of a cluster; at 12,000 not
    even eight, so they live in a global scratch), and a small one beside
    it."""
    rng = np.random.default_rng(44)
    big = gibbs_job(rng, *random_task(rng, rows, 12))
    return [big, gibbs_job(rng, *random_task(rng, 3, 9))]


@pytest.mark.parametrize("case", ["job_set", "edge_jobs", "over_shared_memory", "cluster"])
def test_gibbs_readcount_kernel_matches_plain(cuda, case):
    """Every kept fraction within rtol 1e-9 of the plain version on the
    same Philox counters."""
    if case == "job_set":
        inputs = gibbs_job_set(96, seed=42)
    elif case == "edge_jobs":
        inputs = gibbs_edge_jobs(np.random.default_rng(43))
    else:
        inputs = _over_shared_memory_job(12000 if case == "over_shared_memory" else 3000)
    samples = [3 + i % 4 for i in range(len(inputs))]
    jobs = gibbs_jobs_on(inputs, cuda, samples, seed=3)
    plan = gibbs_cuda.plan_launches(jobs.shapes[:, 0], jobs.shapes[:, 1],
                                    gibbs_cuda.job_trials(jobs))
    if case == "over_shared_memory":
        assert [(lc.ctas, lc.staged) for lc in plan] == [(1, False), (1, True)]
    if case == "cluster":
        assert [(lc.ctas, lc.staged) for lc in plan] == [(4, True), (1, True)]
    with counted() as counts:
        kernel = gibbs_cuda.gibbs_read_counts(jobs, 5, 1.0)
    torch.cuda.synchronize()
    assert (counts["gibbs.readcount.launches"], counts["gibbs.readcount.jobs"]) == (
        len(plan), len(inputs))
    with counted() as plain_counts:
        plain = gibbs_cuda.gibbs_read_counts_plain(jobs, 5, 1.0)
    assert not plain_counts
    np.testing.assert_allclose(kernel.cpu().numpy(), plain.cpu().numpy(), rtol=1e-9, atol=0)
    assert bool(torch.isfinite(kernel).all())


@pytest.mark.parametrize("reads", [5, 256, 257, 4096, 100000])
def test_gibbs_readcount_kernel_rows_of_many_reads(cuda, reads):
    """A row of ``reads`` reads beside rows of 1-3 (categorical trials up
    to MAX_TRIALS, binomial splits above), in a job of 12 columns: every
    kept fraction within rtol 1e-9 of the plain version, for every team
    size."""
    rng = np.random.default_rng(reads)
    probs = rng.dirichlet(np.full(12, 0.5), size=9)
    counts = np.append(rng.integers(1, 4, size=8).astype(np.float64), float(reads))
    inputs = [gibbs_job(rng, probs, counts)]
    jobs = gibbs_jobs_on(inputs, cuda, [4], seed=reads)
    plain = gibbs_cuda.gibbs_read_counts_plain(jobs, 5, 1.0).cpu().numpy()
    teams = gibbs_cuda._TEAMS
    try:
        for cap in (32, 512):
            gibbs_cuda._TEAMS = tuple(t for t in teams if t <= cap)
            kernel = gibbs_cuda.gibbs_read_counts(jobs, 5, 1.0).cpu().numpy()
            np.testing.assert_allclose(kernel, plain, rtol=1e-9, atol=0)
    finally:
        gibbs_cuda._TEAMS = teams


def test_gibbs_readcount_kernel_prefix_property(cuda):
    """S and 2S samples: the first S are bitwise the same."""
    inputs = gibbs_job_set(40, seed=45)
    short = gibbs_cuda.gibbs_read_counts(gibbs_jobs_on(inputs, cuda, [3] * len(inputs), seed=3), 5, 1.0)
    long = gibbs_cuda.gibbs_read_counts(gibbs_jobs_on(inputs, cuda, [6] * len(inputs), seed=3), 5, 1.0)
    cols = np.array([item[0].shape[1] for item in inputs])
    at_short, at_long = np.cumsum(np.append(0, 3 * cols)), np.cumsum(np.append(0, 6 * cols))
    for i in range(len(inputs)):
        width = at_short[i + 1] - at_short[i]
        assert torch.equal(short[at_short[i] : at_short[i + 1]], long[at_long[i] : at_long[i] + width])


def test_gibbs_readcount_job_independent_of_its_launch(cuda):
    inputs = gibbs_job_set(30, seed=46)
    together = gibbs_cuda.gibbs_read_counts(gibbs_jobs_on(inputs, cuda, [4] * len(inputs), seed=3), 5, 1.0)
    keys = prng.split(prng.prng_key(3), len(inputs))
    i = 7
    tasks = pack_ragged([(inputs[i][0], inputs[i][1])], cuda)
    alone = gibbs_cuda.gibbs_read_counts(
        gibbs_cuda.make_jobs(tasks, [0], [readcount_gibbs.initial_fractions(inputs[i])],
                             [prng.key_seed(keys[i])], [4]),
        5, 1.0,
    )
    start = 4 * sum(item[0].shape[1] for item in inputs[:i])
    assert torch.equal(together[start : start + alone.numel()], alone)


def test_gibbs_readcount_on_packed_tasks_matches_fresh_upload(cuda):
    """Phase D2 reads the task set phase D packed (a subset, in another
    order) and draws what a fresh upload of the same jobs draws."""
    inputs = gibbs_job_set(20, seed=47)
    keys = list(prng.split(prng.prng_key(9), len(inputs)))
    tasks = pack_ragged([(item[0], item[1]) for item in inputs], cuda)
    picked = [5, 2, 11]
    reused = readcount_gibbs.run_batched_gibbs(
        [inputs[i] for i in picked], [keys[i] for i in picked], [2, 3, 1], 4, 1.0, cuda,
        packed=(tasks, picked),
    )
    fresh = readcount_gibbs.run_batched_gibbs(
        [inputs[i] for i in picked], [keys[i] for i in picked], [2, 3, 1], 4, 1.0, cuda
    )
    for (a_noise, a_paths), (b_noise, b_paths) in zip(reused, fresh):
        assert np.array_equal(a_noise, b_noise) and np.array_equal(a_paths, b_paths)


@pytest.mark.parametrize("case", ["cluster_set", "over_shared_memory", "packed"])
def test_gibbs_posterior_kernel_matches_plain(cuda, case):
    """Every sampled pair equal to the plain version's: seeded clusters of
    up to 28 paths; one of 200 paths (its CDFs do not
    fit shared memory) beside a staged one; 120 clusters of up to 16
    paths, several to a block."""
    clusters = posterior_cluster_set(48, seed=48)
    if case == "over_shared_memory":
        clusters = [posterior_wide_cluster(200, 49), clusters[3]]
    if case == "packed":
        clusters = posterior_cluster_set(120, seed=47, max_paths=16)
    keys = list(prng.split(prng.prng_key(5), len(clusters)))
    jobs = posteriors.posterior_gibbs_jobs(clusters, keys, cuda)
    plan = jobs.launches
    if case == "over_shared_memory":
        assert posterior_gibbs_cuda.table_bytes(200) > posterior_gibbs_cuda.SMEM_LIMIT
    if case == "packed":
        assert max(np.diff(jobs.host["block_starts"][0])) >= 8
    with counted() as counts:
        kernel = posterior_gibbs_cuda.posterior_gibbs(jobs)
    torch.cuda.synchronize()
    assert counts["gibbs.pair.launches"] == len(plan)
    plain = posterior_gibbs_cuda.posterior_gibbs_plain(jobs)
    assert torch.equal(kernel.cpu(), plain.cpu())


def test_gibbs_samplers_on_cuda_route(cuda):
    """The models' entry points reach both kernels on cuda and return
    normalised results."""
    inputs = gibbs_job_set(16, seed=50)
    keys = list(prng.split(prng.prng_key(2), len(inputs)))
    with counted() as counts:
        results = readcount_gibbs.run_batched_gibbs(inputs, keys, 4, 3, 1.0, cuda)
    assert counts["gibbs.readcount.jobs"] == len(inputs)
    for item, (noise, paths) in zip(inputs, results):
        np.testing.assert_allclose(noise + paths.sum(axis=1), item[4], rtol=1e-9)
    clusters = posterior_cluster_set(10, seed=51)
    with counted() as counts:
        post = posteriors.path_group_posteriors_gibbs_batched(clusters, 2, keys[:10], cuda)
    assert counts["gibbs.pair.clusters"] == counts["posteriors.scored.cuda"] == 10
    for groups, freqs in post:
        assert abs(float(np.sum(freqs)) - 1.0) < 1e-12
        assert all(a <= b for a, b in groups)


# ------------------------------------------------ ploidy k != 2


@pytest.mark.parametrize("k", [1, 3, 4, 5])
def test_group_scores_kernel_matches_plain(cuda, k):
    """Seeded clusters of 1-32 paths (16 at k = 5), one of 512 rows x 32
    paths (16 words of the pre-pass, 8 warps per tile of groups) and one
    with groups scored -inf: within rtol 1e-10 of the plain version, -inf
    where it is -inf; two grids a call (pre-pass, scores)."""
    from rpvg_tpu_torch.ops import group_scores_cuda
    from rpvg_tpu_torch.testing import enumeration_cluster_set

    clusters = enumeration_cluster_set(40, seed=60 + k, group_size=k)
    packed = group_scores_cuda.make_clusters([c[:3] for c in clusters], k, cuda)
    with counted() as counts:
        kernel = group_scores_cuda.group_scores(packed)
    torch.cuda.synchronize()
    assert (counts["groups.launches"], counts["groups.kernel_clusters"]) == (2, len(clusters))
    plain = group_scores_cuda.group_scores_ragged_plain(packed)
    kernel, plain = kernel.cpu().numpy(), plain.cpu().numpy()
    assert np.array_equal(np.isneginf(kernel), np.isneginf(plain)) and np.isneginf(plain).any()
    finite = np.isfinite(plain)
    np.testing.assert_allclose(kernel[finite], plain[finite], rtol=1e-10, atol=0)


def test_group_scores_kernel_unstaged_rows_and_large_group_size(cuda):
    """A cluster of 7,000 paths (7,001 bit words for its 32 rows, read
    through L1) beside small ones at k = 1; group size 9 reads its
    prefix from the table."""
    from rpvg_tpu_torch.ops import group_scores_cuda
    from rpvg_tpu_torch.testing import enumeration_cluster_set

    rng = np.random.default_rng(66)
    wide = (rng.random((3, 7000)), rng.uniform(1e-4, 0.05, 3), np.array([1.0, 2.0, 3.0]))
    small = enumeration_cluster_set(3, seed=67, group_size=1, max_paths=8, max_rows=20)
    for k, inputs in ((1, [wide] + [c[:3] for c in small]), (9, [c[:3] for c in small])):
        packed = group_scores_cuda.make_clusters(inputs, k, cuda)
        kernel = group_scores_cuda.group_scores(packed).cpu().numpy()
        plain = group_scores_cuda.group_scores_ragged_plain(packed).cpu().numpy()
        finite = np.isfinite(plain)
        assert np.array_equal(np.isneginf(kernel), np.isneginf(plain))
        np.testing.assert_allclose(kernel[finite], plain[finite], rtol=1e-10, atol=0)


@pytest.mark.parametrize("k", [3, 9])
def test_group_scores_kernel_short_prefixes_and_many_rows(cuda, k):
    """Clusters of 2-12 paths (prefixes of 1-12 groups, several in a warp
    of 32), one of 5,000 rows with rows of zero noise and of zero count
    (-inf and NaN groups), and group size 9 past the register slots:
    within rtol 1e-10 of the plain version, -inf and NaN where it has
    them, bitwise the same on a second run; the scoring grid keeps at
    least 2 blocks of 8 warps on an SM."""
    from rpvg_tpu_torch.ops import group_scores_cuda

    rng = np.random.default_rng(90 + k)
    inputs = []
    for P in ([2, 3, 5, 7, 12] if k == 3 else [2, 3, 4]):
        R = int(rng.integers(20, 90))
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.4)
        inputs.append((probs, rng.uniform(1e-4, 0.05, R), rng.geometric(0.4, R).astype(float)))
    R = 5000 if k == 3 else 300
    probs = rng.random((R, 20 if k == 3 else 4)) * (rng.random((R, 20 if k == 3 else 4)) < 0.3)
    noise, counts = rng.uniform(1e-4, 0.05, R), rng.geometric(0.4, R).astype(float)
    # Row 7: zero noise, mass on path 1 alone (-inf wherever a group
    # misses it); row X: zero noise and count, mass on path 0 alone (NaN
    # wherever a group misses it).
    X = 2500 % R
    noise[[7, X]], counts[[11, X]] = 0.0, 0.0
    probs[7], probs[7, 1], probs[X], probs[X, 0] = 0.0, 0.5, 0.0, 0.5
    inputs.append((probs, noise, counts))
    packed = group_scores_cuda.make_clusters(inputs, k, cuda)
    kernel = group_scores_cuda.group_scores(packed)
    again = group_scores_cuda.group_scores(packed)
    torch.cuda.synchronize()
    assert torch.equal(kernel.view(torch.int64), again.view(torch.int64))
    kernel = kernel.cpu().numpy()
    plain = group_scores_cuda.group_scores_ragged_plain(packed).cpu().numpy()
    assert np.array_equal(np.isneginf(kernel), np.isneginf(plain)) and np.isneginf(plain).any()
    assert np.array_equal(np.isnan(kernel), np.isnan(plain)) and np.isnan(plain).any()
    finite = np.isfinite(plain)
    np.testing.assert_allclose(kernel[finite], plain[finite], rtol=1e-10, atol=0)
    assert group_scores_cuda.blocks_per_sm(k) >= 2


def _k_slot_clusters(k):
    from rpvg_tpu_torch.testing import posterior_cluster_set, posterior_wide_cluster

    return posterior_cluster_set(24, seed=70 + k, max_paths=120) + [
        posterior_wide_cluster(200, 79, n_rows=3000)
    ]


@pytest.mark.parametrize("k", [1, 3, 4])
def test_posterior_gibbs_k_kernel_matches_plain(cuda, k):
    """Clusters of 1-120 paths and one of 200 paths x 3,000 rows (180,000
    nonzeros: past shared memory even in a cluster of 8 CTAs): every
    sampled group equal to the plain version's, or
    the cluster's posterior within total variation 0.05 of the plain
    version's (a draw flips where a uniform falls within rounding of a
    CDF boundary)."""
    from rpvg_tpu_torch.ops import posterior_gibbs_k_cuda

    clusters = _k_slot_clusters(k)
    jobs, diverged = _hold_k_slot_to_plain(cuda, posterior_gibbs_k_cuda, clusters, k, key=8)
    assert any(not lc.staged for lc in jobs.launches)
    assert diverged <= len(clusters) // 4


@pytest.mark.parametrize("model", ["haplotypes", "haplotype-transcripts"])
@pytest.mark.parametrize("gibbs", [False, True], ids=["enumeration", "hap-gibbs"])
def test_ploidy_3_cli_on_cuda(cuda, model, gibbs, tmp_path):
    """`-y 3` through the CLI on cuda: the new kernels' counters (and the
    EM kernel's for haplotype-transcripts) move; without Gibbs the
    outputs match --backend cpu within rtol 1e-6."""
    import os

    from rpvg_tpu_torch import cli, sim
    from rpvg_tpu_torch.compare import compare_estimate_files
    panel = sim.build_gene_panel(
        num_genes=5, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=61,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 1200, read_length=80, frag_mean=200, frag_sd=20, seed=63,
        abundances=sim.gene_abundances(panel, seed=67), multipath_dag=True,
    )
    files = {n: str(tmp_path / n) for n in ("graph.json", "panel.json", "aln.json", "info.tsv")}
    sim.write_alignment_json(records, files["aln.json"])
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    for backend in ("cuda", "cpu"):
        argv = ["-g", files["graph.json"], "-p", files["panel.json"], "-a", files["aln.json"],
                "-o", str(tmp_path / backend), "-i", model, "-y", "3", "-r", "5",
                "--score-not-qual", "--backend", backend]
        argv += ["-f", files["info.tsv"]] if model == "haplotype-transcripts" else []
        argv += ["--use-hap-gibbs"] if gibbs else []
        assert cli.main(argv) == 0
        if backend == "cuda":
            counters = spans.recent_runs(1)[0]["counters"]
    assert counters.get("gibbs.kslot.launches" if gibbs else "groups.launches", 0) > 0
    if model == "haplotype-transcripts":
        assert counters.get("em.ragged.launches", 0) > 0
    if not gibbs:
        suffixes = (".txt", "_joint.txt") if model == "haplotype-transcripts" else (".txt",)
        for suffix in suffixes:
            report = compare_estimate_files(
                os.path.join(tmp_path, "cuda" + suffix), os.path.join(tmp_path, "cpu" + suffix),
                1e-6, 1e-6,
            )
            assert report["rows"] > 0


# ------------------------------------- --ind-hap-inference and --multiprocess


def _gene_panel_files(tmp_path):
    from rpvg_tpu_torch import sim

    panel = sim.build_gene_panel(
        num_genes=5, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=61,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 1200, read_length=80, frag_mean=200, frag_sd=20, seed=63,
        abundances=sim.gene_abundances(panel, seed=67), multipath_dag=True,
    )
    files = {n: str(tmp_path / n) for n in ("graph.json", "panel.json", "aln.json", "info.tsv")}
    sim.write_alignment_json(records, files["aln.json"])
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    return files


def _nested_argv(files, prefix, backend, extra=()):
    return ["-g", files["graph.json"], "-p", files["panel.json"], "-a", files["aln.json"],
            "-o", prefix, "-i", "haplotype-transcripts", "-f", files["info.tsv"], "-r", "5",
            "--score-not-qual", "--backend", backend, *extra]


@pytest.mark.parametrize(
    "extra",
    [(), ("-y", "3"), ("-n", "8"), ("--use-hap-gibbs",)],
    ids=["y2", "y3", "n8", "hap-gibbs"],
)
def test_ind_hap_cli_on_cuda_matches_cpu(cuda, extra, tmp_path):
    """`--ind-hap-inference` on cuda: phase D's tasks all go to the EM
    kernel (and phase I2's jobs to the group scorer at -y 3, to the pair
    sampler under --use-hap-gibbs); without --use-hap-gibbs the estimate
    files match --backend cpu within rtol 1e-6 (-n leaves them alone)."""
    import os

    from rpvg_tpu_torch import cli
    from rpvg_tpu_torch.compare import compare_estimate_files

    files = _gene_panel_files(tmp_path)
    extra = ("--ind-hap-inference", *extra)
    rc, stats = cli.run_cli(_nested_argv(files, str(tmp_path / "cuda"), "cuda", extra))
    assert rc == 0
    counters = stats["counters"]
    assert counters["em.ragged.tasks"] == stats["em_tasks"] > 0
    if "-y" in extra:
        assert counters["groups.kernel_clusters"] == stats["scored_clusters"]
    if "--use-hap-gibbs" in extra:
        assert counters["gibbs.pair.clusters"] == stats["scored_clusters"]
        return
    assert cli.main(_nested_argv(files, str(tmp_path / "cpu"), "cpu", extra)) == 0
    for suffix in (".txt", "_joint.txt"):
        report = compare_estimate_files(
            os.path.join(tmp_path, "cuda" + suffix), os.path.join(tmp_path, "cpu" + suffix),
            1e-6, 1e-6,
        )
        assert report["rows"] > 0


_FORK_PROBE = r"""
import json, os, sys
import torch
from rpvg_tpu_torch import cli
from rpvg_tpu_torch.parallel import multihost

out_dir, argv = sys.argv[1], sys.argv[2:]
shard_worker = multihost._shard_worker

def recording_worker(args):
    with open(os.path.join(out_dir, f"worker_{os.getpid()}.json"), "w") as handle:
        json.dump({"initialized": torch.cuda.is_initialized(),
                   "bad_fork": torch.cuda._is_in_bad_fork()}, handle)
    return shard_worker(args)

multihost._shard_worker = recording_worker
rc = cli.main(argv)
print(json.dumps({"rc": rc, "parent_initialized": torch.cuda.is_initialized()}))
"""


def test_multiprocess_forks_before_cuda(cuda, tmp_path):
    """`--multiprocess 2` on cuda from a fresh interpreter: each forked
    worker finds no CUDA state (not initialised, not forked from a
    process that had it), the parent uses the card after the fork, and
    the outputs are the single-process run's bytes."""
    import glob
    import json
    import os
    import subprocess
    import sys

    from rpvg_tpu_torch import cli

    files = _gene_panel_files(tmp_path)
    assert cli.main(_nested_argv(files, str(tmp_path / "single"), "cuda")) == 0
    argv = _nested_argv(files, str(tmp_path / "mp"), "cuda", ("--multiprocess", "2", "-t", "2"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _FORK_PROBE, str(tmp_path), *argv], capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=repo), timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "parent_initialized": True}
    workers = [json.load(open(path)) for path in glob.glob(str(tmp_path / "worker_*.json"))]
    assert len(workers) == 2
    assert all(w == {"initialized": False, "bad_fork": False} for w in workers)
    for suffix in (".txt", "_joint.txt"):
        with open(str(tmp_path / "mp") + suffix, "rb") as a, open(str(tmp_path / "single") + suffix, "rb") as b:
            assert a.read() == b.read()


def test_profile_hook_traces_the_em_kernel(cuda, tmp_path, monkeypatch):
    """``RPVG_TPU_TORCH_PROFILE`` on cuda: one Chrome trace of the batched
    dispatch, whose device events name the ragged EM kernel (A1)."""
    import glob
    import json

    from rpvg_tpu_torch import cli

    files = _gene_panel_files(tmp_path)
    monkeypatch.setenv("RPVG_TPU_TORCH_PROFILE", str(tmp_path / "traces"))
    assert cli.main(_nested_argv(files, str(tmp_path / "out"), "cuda")) == 0
    (trace,) = glob.glob(str(tmp_path / "traces" / "*.pt.trace.json"))
    with open(trace) as handle:
        events = json.load(handle)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("warp_team_kernel" in n or "block_team_kernel" in n for n in kernels), kernels


@pytest.fixture
def one_thread():
    """One intra-op torch thread, as the port's CPU test files pin it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sharded_kernels_bitwise_on_virtual_cuda_shards(cuda, one_thread):
    """Every kernel dispatch on 4 virtual shards of the card against one
    shard: each task, job and cluster is computed alone, so bitwise."""
    from rpvg_tpu_torch.parallel import autoshard

    tasks = em_task_set(300, seed=41)
    jobs = gibbs_job_set(60, seed=43)
    keys = [prng.prng_key(i) for i in range(len(jobs))]
    clusters = posterior_cluster_set(64, seed=45, max_paths=10)
    ckeys = [prng.prng_key(500 + i) for i in range(len(clusters))]

    def run():
        em, packed = batching.run_batched_em_packed(tasks, 10000, 1e-3, cuda)
        picked = np.arange(len(jobs))
        gibbs_tasks = [(job[0], job[1]) for job in jobs]
        _, gibbs_packed = batching.run_batched_em_packed(gibbs_tasks, 10000, 1e-3, cuda)
        return (
            em,
            readcount_gibbs.run_batched_gibbs(jobs, keys, 4, 3, 1.0, cuda,
                                              packed=(gibbs_packed, picked)),
            posteriors.full_posteriors_batched(clusters, 3, cuda),
            posteriors.path_group_posteriors_gibbs_batched(clusters, 2, ckeys, cuda),
            posteriors.path_group_posteriors_gibbs_batched(clusters[:24], 3, ckeys[:24], cuda),
            len(packed.parts),
        )

    def same(a, b):
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b

    single = run()
    with autoshard.virtual_devices(cuda, 4):
        sharded = run()
    assert single[-1] == 1 and sharded[-1] > 1
    for name, a, b in zip(("em", "read-count Gibbs", "group scores", "posterior Gibbs 2",
                           "posterior Gibbs 3"), sharded, single):
        assert same(a, b), name


def test_dryrun_multidevice_4_virtual_cuda_shards(cuda, one_thread):
    """The dry run on 4 virtual shards of the card: the mesh step, the
    batched dispatches and the pipeline in both regimes with -n 3 -b and the
    giant-cluster shard route."""
    from rpvg_tpu_torch import entry

    report = entry.dryrun_multidevice(4, cuda, virtual=True)
    assert set(report["regimes"]) == {"score", "qual"}
    assert set(report["regimes"].values()) <= {"byte-identical", "compare.py"}
    assert report["sharded_giant_clusters"] > 0


@pytest.mark.parametrize("case", ["sparse", "dense"])
def test_posterior_gibbs_k_kernel_sparse_and_dense_clusters(cuda, case):
    """Clusters over 90 % zeros (most paths' logits from the shared row
    logs alone) and with no zeros (every entry a list entry): every
    sampled group equal to the plain version's, or the cluster within
    total variation 0.05 of it."""
    from rpvg_tpu_torch.ops import posterior_gibbs_k_cuda

    rng = np.random.default_rng(81 if case == "sparse" else 82)
    clusters = []
    for i in range(12):
        R, P = int(rng.integers(5, 120)), int(rng.integers(2, 60))
        probs = rng.random((R, P))
        if case == "sparse":
            probs *= rng.random((R, P)) < 0.05
            probs[np.arange(R), rng.integers(0, P, size=R)] += rng.random(R)
            assert (probs == 0).mean() > 0.9 or P < 12
        clusters.append((probs, rng.uniform(1e-4, 0.05, R),
                         rng.geometric(0.4, size=R).astype(np.float64), [1] * P))
    if case == "sparse":
        assert np.mean([(c[0] == 0).mean() for c in clusters if c[0].shape[1] >= 12]) > 0.9
    _hold_k_slot_to_plain(cuda, posterior_gibbs_k_cuda, clusters, 3)


@pytest.mark.parametrize("k", [3, 4])
def test_posterior_gibbs_k_kernel_multi_cta(cuda, k):
    """A cluster whose logs per slot step need a thread-block cluster of
    several CTAs (rows split across them, partials summed through
    distributed shared memory), beside small ones: every group equal to
    the plain version's, or within total variation 0.05."""
    from rpvg_tpu_torch.ops import posterior_gibbs_k_cuda
    from rpvg_tpu_torch.testing import posterior_cluster_set

    rng = np.random.default_rng(90 + k)
    R, P = 1500, 60
    probs = rng.random((R, P)) * (rng.random((R, P)) < 0.5)
    probs[np.arange(R), rng.integers(0, P, size=R)] += rng.random(R)
    big = (probs, rng.uniform(1e-4, 0.05, R), rng.geometric(0.4, size=R).astype(np.float64),
           [1] * P)
    jobs, _ = _hold_k_slot_to_plain(cuda, posterior_gibbs_k_cuda,
                                    [big] + posterior_cluster_set(6, seed=95), k)
    assert max(lc.ctas for lc in jobs.launches) > 1


def _hold_k_slot_to_plain(cuda, module, clusters, k, key=11):
    """(jobs, diverged clusters) of the k-slot kernel on ``clusters``
    against its plain version: one launch per planned launch, the same
    groups on a second run, and every cluster's groups equal to the plain
    version's or its posterior within total variation 0.05."""
    keys = list(prng.split(prng.prng_key(key), len(clusters)))
    jobs = posteriors.posterior_gibbs_k_jobs(clusters, k, keys, cuda)
    with counted() as counts:
        kernel = module.posterior_gibbs_k(jobs)
    torch.cuda.synchronize()
    assert counts["gibbs.kslot.launches"] == len(jobs.launches)
    assert torch.equal(kernel, module.posterior_gibbs_k(jobs))
    kernel = kernel.cpu().numpy()
    plain = module.posterior_gibbs_k_plain(jobs).cpu().numpy()
    h = jobs.host
    k_post = posteriors._group_sample_posteriors(kernel, h, k)
    p_post = posteriors._group_sample_posteriors(plain, h, k)
    diverged = 0
    for b in range(len(clusters)):
        lo, hi = h["out_offsets"][b], h["out_offsets"][b + 1]
        if not np.array_equal(kernel[lo:hi], plain[lo:hi]):
            diverged += 1
            a = dict(zip(map(tuple, k_post[b][0]), k_post[b][1]))
            z = dict(zip(map(tuple, p_post[b][0]), p_post[b][1]))
            tv = 0.5 * sum(abs(a.get(g, 0.0) - z.get(g, 0.0)) for g in set(a) | set(z))
            assert tv < 0.05, (b, tv)
    return jobs, diverged



# ----------------------------------------- the fused native routes' legs

_FUSED_PANEL = {}


@pytest.fixture
def fused_panel(cuda, tmp_path_factory):
    """80 genes x 3 isoforms x 4 haplotypes, 3,000 multipath read pairs."""
    if not _FUSED_PANEL:
        from rpvg_tpu_torch import sim

        work = tmp_path_factory.mktemp("fused_panel")
        panel = sim.build_gene_panel(
            num_genes=80, isoforms_per_gene=3, num_haplotypes=4,
            exons_per_gene=5, exon_length=100, variant_sites=3, seed=61,
        )
        records, _ = sim.simulate_read_pairs(
            panel, 3000, read_length=80, frag_mean=200, frag_sd=20, seed=63,
            abundances=sim.gene_abundances(panel, seed=67), multipath_dag=True,
        )
        files = {n: str(work / n) for n in ("graph.json", "panel.json", "aln.json", "info.tsv")}
        sim.write_alignment_json(records, files["aln.json"])
        panel.write_graph_json(files["graph.json"])
        panel.write_panel_json(files["panel.json"])
        panel.write_info_tsv(files["info.tsv"])
        _FUSED_PANEL.update(files)
    return dict(_FUSED_PANEL)


# (leg, its switches, the kernel it launches, its counter in the stats)
FUSED_LEGS = [
    ("escalation", {"RPVG_TPU_EM_BOUND": "3", "RPVG_TPU_ESC_MIN_AREA": "0"}, "ragged",
     "fused.escalated_on_device"),
    ("escalation_default", {"RPVG_TPU_EM_BOUND": "3"}, "ragged", "fused.escalated_on_device"),
    ("deferral", {"RPVG_TPU_HYBRID_EM_AREA": "8"}, "ragged", "fused.deferred_tasks"),
    ("slots", {"RPVG_TPU_DEVICE_SLOT_AREA": "500"}, "padded", "fused.routed_slots"),
]


@pytest.mark.parametrize("leg,switches,kernel,counter", FUSED_LEGS,
                         ids=[leg[0] for leg in FUSED_LEGS])
def test_fused_nested_leg_on_cuda_matches_cpu(cuda, fused_panel, leg, switches, kernel,
                                              counter, tmp_path, monkeypatch):
    """Each device leg of the fused nested route on cuda launches its EM
    kernel (the ragged kernel for the escalated tail and the deferred
    tasks, the multi-bucket kernel for slot routing) on
    every task the leg took, and the estimate files match the all-native
    fused run on the CPU within rtol 1e-6 with identical rows."""
    import os

    from rpvg_tpu_torch import cli
    from rpvg_tpu_torch.compare import compare_estimate_files

    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "1")
    assert cli.main(_nested_argv(fused_panel, str(tmp_path / "cpu"), "cpu")) == 0
    for name, value in switches.items():
        monkeypatch.setenv(name, value)
    rc, stats = cli.run_cli(_nested_argv(fused_panel, str(tmp_path / "cuda"), "cuda"))
    assert rc == 0 and stats["route"] == "fused native"
    counters = stats["counters"]
    assert counters[counter] > 0 and counters["fused.device_em_tasks"] > 0
    assert counters[f"em.{kernel}.launches"] > 0
    assert counters[f"em.{kernel}.tasks"] == counters["fused.device_em_tasks"]
    for suffix in (".txt", "_joint.txt"):
        report = compare_estimate_files(
            os.path.join(tmp_path, "cuda" + suffix), os.path.join(tmp_path, "cpu" + suffix),
            1e-6, 1e-6,
        )
        assert report["rows"] > 0


@pytest.mark.parametrize("model,switch", [
    ("haplotype-transcripts", "RPVG_TPU_FUSED_NESTED"), ("strains", "RPVG_TPU_FUSED_STRAINS"),
])
def test_fused_route_gibbs_on_cuda(cuda, fused_panel, model, switch, tmp_path, monkeypatch):
    """-n 8 on a fused route: every Gibbs job in the read-count kernel;
    the estimate files match the CPU run within rtol 1e-6 and the
    _gibbs.txt.gz rows agree in distribution (row means within 6 standard
    errors, as chip_smoke.py holds them)."""
    import math
    import os

    from rpvg_tpu_torch import cli
    from rpvg_tpu_torch.compare import compare_estimate_files, compare_gibbs_files

    monkeypatch.setenv(switch, "1")
    argv = lambda prefix, backend: _nested_argv(  # noqa: E731
        fused_panel, str(tmp_path / prefix), backend, ("-n", "8"))
    if model == "strains":
        argv = lambda prefix, backend: [  # noqa: E731
            "-g", fused_panel["graph.json"], "-p", fused_panel["panel.json"],
            "-a", fused_panel["aln.json"], "-o", str(tmp_path / prefix), "-i", "strains",
            "-r", "5", "--score-not-qual", "--backend", backend, "-n", "8"]
    rc, stats = cli.run_cli(argv("cuda", "cuda"))
    counters = stats["counters"]
    assert rc == 0 and stats["route"] == "fused native" and stats["gibbs_jobs"] > 0
    assert counters["gibbs.readcount.jobs"] == stats["gibbs_jobs"]
    assert cli.main(argv("cpu", "cpu")) == 0
    for suffix in (".txt", "_joint.txt") if model != "strains" else (".txt",):
        compare_estimate_files(os.path.join(tmp_path, "cuda" + suffix),
                               os.path.join(tmp_path, "cpu" + suffix), 1e-6, 1e-6)
    report = compare_gibbs_files(os.path.join(tmp_path, "cuda_gibbs.txt.gz"),
                                 os.path.join(tmp_path, "cpu_gibbs.txt.gz"), 6.0, same_rows=True)
    assert report["rows"] > 0
    assert report["outside"] <= max(4, math.ceil(0.005 * report["rows"]))


def test_dispatch_em_device_returns_before_its_kernels_finish(cuda):
    """dispatch_em_device queues its copies and launches and returns: an
    event recorded on the stream just after it has not completed, and
    gather_em_device does the waiting."""
    import time

    task_list = em_task_set(512, seed=71)
    indices = range(len(task_list))
    warm = [None] * len(task_list)
    batching.gather_em_device(
        batching.dispatch_em_device(task_list, indices, 10000, 1e-3, cuda), task_list, warm
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = batching.dispatch_em_device(task_list, indices, 20000, 1e-300, cuda)
    returned = time.perf_counter() - t0
    after = torch.cuda.Event()
    after.record()
    assert not after.query(), "the dispatch waited for its kernels"
    results = [None] * len(task_list)
    t0 = time.perf_counter()
    batching.gather_em_device(pending, task_list, results)
    waited = time.perf_counter() - t0
    assert after.query() and waited > 0
    assert all(r is not None for r in results)
    print(f"dispatch returned in {returned * 1e3:.3f} ms, gather waited {waited * 1e3:.3f} ms")
