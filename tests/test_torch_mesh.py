"""The port's multi-device layer on the CPU (``parallel/autoshard.py``,
``parallel/mesh.py`` and every sharded dispatch).  The same seeded numpy
inputs go to the JAX package on the 8-device CPU mesh that
``tests/conftest.py`` forces and to the port on 8 virtual CPU shards
(``autoshard.virtual_devices``); and every sharded dispatch of the port
is held bitwise against the same dispatch on one shard, with the native
CPU route off (``RPVG_TPU_NATIVE_EM=0``) so that the plain versions run
and shard."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpvg_tpu.infer import posteriors as ref_posteriors
from rpvg_tpu.parallel import mesh as ref_mesh
from rpvg_tpu_torch import cli, prng, sim
from rpvg_tpu_torch.infer import batching, posteriors, readcount_gibbs
from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda
from rpvg_tpu_torch.parallel import autoshard, mesh
from rpvg_tpu_torch.pipeline import PipelineConfig, run_pipeline
from rpvg_tpu_torch.testing import (
    counted,
    em_task_set,
    gibbs_job_set,
    posterior_cluster_set,
    random_task,
    shard_counts,
)

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SHARDS = 8


@pytest.fixture
def plain(monkeypatch):
    """The plain versions on the CPU, not the native library."""
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")


def _shards(n=SHARDS):
    return autoshard.virtual_devices(CPU, n)


def _em_batch(seed, B=16, R=32, C=8):
    rng = np.random.default_rng(seed)
    probs = rng.random((B, R, C))
    probs /= probs.sum(axis=2, keepdims=True)
    counts = rng.integers(1, 10, size=(B, R)).astype(np.float64)
    return probs, counts, np.ones((B, C)), np.full((B, C - 1), 1.0 / 50.0)


# --------------------------------------------------- against the JAX mesh


def test_sharded_em_step_matches_jax():
    probs, counts, col_masks, inv_eff = _em_batch(5)
    ref_abund, ref_tpm = ref_mesh.sharded_em_step(ref_mesh.make_mesh(8), max_em_its=300)(
        *(jnp.asarray(a) for a in (probs, counts, col_masks, inv_eff))
    )
    with _shards() as devices:
        abund, tpm = mesh.sharded_em_step(mesh.make_mesh(devices), max_em_its=300)(
            probs, counts, col_masks, inv_eff
        )
    np.testing.assert_allclose(abund.numpy(), np.asarray(ref_abund), rtol=1e-8, atol=1e-10)
    assert float(tpm) == pytest.approx(float(ref_tpm), rel=1e-8)


def _pair_cluster(seed, R=16, P=24):
    rng = np.random.default_rng(seed)
    probs = rng.random((R, P)) * 0.4
    noise = rng.random(R) * 0.1 + 0.01
    # A read with no noise that no path of the first pair explains: -inf.
    noise[0], probs[0, :2] = 0.0, 0.0
    counts = rng.integers(1, 8, size=R).astype(np.float64)
    log_freqs = np.log(rng.integers(1, 4, size=P) / 10.0)
    log_freqs[-3:] = -np.inf
    return probs, noise, counts, log_freqs


def _same_scores(port, ref):
    port, ref = np.asarray(port), np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(port[finite], ref[finite], rtol=1e-10, atol=0)


def test_sharded_diploid_scores_match_jax():
    probs, noise, counts, log_freqs = _pair_cluster(11)
    ref = ref_mesh.sharded_diploid_scores(ref_mesh.make_mesh(8, model=8))(
        *(jnp.asarray(a) for a in (probs, noise, counts, log_freqs))
    )
    with _shards() as devices:
        port = mesh.sharded_diploid_scores(mesh.make_mesh(devices, data=1, model=8))(
            probs, noise, counts, log_freqs
        )
    assert np.isneginf(port.numpy()).any()
    _same_scores(port, ref)


def test_psum_histogram_matches_jax():
    local = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    ref = ref_mesh.psum_histogram(ref_mesh.make_mesh(8))(jnp.asarray(local))
    with _shards() as devices:
        port = mesh.psum_histogram(mesh.make_mesh(devices))(local)
    assert np.array_equal(port.numpy(), np.asarray(ref))


def test_full_inference_step_matches_jax():
    probs, counts, col_masks, inv_eff = _em_batch(7, C=17)
    noise = np.full(32, 0.01)
    log_freqs = np.log(np.arange(1, 17) / 136.0)
    args = (probs, counts, col_masks, inv_eff, noise, log_freqs)
    ref_abund, ref_tpm, ref_pairs = ref_mesh.full_inference_step(
        ref_mesh.make_mesh(8, model=2), max_em_its=200
    )(*(jnp.asarray(a) for a in args))
    with _shards() as devices:
        abund, tpm, pairs = mesh.full_inference_step(mesh.make_mesh(devices, model=2),
                                                     max_em_its=200)(*args)
    np.testing.assert_allclose(abund.numpy(), np.asarray(ref_abund), rtol=1e-8, atol=1e-10)
    assert float(tpm) == pytest.approx(float(ref_tpm), rel=1e-8)
    _same_scores(pairs, ref_pairs)


def test_giant_cluster_shard_route_matches_jax(monkeypatch):
    """A cluster whose (R, P, P) tensor passes the element guard but fits
    it times the shard count: both packages split its pair rows over the
    shards."""
    rng = np.random.default_rng(11)
    R, P = 16, 24
    probs = rng.random((R, P)) * 0.4
    noise = rng.random(R) * 0.1 + 0.01
    counts = rng.integers(1, 8, size=R).astype(float)
    path_counts = [1] * P
    # R * P_pad^2 = 16 * 32^2: above the per-device limit, within 8 times it.
    monkeypatch.setattr(ref_posteriors, "_PAIR_TENSOR_ELEMENT_LIMIT", 2048)
    monkeypatch.setenv("RPVG_TPU_PAIR_TENSOR_LIMIT", "2048")
    ran = []
    monkeypatch.setattr(ref_posteriors, "_pair_scores_sharded",
                        lambda *a, f=ref_posteriors._pair_scores_sharded: ran.append(1) or f(*a))
    ref_groups, ref_post = ref_posteriors.path_group_posteriors_diploid(
        probs, noise, counts, path_counts, 1e-300
    )
    with _shards(), counted() as found:
        groups, post = posteriors.path_group_posteriors_diploid(
            probs, noise, counts, path_counts, 1e-300, CPU
        )
    assert ran and found["posteriors.sharded_pair_clusters"] == 1
    assert groups == ref_groups
    np.testing.assert_allclose(post, ref_post, rtol=1e-9, atol=1e-12)


# --------------------------------------------- sharded against one shard


def _results_equal(a, b):
    """Nested lists/tuples of arrays, numbers and group lists, bitwise."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_results_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _em_iterations(monkeypatch):
    """Record the fractions and iterations of every em_fixed_point call."""
    calls = []
    launch = em_cuda.em_fixed_point

    def spy(tasks, *args):
        out = launch(tasks, *args)
        calls.append(out)
        return out

    monkeypatch.setattr(em_cuda, "em_fixed_point", spy)
    return calls


def _bucket_tasks(seed, n=64):
    """``n`` tasks that all pad to one (32, 16) bucket of the multi-bucket
    route, so that its chunk's batch divides 8."""
    rng = np.random.default_rng(seed)
    return [random_task(rng, int(rng.integers(9, 33)), int(rng.integers(9, 17))) for _ in range(n)]


def _gibbs_keys(n, base=0):
    return [prng.prng_key(base + i) for i in range(n)]


def _with_keys(jobs):
    return jobs, _gibbs_keys(len(jobs))


DISPATCHES = {
    "ragged_em": lambda: batching.run_batched_em(em_task_set(120, seed=3), 10000, 1e-3, CPU),
    "pair_scores": lambda: posteriors.diploid_posteriors_batched(
        posterior_cluster_set(90, seed=5), 1e-3, CPU),
    "group_scores": lambda: posteriors.full_posteriors_batched(
        posterior_cluster_set(40, seed=6, max_paths=10), 3, CPU),
    "readcount_gibbs": lambda: readcount_gibbs.run_batched_gibbs(
        *_with_keys(gibbs_job_set(30, seed=7)), 3, 2, 1.0, CPU),
    "posterior_gibbs_2": lambda: posteriors.path_group_posteriors_gibbs_batched(
        posterior_cluster_set(24, seed=8, max_paths=12), 2, _gibbs_keys(24, 100), CPU),
    "posterior_gibbs_3": lambda: posteriors.path_group_posteriors_gibbs_batched(
        posterior_cluster_set(16, seed=9, max_paths=6), 3, _gibbs_keys(16, 200), CPU),
}


@pytest.mark.parametrize("name", sorted(DISPATCHES))
def test_sharded_dispatch_bitwise_equal_to_one_shard(name, plain):
    single = DISPATCHES[name]()
    with _shards(), counted() as counts:
        sharded = DISPATCHES[name]()
    work = shard_counts(counts)
    assert _results_equal(sharded, single)
    assert len(work) > 1 and sum(work) > 0, work


def test_ragged_em_iterations_and_packed_gibbs_bitwise(plain, monkeypatch):
    """The ragged route's fractions and iterations per task, and the
    read-count sampler on the task sets phase D packed per shard."""
    jobs = gibbs_job_set(40, seed=12)
    tasks = [(job[0], job[1]) for job in jobs]
    keys = _gibbs_keys(len(jobs), 300)
    picked = np.arange(len(jobs))[::-1]  # jobs in another order than their tasks

    def run():
        calls = _em_iterations(monkeypatch)
        results, packed = batching.run_batched_em_packed(tasks, 10000, 1e-3, CPU)
        samples = readcount_gibbs.run_batched_gibbs(
            [jobs[j] for j in picked], [keys[j] for j in picked], 3, 2, 1.0, CPU,
            packed=(packed, picked),
        )
        fracs = torch.cat([f for f, _ in calls])
        iters = torch.cat([i for _, i in calls])
        return results, samples, fracs, iters, len(packed.parts)

    single = run()
    with _shards():
        sharded = run()
    assert single[4] == 1 and sharded[4] > 1
    assert all(_results_equal(a, b) for a, b in zip(sharded[:4], single[:4]))


def test_fused_route_shards_each_divisible_chunk(plain, monkeypatch):
    monkeypatch.setenv("RPVG_TPU_FUSE_EM", "1")
    tasks = _bucket_tasks(13)
    calls = []
    padded = em_fused_cuda.em_fixed_point_padded

    def spy(blocks, *args):
        calls.append([b[0].shape[0] for b in blocks])
        return padded(blocks, *args)

    monkeypatch.setattr(em_fused_cuda, "em_fixed_point_padded", spy)
    single = batching.run_batched_em(tasks, 10000, 1e-3, CPU)
    assert calls == [[64]]
    calls.clear()
    with _shards():
        sharded = batching.run_batched_em(tasks, 10000, 1e-3, CPU)
    assert calls == [[8]] * SHARDS
    assert _results_equal(sharded, single)


def test_giant_cluster_route_bitwise_equal_to_blocked(plain, monkeypatch):
    """Row stripes on the shards and column blocks on one device give the
    same bits (the JAX dry run's giant-cluster leg)."""
    monkeypatch.setenv("RPVG_TPU_PAIR_TENSOR_LIMIT", "256")
    clusters = posterior_cluster_set(30, seed=14)
    single = posteriors.diploid_posteriors_batched(clusters, 1e-3, CPU)
    with _shards(), counted() as counts:
        sharded = posteriors.diploid_posteriors_batched(clusters, 1e-3, CPU)
    assert counts["posteriors.sharded_pair_clusters"] > 0
    assert _results_equal(sharded, single)


# ------------------------------------------------------------ autoshard


def test_shard_batched_indivisible_passthrough():
    a = torch.ones((6, 4), dtype=torch.float64)  # 6 % 8 != 0: stays whole
    with _shards() as devices:
        (part,) = autoshard.shard_batched(devices, a)
        assert part[0] is a
        parts = autoshard.shard_batched(devices, torch.arange(16.0), np.zeros((16, 3)))
    assert len(parts) == SHARDS and all(p[0].shape == (2,) and p[1].shape == (2, 3) for p in parts)
    assert torch.equal(torch.cat([p[0] for p in parts]), torch.arange(16.0))


def test_shard_tasks_contiguous_and_balanced():
    rng = np.random.default_rng(15)
    shapes = rng.integers(1, 60, size=(500, 2))
    ranges = autoshard.shard_tasks(shapes, 8)
    assert ranges[0][0] == 0 and ranges[-1][1] == 500
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    work = shapes[:, 0] * shapes[:, 1]
    per = [work[lo:hi].sum() for lo, hi in ranges]
    assert max(per) - min(per) <= 2 * work.max()
    few = autoshard.shard_tasks(shapes[:3], 8)
    assert len(few) == 8 and sorted(hi - lo for lo, hi in few) == [0] * 5 + [1] * 3
    assert autoshard.shard_tasks(np.zeros((0, 2)), 2) == [(0, 0), (0, 0)]


def test_data_devices(monkeypatch):
    """The CPU is one shard; CUDA never resolves to the CPU; the device
    count is asked for once, at the first dispatch, then cached."""
    autoshard.cache_clear()
    asked = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: asked.append(1) or 0)
    assert autoshard.data_devices(CPU) == (CPU,) and not asked
    cuda = torch.device("cuda")
    assert autoshard.data_devices(cuda) == (cuda,) and autoshard.data_devices(cuda) == (cuda,)
    assert len(asked) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    autoshard.cache_clear()
    assert autoshard.data_devices(cuda) == tuple(torch.device("cuda", i) for i in range(4))
    monkeypatch.setenv("RPVG_TPU_AUTOSHARD", "0")
    autoshard.cache_clear()
    assert autoshard.data_devices(cuda) == (cuda,)
    with autoshard.virtual_devices(cuda, 3):
        assert autoshard.num_data_shards(cuda) == 3 and autoshard.num_data_shards(CPU) == 1
    autoshard.cache_clear()


# ------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_mesh")
    panel = sim.build_gene_panel(
        num_genes=6, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=80, variant_sites=2, seed=61,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 800, read_length=70, frag_mean=180, frag_sd=15, seed=63,
        abundances=sim.gene_abundances(panel, seed=65), multipath_dag=True,
    )
    paths = {name: str(work / name) for name in ("graph.json", "panel.json", "info.tsv", "aln.json")}
    sim.write_alignment_json(records, paths["aln.json"])
    panel.write_graph_json(paths["graph.json"])
    panel.write_panel_json(paths["panel.json"])
    panel.write_info_tsv(paths["info.tsv"])
    return paths


def _read(prefix):
    with open(prefix + ".txt", "rb") as a, open(prefix + "_joint.txt", "rb") as b:
        return a.read(), b.read()


def test_pipeline_stats_report_shards(dataset, tmp_path, plain):
    def run(prefix):
        return run_pipeline(PipelineConfig(
            graph=dataset["graph.json"], paths=dataset["panel.json"],
            alignments=dataset["aln.json"], output_prefix=prefix,
            inference_model="haplotype-transcripts", path_info=dataset["info.tsv"],
            rng_seed=7, score_not_qual=True, num_gibbs_samples=2,
        ), CPU)

    single = run(str(tmp_path / "single"))
    with _shards(4):
        stats = run(str(tmp_path / "sharded"))
    assert single["data_shards"] == 1 and stats["data_shards"] == 4
    assert shard_counts(single["counters"], "em_tasks") == [single["em_tasks"]]
    work = {items: shard_counts(stats["counters"], items)
            for items in ("em_tasks", "gibbs_jobs", "pair_clusters")}
    assert len(work["em_tasks"]) == 4 and sum(work["em_tasks"]) == stats["em_tasks"]
    assert sum(work["gibbs_jobs"]) == stats["gibbs_jobs"]
    assert sum(work["pair_clusters"]) == stats["scored_clusters"]
    assert stats["device_peak_mib"] == {} and stats["device_peak_mib_max"] == 0.0
    assert _read(str(tmp_path / "sharded")) == _read(str(tmp_path / "single"))


def test_multiprocess_cli_forks_clean_with_shards(dataset, tmp_path, plain):
    """--multiprocess 2 forks its workers before any dispatch resolves
    the shards, and on 4 shards writes one process's bytes."""
    def argv(prefix, extra=()):
        return ["-g", dataset["graph.json"], "-p", dataset["panel.json"],
                "-a", dataset["aln.json"], "-o", prefix, "-i", "haplotype-transcripts",
                "-f", dataset["info.tsv"], "-r", "7", "--score-not-qual", "--backend", "cpu",
                *extra]

    assert cli.main(argv(str(tmp_path / "one"))) == 0
    autoshard.cache_clear()
    with _shards(4):
        rc, stats = cli.run_cli(argv(str(tmp_path / "mp"), ("--multiprocess", "2")))
    assert rc == 0 and stats["data_shards"] == 4
    assert _read(str(tmp_path / "mp")) == _read(str(tmp_path / "one"))
    assert not os.environ.get("RPVG_TPU_AUTOSHARD")
