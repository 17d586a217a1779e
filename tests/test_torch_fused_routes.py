"""The port's fused native routes on the CPU against the JAX package's:
the fused nested route (``RPVG_TPU_FUSED_NESTED``) and its device legs
(task deferral, bounded-EM escalation, slot routing), the fused strains
route (``RPVG_TPU_FUSED_STRAINS``), the CLI's bytes and the native
output composer.

The populations are those of tests/test_nested_fused.py, built from a
numpy seed through the port's copied ``probabilities`` module and the
JAX package's, so both packages see the same clusters.  On the CPU every
leg takes the native library, as the JAX package does, and is bitwise
the all-native run; with ``RPVG_TPU_NATIVE_EM=0`` the legs run the
kernels' plain versions, held within rtol 1e-6 with identical group
sets."""

import gzip
import os

import numpy as np
import pytest
import torch

import rpvg_tpu.infer.batched_models as ref_batched_models
import rpvg_tpu.infer.estimators as ref_estimators
import rpvg_tpu.pipeline as ref_pipeline
import rpvg_tpu.probabilities as ref_probabilities
import rpvg_tpu_torch.infer.batched_models as port_batched_models
import rpvg_tpu_torch.infer.estimators as port_estimators
import rpvg_tpu_torch.probabilities as port_probabilities
from rpvg_tpu import sim
from rpvg_tpu.infer.estimates import PathClusterEstimates as RefEstimates
from rpvg_tpu_torch import cli, spans
from rpvg_tpu_torch.infer import batching
from rpvg_tpu_torch.infer.estimates import PathClusterEstimates as PortEstimates
from rpvg_tpu_torch.ops import em_fused_cuda

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RTOL = 1e-6
SEED = 7

# Every switch the fused routes read; each test sets the ones it needs.
SWITCHES = (
    "RPVG_TPU_FUSED_NESTED", "RPVG_TPU_FUSED_STRAINS", "RPVG_TPU_NATIVE_EM",
    "RPVG_TPU_HYBRID_EM_AREA", "RPVG_TPU_EM_BOUND", "RPVG_TPU_ESC_MIN_AREA",
    "RPVG_TPU_DEVICE_SLOT_AREA",
    "RPVG_TPU_COMPOSE_OUT", "RPVG_TPU_FUSE_EM",
)


@pytest.fixture(autouse=True)
def clean_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


# ------------------------------------------------------------ populations


def nested_population(probabilities, seed, n_clusters):
    """tests/test_nested_fused.py's ``_random_population`` through
    ``probabilities`` (the port's module or the JAX package's)."""
    PathInfo, ReadPathProbs = probabilities.PathInfo, probabilities.ReadPathProbs
    rng = np.random.default_rng(seed)
    clusters = []
    for c in range(n_clusters):
        n_transcripts = int(rng.integers(1, 4))
        n_haps = int(rng.integers(2, 5))
        paths = [
            PathInfo(
                name=f"c{c}_t{t}_h{h}", group_id=t, source_count=1,
                source_ids=frozenset([h]), length=200,
                effective_length=float(rng.integers(80, 160)),
            )
            for t in range(n_transcripts)
            for h in range(n_haps)
        ]
        n_paths = len(paths)
        rpps = []
        for _ in range(int(rng.integers(3, 12))):
            k = int(rng.integers(1, min(4, n_paths) + 1))
            ids = sorted(rng.choice(n_paths, size=k, replace=False).tolist())
            prob = float(rng.uniform(0.2, 0.99)) / k
            rpp = ReadPathProbs(int(rng.integers(1, 30)), 1e-8)
            rpp.noise_prob = float(rng.uniform(1e-4, 0.05))
            rpp.path_probs = [(prob, ids)]
            rpps.append(rpp)
        clusters.append((paths, rpps))
    clusters.append(([PathInfo(name="empty", source_ids=frozenset([0]))], []))
    return clusters


def strains_population(probabilities, seed, n_clusters):
    """tests/test_nested_fused.py's ``_strains_population`` through
    ``probabilities``."""
    PathInfo, ReadPathProbs = probabilities.PathInfo, probabilities.ReadPathProbs
    rng = np.random.default_rng(seed)
    clusters = []
    for c in range(n_clusters):
        n_paths = int(rng.integers(1, 9))
        paths = [
            PathInfo(name=f"s{c}_p{p}", group_id=p, source_count=1,
                     source_ids=frozenset([p]), length=150,
                     effective_length=float(rng.integers(60, 140)))
            for p in range(n_paths)
        ]
        rpps = []
        for _ in range(int(rng.integers(2, 10))):
            k = int(rng.integers(1, n_paths + 1))
            ids = sorted(rng.choice(n_paths, size=k, replace=False).tolist())
            rpp = ReadPathProbs(int(rng.integers(1, 25)), 1e-8)
            rpp.noise_prob = float(rng.uniform(1e-4, 0.05))
            rpp.path_probs = [(float(rng.uniform(0.1, 0.95)) / k, ids)]
            rpps.append(rpp)
        if rng.random() < 0.3:
            rpp = ReadPathProbs(3, 1e-8)
            rpp.noise_prob = 1.0
            rpp.path_probs = []
            rpps.append(rpp)
        clusters.append((paths, rpps))
    clusters.append(([PathInfo(name="empty")], []))
    return clusters


def _data(clusters, estimates_cls):
    data = []
    for paths, rpps in clusters:
        est = estimates_cls()
        est.paths = paths
        data.append((est, rpps))
    return data


def run_port_nested(seed, n_clusters, gibbs=0, min_hap_prob=0.001):
    estimator = port_estimators.NestedPathAbundanceEstimator(
        group_size=2, min_hap_prob=min_hap_prob, infer_collapsed=True,
        use_group_post_gibbs=False, num_gibbs_samples=gibbs,
    )
    data = _data(nested_population(port_probabilities, seed, n_clusters), PortEstimates)
    with spans.RunSpan("rpvg.test") as run:
        stats = port_batched_models.batched_haplotype_transcripts(
            estimator, data, CPU, rng_seed=SEED
        )
    return [est for est, _ in data], {**stats, **run.run.summary()}, estimator


def run_ref_nested(seed, n_clusters, gibbs=0, min_hap_prob=0.001):
    estimator = ref_estimators.NestedPathAbundanceEstimator(
        group_size=2, min_hap_prob=min_hap_prob, infer_collapsed=True,
        use_group_post_gibbs=False, num_gibbs_samples=gibbs,
    )
    data = _data(nested_population(ref_probabilities, seed, n_clusters), RefEstimates)
    ref_batched_models.batched_haplotype_transcripts(estimator, data, rng_seed=SEED)
    return [est for est, _ in data]


def _sets(est):
    return [list(map(int, group)) for group in est.path_group_sets]


def assert_same_estimates(got, want, rtol=0.0):
    """Identical group sets and sample path ids; numbers bitwise, or
    within ``rtol`` when it is given."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _sets(a) == _sets(b)
        assert a.total_count == b.total_count
        for x, y in ((a.noise_count, b.noise_count), (a.posteriors, b.posteriors),
                     (a.abundances, b.abundances)):
            x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
            if rtol:
                np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-9)
            else:
                np.testing.assert_array_equal(x, y)
        assert len(a.gibbs_read_count_samples) == len(b.gibbs_read_count_samples)
        for sa, sb in zip(a.gibbs_read_count_samples, b.gibbs_read_count_samples):
            assert list(sa.path_ids) == list(sb.path_ids)
            if not rtol:
                assert sa.noise_samples == sb.noise_samples
                assert sa.abundance_samples == sb.abundance_samples


# ------------------------------------------------------- the fused routes


@pytest.mark.parametrize("min_hap_prob", [0.001, 0.2])
def test_fused_nested_matches_reference(min_hap_prob, monkeypatch):
    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "1")
    port, stats, estimator = run_port_nested(13, 25, min_hap_prob=min_hap_prob)
    assert stats["route"] == "fused native"
    assert set(stats["phase_seconds"]) == {"native", "device", "combine"}
    assert stats["em_tasks"] > 25 and "fused.device_em_tasks" not in stats["counters"]
    assert estimator._columnar_outputs["kind"] == "sets"
    assert_same_estimates(port, run_ref_nested(13, 25, min_hap_prob=min_hap_prob))


def test_fused_nested_gibbs_matches_reference(monkeypatch):
    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "1")
    port, stats, _ = run_port_nested(29, 12, gibbs=8)
    assert stats["gibbs_jobs"] > 0 and "D2" in stats["phase_seconds"]
    assert_same_estimates(port, run_ref_nested(29, 12, gibbs=8))


def test_unset_switch_keeps_the_staged_route():
    port, stats, estimator = run_port_nested(13, 25)
    assert "route" not in stats and "D" in stats["phase_seconds"]
    # The staged route's phase E leaves its set streams for the composer.
    assert estimator._columnar_outputs["kind"] == "sets"
    assert estimator._columnar_outputs["combined"].all()


# (leg, its switches, the counter that shows it ran)
LEGS = [
    ("deferral", {"RPVG_TPU_HYBRID_EM_AREA": "8"}, "fused.deferred_tasks"),
    ("escalation", {"RPVG_TPU_EM_BOUND": "3", "RPVG_TPU_ESC_MIN_AREA": "0"},
     "fused.escalated_on_device"),
    ("rebatch", {"RPVG_TPU_EM_BOUND": "3"}, "fused.escalated_tasks"),
    ("slots", {"RPVG_TPU_DEVICE_SLOT_AREA": "60"}, "fused.routed_slots"),
]


@pytest.mark.parametrize("native_em", ["1", "0"], ids=["native", "plain"])
@pytest.mark.parametrize("leg,switches,counter", LEGS, ids=[leg[0] for leg in LEGS])
def test_device_leg_matches_all_native_run(leg, switches, counter, native_em, monkeypatch):
    """Each device leg forced on the CPU against the all-native fused run
    of the same population: bitwise with the native EM, within rtol 1e-6 on the plain
    versions; the leg's counter shows that it ran."""
    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "1")
    full, full_stats, _ = run_port_nested(31, 80)
    assert counter not in full_stats["counters"]
    for name, value in switches.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", native_em)
    routed, stats, estimator = run_port_nested(31, 80)
    counters = stats["counters"]
    assert counters[counter] > 0
    assert (counters.get("fused.device_em_tasks", 0) > 0) == (leg != "rebatch")
    if leg == "slots":
        found = stats["spans"]
        assert found["rpvg.fused.dispatch"]["total_s"] > 0
        assert found["rpvg.fused.gather_wait"]["count"] == 1
    assert estimator._columnar_outputs["combined"].all()
    assert_same_estimates(routed, full, rtol=0.0 if native_em == "1" or leg == "rebatch" else RTOL)


def test_slot_routing_routes_as_reference(monkeypatch):
    """RPVG_TPU_DEVICE_SLOT_AREA routes the slots that the JAX package's
    select_device_slots routes under the same cutoff."""
    from rpvg_tpu.parallel.linkprobe import select_device_slots

    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "1")
    monkeypatch.setenv("RPVG_TPU_DEVICE_SLOT_AREA", "60")
    _, stats, _ = run_port_nested(31, 80)
    areas = []
    for paths, rpps in nested_population(port_probabilities, 31, 80):
        if rpps:
            dense = port_batched_models.cluster_matrix(rpps, len(paths))
            areas.append(dense[0].shape[0] * dense[0].shape[1])
    assert stats["counters"]["fused.routed_slots"] == len(select_device_slots(areas)) > 0


def test_hybrid_area_zero_defers_nothing(monkeypatch):
    """RPVG_TPU_HYBRID_EM_AREA=0 leaves the fused route as it is unset:
    no deferral, the bounded escalation on."""
    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "1")
    full, _, _ = run_port_nested(31, 30)
    monkeypatch.setenv("RPVG_TPU_HYBRID_EM_AREA", "0")
    routed, stats, _ = run_port_nested(31, 30)
    assert "fused.deferred_tasks" not in stats["counters"] and stats["route"] == "fused native"
    assert stats["em_bound"] == 1024
    assert_same_estimates(routed, full)


def test_escalation_min_area_defaults():
    """The escalated tail goes to the card by default, and stays on the
    host elsewhere (the JAX package's default)."""
    assert port_batched_models.escalation_min_area(torch.device("cuda")) == 0
    assert port_batched_models.escalation_min_area(CPU) == 10**12


def _strains_run(module, estimates_cls, estimator_module, gibbs, *args):
    estimator = estimator_module.MinimumPathAbundanceEstimator(num_gibbs_samples=gibbs)
    probabilities = port_probabilities if module is port_batched_models else ref_probabilities
    data = _data(strains_population(probabilities, 41, 30), estimates_cls)
    stats = module.batched_strains(estimator, data, *args)
    return [est for est, _ in data], stats, estimator


@pytest.mark.parametrize("gibbs", [0, 6])
def test_fused_strains_matches_reference(gibbs, monkeypatch):
    monkeypatch.setenv("RPVG_TPU_FUSED_STRAINS", "1")
    port, stats, estimator = _strains_run(
        port_batched_models, PortEstimates, port_estimators, gibbs, CPU, 11
    )
    assert stats["route"] == "fused native" and stats["gibbs_jobs"] == (
        stats["em_tasks"] if gibbs else 0)
    assert estimator._columnar_outputs["kind"] == "cover"
    ref, _, _ = _strains_run(ref_batched_models, RefEstimates, ref_estimators, gibbs, 11)
    assert_same_estimates(port, ref)


# ----------------------------------------------------------- EM dispatch


def test_cluster_extents_of_host_and_tensor_blocks_agree():
    """cluster_extents reads numpy blocks and tensors alike: rows to the
    last nonzero count, columns to the last positive mask."""
    rng = np.random.default_rng(5)
    tasks = [(rng.random((r, c)), np.where(rng.random(r) < 0.3, 0.0, rng.random(r)))
             for r, c in ((3, 2), (7, 5), (1, 1), (12, 4))]
    block = batching.build_block(tasks, range(len(tasks)), 16, 8, CPU)
    want = [(int(np.flatnonzero(counts)[-1]) + 1 if counts.any() else 0, probs.shape[1])
            for probs, counts in tasks]
    np.testing.assert_array_equal(em_fused_cuda.cluster_extents([block]), want)
    np.testing.assert_array_equal(
        em_fused_cuda.cluster_extents([tuple(t.numpy() for t in block)]), want
    )


@pytest.mark.parametrize("n_tasks", [40, 600])
def test_dispatch_on_cpu_is_the_native_kernel(n_tasks):
    """dispatch_em_device and gather_em_device on the CPU give the native
    kernel's results bitwise, as run_batched_em does."""
    from rpvg_tpu_torch.testing import em_task_set

    tasks = em_task_set(n_tasks, seed=9)
    n = len(tasks)
    results = [None] * n
    batching.gather_em_device(
        batching.dispatch_em_device(tasks, range(n), 10000, 1e-3, CPU), tasks, results
    )
    for (got, got_noise), (want, want_noise) in zip(
        results, batching.run_native_em(tasks, 10000, 1e-3)
    ):
        np.testing.assert_array_equal(got, want)
        assert got_noise == want_noise


# -------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """tests/test_torch_gibbs_slice.py's panel: 8 genes x 4 isoforms x 4
    haplotypes, 2,000 multipath read pairs."""
    work = tmp_path_factory.mktemp("fused_panel")
    panel = sim.build_gene_panel(
        num_genes=8, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=100, variant_sites=3, seed=41,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 2000, read_length=80, frag_mean=200, frag_sd=20, seed=43,
        abundances=sim.gene_abundances(panel, seed=47), multipath_dag=True,
    )
    files = {name: str(work / name) for name in ("graph.json", "panel.json", "aln.json", "info.tsv")}
    sim.write_alignment_json(records, files["aln.json"])
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    return files


def _cli(files, model, prefix, gibbs=0):
    argv = [
        "-g", files["graph.json"], "-p", files["panel.json"], "-a", files["aln.json"],
        "-o", prefix, "-i", model, "-r", "31", "--score-not-qual", "-t", "2",
        "--backend", "cpu",
    ]
    if model == "haplotype-transcripts":
        argv += ["-f", files["info.tsv"]]
    if gibbs:
        argv += ["-n", str(gibbs)]
    rc, stats = cli.run_cli(argv)
    assert rc == 0
    return stats


def _outputs(prefix, model, gibbs):
    names = [".txt"] + (["_joint.txt"] if model == "haplotype-transcripts" else [])
    names += ["_gibbs.txt.gz"] if gibbs else []
    out = {}
    for name in names:
        opener = gzip.open if name.endswith(".gz") else open
        with opener(prefix + name, "rb") as handle:
            out[name] = handle.read()
    return out


@pytest.mark.parametrize("gibbs", [0, 8])
@pytest.mark.parametrize("model,switch", [
    ("haplotype-transcripts", "RPVG_TPU_FUSED_NESTED"), ("strains", "RPVG_TPU_FUSED_STRAINS"),
])
def test_fused_cli_writes_reference_bytes(model, switch, gibbs, panel_files, tmp_path,
                                          monkeypatch):
    monkeypatch.setenv(switch, "1")
    prefix = str(tmp_path / "port")
    stats = _cli(panel_files, model, prefix, gibbs)
    assert stats["route"] == "fused native"
    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=panel_files["graph.json"], paths=panel_files["panel.json"],
        alignments=panel_files["aln.json"], output_prefix=ref_prefix, inference_model=model,
        path_info=panel_files["info.tsv"] if model == "haplotype-transcripts" else None,
        rng_seed=31, score_not_qual=True, threads=2, num_gibbs_samples=gibbs,
    ))
    port, ref = _outputs(prefix, model, gibbs), _outputs(ref_prefix, model, gibbs)
    assert port[".txt"].count(b"\n") > 10
    assert port == ref


@pytest.mark.parametrize("model,switch", [
    ("transcripts", None), ("strains", None), ("strains", "RPVG_TPU_FUSED_STRAINS"),
    ("haplotype-transcripts", "RPVG_TPU_FUSED_NESTED"),
])
def test_output_composer_matches_object_writers(model, switch, panel_files, tmp_path,
                                                monkeypatch):
    """RPVG_TPU_COMPOSE_OUT=1 (the native composer) and =0 (the object
    writers) write the same bytes, on the staged and the fused routes."""
    if switch:
        monkeypatch.setenv(switch, "1")
    outputs = {}
    for compose in ("1", "0"):
        monkeypatch.setenv("RPVG_TPU_COMPOSE_OUT", compose)
        prefix = str(tmp_path / f"compose{compose}")
        _cli(panel_files, model, prefix)
        outputs[compose] = _outputs(prefix, model, 0)
    assert outputs["1"][".txt"].count(b"\n") > 10
    assert outputs["1"] == outputs["0"]


def test_composer_runs_on_the_routes_that_leave_streams(panel_files, tmp_path, monkeypatch):
    """The composer writes the staged transcripts and the fused nested
    route's files: the object writers are not called."""
    from rpvg_tpu_torch.io import writers

    def refuse(*args, **kwargs):
        raise AssertionError("object writer called")

    monkeypatch.setattr(writers.AbundanceEstimatesWriter, "add_estimates", refuse)
    monkeypatch.setattr(writers.HaplotypeAbundanceEstimatesWriter, "add_estimates", refuse)
    _cli(panel_files, "transcripts", str(tmp_path / "t"))
    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "1")
    _cli(panel_files, "haplotype-transcripts", str(tmp_path / "h"))
    assert os.path.getsize(str(tmp_path / "h_joint.txt")) > 0
