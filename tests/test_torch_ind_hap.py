"""``haplotype-transcripts --ind-hap-inference`` through the port's CLI on
the CPU: every output file byte-identical to an in-process ``rpvg_tpu``
run (the CPU route runs the port's copies of the same native kernels and
samplers on the same keys and numpy streams), except ``--use-hap-gibbs``
at ploidy 3, whose k-slot sampler draws from Philox where the JAX
package's draws from threefry: that one is held in distribution.  Also:
the batched route against the copied per-cluster estimator, the plain
PyTorch versions within rtol 1e-6, the verbatim subset-sampling block,
and a run with jax blocked."""

import gzip
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import rpvg_tpu.infer.batched_models as ref_batched_models
import rpvg_tpu.pipeline as ref_pipeline
import rpvg_tpu_torch.infer.batched_models as port_batched_models
import rpvg_tpu_torch.pipeline as port_pipeline
from rpvg_tpu import sim
from rpvg_tpu_torch import cli
from rpvg_tpu_torch.compare import compare_estimate_files
from rpvg_tpu_torch.infer.estimators import ClusterRNG
from rpvg_tpu_torch.probabilities import ReadPathProbs

from test_torch_slice import _NO_JAX_RUN, REPO, one_torch_thread  # noqa: F401

SEED = 31

# (name, extra CLI flags, PipelineConfig fields)
CONFIGS = [
    ("y2", (), {}),
    ("y2-n", ("-n", "4"), {"num_gibbs_samples": 4}),
    ("y2-hap-gibbs", ("--use-hap-gibbs",), {"use_hap_gibbs": True}),
    ("y2-n-hap-gibbs", ("-n", "4", "--use-hap-gibbs"),
     {"num_gibbs_samples": 4, "use_hap_gibbs": True}),
    ("y3", ("-y", "3"), {"ploidy": 3}),
    ("y3-n", ("-y", "3", "-n", "4"), {"ploidy": 3, "num_gibbs_samples": 4}),
]


def _write_panel(work, num_genes, isoforms, pairs, seed):
    panel = sim.build_gene_panel(
        num_genes=num_genes, isoforms_per_gene=isoforms, num_haplotypes=4,
        exons_per_gene=6, exon_length=100, variant_sites=3, seed=seed,
    )
    records, _ = sim.simulate_read_pairs(
        panel, pairs, read_length=80, frag_mean=200, frag_sd=20, seed=seed + 2,
        abundances=sim.gene_abundances(panel, seed=seed + 6), multipath_dag=True,
    )
    files = {name: str(work / name) for name in ("graph.json", "panel.json", "aln.json", "info.tsv")}
    sim.write_alignment_json(records, files["aln.json"])
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    files["pairs"] = pairs
    return files


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """8 genes x 4 isoforms x 4 haplotypes, 2,000 multipath read pairs."""
    return _write_panel(tmp_path_factory.mktemp("ind_panel"), 8, 4, 2000, 41)


@pytest.fixture(scope="module")
def small_panel_files(tmp_path_factory):
    """4 genes x 3 isoforms x 4 haplotypes, 800 pairs: the k-slot
    sampler's plain version steps every chain in torch on the CPU."""
    return _write_panel(tmp_path_factory.mktemp("ind_small"), 4, 3, 800, 61)


def _argv(files, prefix, extra=(), seed=SEED):
    return [
        "-g", files["graph.json"], "-p", files["panel.json"], "-a", files["aln.json"],
        "-o", prefix, "-i", "haplotype-transcripts", "-f", files["info.tsv"],
        "-r", str(seed), "--score-not-qual", "-t", "2", "--backend", "cpu",
        "--ind-hap-inference", *extra,
    ]


def _reference(files, prefix, seed=SEED, **fields):
    return ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=files["graph.json"], paths=files["panel.json"], alignments=files["aln.json"],
        output_prefix=prefix, inference_model="haplotype-transcripts",
        path_info=files["info.tsv"], rng_seed=seed, score_not_qual=True, threads=2,
        ind_hap_inference=True, **fields,
    ))


def _outputs(prefix, gibbs):
    contents = {}
    for name in (".txt", "_joint.txt") + (("_gibbs.txt.gz",) if gibbs else ()):
        opener = gzip.open if name.endswith(".gz") else open
        with opener(prefix + name, "rb") as handle:
            contents[name] = handle.read()
    return contents


@pytest.mark.parametrize("name,extra,fields", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_ind_hap_cli_byte_identical_to_reference(name, extra, fields, panel_files, tmp_path):
    prefix, ref_prefix = str(tmp_path / "port"), str(tmp_path / "ref")
    rc, stats = cli.run_cli(_argv(panel_files, prefix, extra))
    assert rc == 0
    assert list(stats["phase_seconds"])[:4] == ["I1", "I2", "I3", "C"]
    assert stats["em_tasks"] > 0 and stats["scored_clusters"] > 0
    assert (stats["gibbs_jobs"] > 0) == ("-n" in extra)
    _reference(panel_files, ref_prefix, **fields)
    gibbs = "-n" in extra
    port, ref = _outputs(prefix, gibbs), _outputs(ref_prefix, gibbs)
    assert port[".txt"].count(b"\n") > 10
    for suffix in port:
        assert port[suffix] == ref[suffix], f"{name}: {suffix} differs"


def _tv(a, b):
    return 0.5 * sum(abs(a.get(g, 0.0) - b.get(g, 0.0)) for g in set(a) | set(b))


def _cluster_posteriors(results):
    return [
        {tuple(g): float(p) for g, p in zip(r.estimates.path_group_sets, r.estimates.posteriors)}
        for r in results if r.estimates.path_group_sets
    ]


@pytest.mark.parametrize("gibbs", [False, True], ids=["hap-gibbs", "n-hap-gibbs"])
def test_ind_hap_gibbs_ploidy_3_matches_reference_in_distribution(
    gibbs, small_panel_files, tmp_path
):
    """Per cluster, the port's sampled haplotype-group posteriors are no
    further from the JAX package's than a second JAX seed's are: the
    mean excess of the total variation is at most 0.01 + 3 standard
    errors (chip_smoke.py's bound across devices).  Read counts sum to
    the input pairs; with -n every Gibbs row has its four samples."""
    from rpvg_tpu_torch.compare import read_gibbs_file

    extra = ("-y", "3", "--use-hap-gibbs") + (("-n", "4") if gibbs else ())
    fields = {"ploidy": 3, "use_hap_gibbs": True, "num_gibbs_samples": 4 if gibbs else 0}
    prefix = str(tmp_path / "port")
    rc, stats = cli.run_cli(_argv(small_panel_files, prefix, extra))
    assert rc == 0 and stats["group_engine"] == "posterior Gibbs, 3 slots"
    port = _cluster_posteriors(stats["results"])
    ref = _cluster_posteriors(_reference(small_panel_files, str(tmp_path / "ref"), **fields)["results"])
    other = _cluster_posteriors(
        _reference(small_panel_files, str(tmp_path / "ref2"), seed=SEED + 1, **fields)["results"]
    )
    assert len(port) == len(ref) == len(other) > 3
    excess = np.array([_tv(p, r) - _tv(o, r) for p, r, o in zip(port, ref, other)])
    se = excess.std(ddof=1) / np.sqrt(excess.size)
    assert excess.mean() <= 0.01 + 3 * se, (excess.mean(), se)
    with open(prefix + ".txt") as handle:
        header, *rows = [line.rstrip("\n").split("\t") for line in handle]
    reads = sum(float(row[header.index("ReadCount")]) for row in rows)
    assert reads == pytest.approx(small_panel_files["pairs"], rel=1e-3)
    if gibbs:
        _, gibbs_rows = read_gibbs_file(prefix + "_gibbs.txt.gz")
        assert gibbs_rows and all(len(v) == 4 for v in gibbs_rows.values())


def _sparse_rows(dense):
    """The per-cluster estimator's input form: one ReadPathProbs per row
    of the native matrix code's DenseCluster (the same floats back)."""
    rows = []
    for probs, noise, count in zip(dense.probs, dense.noise, dense.counts):
        rpp = ReadPathProbs(int(count))
        rpp.noise_prob = float(noise)
        rpp.path_probs = [(float(probs[j]), [int(j)]) for j in np.flatnonzero(probs)]
        rows.append(rpp)
    return rows


@pytest.mark.parametrize(
    "name,extra",
    [("y2", ()), ("y2-n-hap-gibbs", ("-n", "4", "--use-hap-gibbs")), ("y3-n", ("-y", "3", "-n", "4"))],
    ids=["y2", "y2-n-hap-gibbs", "y3-n"],
)
def test_batched_route_equals_per_cluster_estimator(
    name, extra, panel_files, tmp_path, monkeypatch
):
    """The copied per-cluster ``_infer_independent_groups`` (its EM, pair
    scores and samplers one cluster at a time on the CPU) writes the
    batched route's bytes."""

    def per_cluster(estimator, batch_data, device, rng_seed, ranks):
        for (est, cluster_probs), rank in zip(batch_data, ranks):
            estimator.estimate(est, _sparse_rows(cluster_probs), ClusterRNG(rng_seed, rank))
        return {"phase_seconds": {}}

    batched = str(tmp_path / "batched")
    assert cli.main(_argv(panel_files, batched, extra)) == 0
    monkeypatch.setattr(
        port_pipeline, "batched_haplotype_transcripts_independent", per_cluster
    )
    single = str(tmp_path / "single")
    assert cli.main(_argv(panel_files, single, extra)) == 0
    gibbs = "-n" in extra
    a, b = _outputs(batched, gibbs), _outputs(single, gibbs)
    for suffix in a:
        assert a[suffix] == b[suffix], f"{name}: {suffix} differs"


@pytest.mark.parametrize("extra", [(), ("-y", "3")], ids=["y2", "y3"])
def test_plain_versions_within_tolerance(extra, panel_files, tmp_path, monkeypatch):
    """RPVG_TPU_NATIVE_EM=0: the EM and the pair selection in their plain
    PyTorch versions, the same rows within rtol 1e-6 of ``rpvg_tpu``."""
    ref_prefix = str(tmp_path / "ref")
    _reference(panel_files, ref_prefix, **({"ploidy": 3} if extra else {}))
    monkeypatch.setenv("RPVG_TPU_NATIVE_EM", "0")
    prefix = str(tmp_path / "plain")
    assert cli.main(_argv(panel_files, prefix, extra)) == 0
    for suffix in (".txt", "_joint.txt"):
        report = compare_estimate_files(prefix + suffix, ref_prefix + suffix, 1e-6, 1e-6)
        assert report["rows"] > 10


def test_subset_sampling_is_verbatim():
    """Phase I3's body is the JAX package's subset sampling, line for
    line (``batched_models.py:211-358``)."""
    ref = inspect.getsource(ref_batched_models.batched_haplotype_transcripts_independent)
    start = ref.index("    per_cluster_jobs: Dict[int, List] = {}\n")
    end = ref.index("        np_rng_of[ci] = np_rng\n") + len("        np_rng_of[ci] = np_rng\n")
    block = ref[start:end]
    assert block.count("\n") > 140
    assert block in inspect.getsource(port_batched_models._sample_subsets)


def test_ind_hap_runs_with_jax_blocked(panel_files, tmp_path):
    """`--ind-hap-inference -n 4 --use-hap-gibbs` with jax and the JAX
    package blocked (the card's host has neither)."""
    prefix = str(tmp_path / "out")
    argv = _argv(panel_files, prefix, ("-n", "4", "--use-hap-gibbs"))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, *argv],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK 0" in proc.stdout
    assert _outputs(prefix, gibbs=True)["_gibbs.txt.gz"].count(b"\n") > 10
