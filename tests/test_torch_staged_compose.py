"""Phase E of the port's staged nested routes in one native call, and the
estimate files from the native output composer.

``_native_combine_clusters`` combines every cluster through
``rpvg_nested_combine`` (the fused route's combine tail) and leaves the
set streams in ``estimator._columnar_outputs``, so ``write_outputs``
composes ``.txt`` and ``_joint.txt`` in C++.  Held here on the CPU:

* on random tasks, the native combine gives ``combine_subset_tasks``'s
  sets, posteriors, abundances and noise counts bit for bit, and without
  the library's symbol the route keeps the Python combine and leaves no
  streams;
* through the CLI at ploidy 2, 3 and 4, with ``--ind-hap-inference`` and
  with ``-n 8``, the files are byte-identical with the composer, with the
  object writers (``RPVG_TPU_COMPOSE_OUT=0``) and from the JAX package's
  staged route; the panel has a cluster with no probability rows, and a
  path name that is not ASCII sends the files to the object writers;
* the multi-host runner, which writes with the object writers over the
  estimates' views, writes the same bytes."""

import copy
import dataclasses
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rpvg_tpu.pipeline as ref_pipeline
import rpvg_tpu_torch.probabilities as port_probabilities
from rpvg_tpu import sim
from rpvg_tpu_torch import cli, native, spans
from rpvg_tpu_torch.infer import batched_models
from rpvg_tpu_torch.infer.estimates import GroupSetViews, PathClusterEstimates
from rpvg_tpu_torch.infer.estimators import make_estimator
from rpvg_tpu_torch.pipeline import PipelineConfig, run_pipeline

from test_torch_fused_routes import nested_population
from test_torch_multihost import _DIST_RUN, WAIT_S, _free_port
from test_torch_slice import REPO, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SEED = 23
SWITCHES = ("RPVG_TPU_FUSED_NESTED", "RPVG_TPU_FUSED_STRAINS", "RPVG_TPU_NATIVE_EM",
            "RPVG_TPU_COMPOSE_OUT", "RPVG_TPU_FUSE_EM")
NON_ASCII = "tx_éß"


@pytest.fixture(autouse=True)
def clean_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


class _WithoutCombine:
    """The native library without ``rpvg_nested_combine``."""

    def __init__(self, lib):
        object.__setattr__(self, "_lib", lib)

    def __getattr__(self, name):
        if name == "rpvg_nested_combine":
            raise AttributeError(name)
        return getattr(self._lib, name)

    def __setattr__(self, name, value):
        setattr(self._lib, name, value)


def _without_combine(monkeypatch):
    lib = native.load_library()
    assert lib is not None and hasattr(lib, "rpvg_nested_combine")
    monkeypatch.setattr(native, "load_library", lambda: _WithoutCombine(lib))


# --------------------------------------------------- the combine, on tasks


def random_tasks(seed, n_clusters=40, k=4):
    """Clusters of paths in a few transcript groups (ids repeat across
    them, in no order), each with tasks on sorted k-path keys whose paths
    repeat 1 to k times, EM read counts with zeros, and noise counts; one
    cluster with no task."""
    estimator = make_estimator("haplotype-transcripts", ploidy=k, min_hap_prob=1e-3)
    rng = np.random.default_rng(seed)
    cluster_data, cluster_tasks, per_cluster = [], {}, {}
    for c in range(n_clusters):
        n_paths = int(rng.integers(1, 10))
        est = PathClusterEstimates()
        est.paths = [
            port_probabilities.PathInfo(
                name=f"c{c}_p{p}", group_id=int(rng.integers(0, 3)) * 7 + c % 2
            )
            for p in range(n_paths)
        ]
        est.total_count = float(rng.integers(1, 500)) + float(rng.random())
        cluster_data.append((est, [object()]))
        if c == 5:
            cluster_tasks[c], per_cluster[c] = [], []
            continue
        if c % 9 == 3:
            continue  # no probability rows: no tasks, not combined
        subset_probs = {}
        for _ in range(int(rng.integers(1, 8))):
            key = tuple(sorted(rng.choice(n_paths, size=k, replace=True).tolist()))
            subset_probs[key] = float(rng.uniform(1e-3, 0.6))
        tasks = estimator.prepare_subset_specs(subset_probs)
        assert tasks
        results = []
        for task in tasks:
            counts = rng.uniform(0, 40, len(task["collapsed"]))
            counts[rng.random(counts.size) < 0.2] = 0.0
            results.append((counts, float(rng.uniform(0, 3))))
        cluster_tasks[c], per_cluster[c] = tasks, results
    multiplicities = [sorted(t["multiplicity"].values())
                      for tasks in cluster_tasks.values() for t in tasks]
    assert any(m[0] == 1 for m in multiplicities) and any(m[-1] == k for m in multiplicities)
    assert k == 2 or any(m[0] == 1 < m[-1] for m in multiplicities)
    return estimator, cluster_data, cluster_tasks, per_cluster


def _bits(est):
    return (
        [[int(p) for p in group] for group in est.path_group_sets],
        np.asarray(est.posteriors, dtype=np.float64).tobytes(),
        np.asarray(est.abundances, dtype=np.float64).tobytes(),
        float(est.noise_count).hex(),
    )


@pytest.mark.parametrize("seed,k", [(1, 2), (2, 3), (3, 4), (4, 4)])
def test_native_combine_is_bitwise_combine_subset_tasks(seed, k):
    estimator, cluster_data, cluster_tasks, per_cluster = random_tasks(seed, k=k)
    python = copy.deepcopy(cluster_data)
    for ci, tasks in cluster_tasks.items():
        estimator.combine_subset_tasks(python[ci][0], tasks, per_cluster[ci])

    with spans.RunSpan("test") as root:
        columnar = batched_models._native_combine_clusters(
            cluster_data, cluster_tasks, per_cluster
        )
    counters = root.run.summary()["counters"]
    assert columnar is not None and columnar["kind"] == "sets"
    assert columnar["meta"] == sorted(cluster_tasks) and columnar["combined"].all()
    assert counters["combine.native_slots"] == len(cluster_tasks)
    assert counters["combine.sets"] == columnar["set_lens"].size == sum(
        len(python[ci][0].path_group_sets) for ci in cluster_tasks
    )
    for ci, (est, _) in enumerate(cluster_data):
        if ci in cluster_tasks:
            assert isinstance(est.path_group_sets, GroupSetViews)
            assert _bits(est) == _bits(python[ci][0]), ci
        else:
            assert est.path_group_sets == [] and est.noise_count == 0.0


def test_without_the_symbol_phase_e_combines_in_python(monkeypatch):
    clusters = nested_population(port_probabilities, 13, 25)

    def run():
        estimator = make_estimator("haplotype-transcripts", ploidy=2)
        data = []
        for paths, rpps in clusters:
            est = PathClusterEstimates()
            est.paths = paths
            data.append((est, rpps))
        stats = batched_models.batched_haplotype_transcripts(estimator, data, CPU, SEED)
        return estimator, data, stats

    estimator, native_data, _ = run()
    assert estimator._columnar_outputs["kind"] == "sets"
    _without_combine(monkeypatch)
    assert batched_models._native_combine_clusters(
        [(PathClusterEstimates(), [])], {0: []}, {0: []}
    ) is None
    estimator, python_data, stats = run()
    assert estimator._columnar_outputs is None and "E" in stats["phase_seconds"]
    assert any(est.path_group_sets for est, _ in python_data)
    for (a, _), (b, _) in zip(native_data, python_data):
        assert isinstance(b.path_group_sets, list)
        assert _bits(a) == _bits(b)


# ------------------------------------------------------- the CLI, end to end


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """7 genes x 3 isoforms x 4 haplotypes and 1,500 multipath read pairs,
    none from the first gene (a cluster with no probability rows); the
    panel and info files twice, once with a path name that is not ASCII."""
    work = tmp_path_factory.mktemp("staged_compose")
    panel = sim.build_gene_panel(
        num_genes=7, isoforms_per_gene=3, num_haplotypes=4,
        exons_per_gene=5, exon_length=100, variant_sites=3, seed=83,
    )
    abundances = sim.gene_abundances(panel, seed=89)
    first_gene = panel.info[panel.path_names[0]][0][:9]
    silent = [panel.info[name][0][:9] == first_gene for name in panel.path_names]
    abundances[np.asarray(silent)] = 0.0
    abundances /= abundances.sum()
    records, _ = sim.simulate_read_pairs(
        panel, 1500, read_length=80, frag_mean=200, frag_sd=20, seed=97,
        abundances=abundances, multipath_dag=True,
    )
    files = {name: str(work / name) for name in
             ("graph.json", "panel.json", "aln.json", "info.tsv")}
    sim.write_alignment_json(records, files["aln.json"])
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    renamed = panel.path_names[-1]
    panel.info[NON_ASCII] = panel.info.pop(renamed)
    panel.path_names[-1] = NON_ASCII
    files["panel_na.json"] = str(work / "panel_na.json")
    files["info_na.tsv"] = str(work / "info_na.tsv")
    panel.write_panel_json(files["panel_na.json"])
    panel.write_info_tsv(files["info_na.tsv"])
    return files


# (name, ploidy, CLI flags, PipelineConfig fields, names)
CLI_RUNS = [
    ("y2", 2, (), {}, "ascii"),
    ("y3", 3, (), {}, "ascii"),
    ("y4", 4, (), {}, "ascii"),
    ("ind-hap", 2, ("--ind-hap-inference",), {"ind_hap_inference": True}, "ascii"),
    ("y2-n8", 2, ("-n", "8"), {"num_gibbs_samples": 8}, "ascii"),
    ("y4-non-ascii", 4, (), {}, "non-ascii"),
]


def _inputs(files, names):
    if names == "ascii":
        return files["panel.json"], files["info.tsv"]
    return files["panel_na.json"], files["info_na.tsv"]


def _argv(files, ploidy, prefix, extra, names):
    panel, info = _inputs(files, names)
    return [
        "-g", files["graph.json"], "-p", panel, "-a", files["aln.json"], "-f", info,
        "-o", prefix, "-i", "haplotype-transcripts", "-y", str(ploidy), "-r", str(SEED),
        "-t", "2", "--score-not-qual", "--backend", "cpu", *extra,
    ]


def _outputs(prefix):
    contents = {}
    for name in (".txt", "_joint.txt", "_gibbs.txt.gz"):
        if os.path.exists(prefix + name):
            opener = gzip.open if name.endswith(".gz") else open
            with opener(prefix + name, "rb") as handle:
                contents[name] = handle.read()
    return contents


def _port(files, ploidy, prefix, extra, names, monkeypatch, compose):
    monkeypatch.setenv("RPVG_TPU_COMPOSE_OUT", "1" if compose else "0")
    try:
        rc, stats = cli.run_cli(_argv(files, ploidy, prefix, extra, names))
    finally:
        monkeypatch.delenv("RPVG_TPU_COMPOSE_OUT")
    assert rc == 0
    return _outputs(prefix), stats


@pytest.mark.parametrize(
    "name,ploidy,extra,fields,names", CLI_RUNS, ids=[run[0] for run in CLI_RUNS]
)
def test_staged_files_composed_byte_identical(
    name, ploidy, extra, fields, names, panel_files, tmp_path, monkeypatch
):
    composed, stats = _port(
        panel_files, ploidy, str(tmp_path / "composed"), extra, names, monkeypatch, True
    )
    counters = stats["counters"]
    results = [r.estimates for r in stats["results"]]
    viewed = [est for est in results if isinstance(est.path_group_sets, GroupSetViews)]
    silent = [est for est in results if len(est.path_group_sets) == 0]
    assert silent and all(len(est.paths) > 0 for est in silent)
    assert counters["combine.native_slots"] == len(viewed) == len(results) - len(silent)
    if "--ind-hap-inference" not in extra:
        assert counters["combine.native_slots"] == stats["scored_clusters"]
    assert counters["combine.sets"] == sum(len(est.path_group_sets) for est in viewed)
    rows = sum(composed[suffix].count(b"\n") - 2 for suffix in (".txt", "_joint.txt"))
    if names == "ascii":
        assert counters["outputs.composed_rows"] == rows > 100
    else:
        assert NON_ASCII.encode() in composed[".txt"]
        assert counters.get("outputs.composed_rows", 0) == 0
    assert ("_gibbs.txt.gz" in composed) == ("-n" in extra)

    objects, object_stats = _port(
        panel_files, ploidy, str(tmp_path / "objects"), extra, names, monkeypatch, False
    )
    assert object_stats["counters"].get("outputs.composed_rows", 0) == 0

    panel, info = _inputs(panel_files, names)
    monkeypatch.setenv("RPVG_TPU_FUSED_NESTED", "0")
    ref_prefix = str(tmp_path / "ref")
    ref_pipeline.run_pipeline(ref_pipeline.PipelineConfig(
        graph=panel_files["graph.json"], paths=panel, alignments=panel_files["aln.json"],
        output_prefix=ref_prefix, inference_model="haplotype-transcripts", ploidy=ploidy,
        path_info=info, rng_seed=SEED, score_not_qual=True, threads=2, **fields,
    ))
    reference = _outputs(ref_prefix)
    assert sorted(composed) == sorted(objects) == sorted(reference)
    for suffix in composed:
        assert composed[suffix] == objects[suffix], f"{suffix}: composer against objects"
        assert composed[suffix] == reference[suffix], f"{suffix}: against the JAX package"


def test_multihost_runner_writes_the_same_bytes_over_the_views(panel_files, tmp_path):
    """Two Gloo processes at ``-n 8``: each infers its clusters through the
    native phase E, and rank 0 writes the merged estimates with the object
    writers (no streams), the single process's composed bytes."""
    def config(prefix):
        return PipelineConfig(
            graph=panel_files["graph.json"], paths=panel_files["panel.json"],
            alignments=panel_files["aln.json"], output_prefix=prefix,
            inference_model="haplotype-transcripts", path_info=panel_files["info.tsv"],
            rng_seed=SEED, score_not_qual=True, num_gibbs_samples=8, threads=1,
        )

    base = str(tmp_path / "base")
    stats = run_pipeline(config(base), CPU)
    assert stats["counters"]["outputs.composed_rows"] > 0

    prefix = str(tmp_path / "dist")
    address = f"localhost:{_free_port()}"
    job = {"config": dataclasses.asdict(config(prefix)), "address": address, "n": 2,
           "timeout": WAIT_S}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _DIST_RUN, json.dumps({**job, "pid": pid})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=WAIT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for pid, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, err[-3000:]
        assert f"DIST_OK {pid}" in out
    got, want = _outputs(prefix), _outputs(base)
    assert sorted(got) == sorted(want) == [".txt", "_gibbs.txt.gz", "_joint.txt"]
    for suffix in want:
        assert got[suffix] == want[suffix], f"{suffix} differs"
