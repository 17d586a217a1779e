"""The per-transcript cell (``--ind-hap-inference``): the port on the CPU
against :mod:`bench_port.reference.haplotype_transcripts_independent`
within the small cell's limits, the float32 control and a run drawing
from another cluster's stream both not correct, the reference's stream
contract, its imports, the three new metric readers on fabricated
records, and the entries the benchmark declares for the cell."""

import os
import sys
import time

import numpy as np
import pytest

from bench_port import harness, inputs
from bench_port.metrics import em_host_s, indhap_jobs_s, indhap_sample_s
from bench_port.reference import compare, haplotype_transcripts_independent as hi
from bench_port.reference.fragment_pass import Workers
from bench_port.tests.conftest import DATA
from bench_port.tests.test_imports import _run
from bench_port.tests.test_span_metrics import recent, record  # noqa: F401

WORKLOAD = "tiny_indhap.sample3k"
CELL = "hst_indhap.sample100k"


def small_bench():
    """The small cells' benchmark with the per-transcript cell added."""
    bench = harness.load_json(os.path.join(DATA, "BENCHMARK.json"))
    bench["workloads"].append({"name": WORKLOAD, "config": "tiny_indhap",
                               "traffic": "sample3k", "chips": 1})
    return bench


@pytest.fixture
def indhap_cell(input_cache, monkeypatch):
    """run(seed): one run of the small per-transcript cell on the CPU
    through the harness, its result object."""
    import torch

    monkeypatch.setattr(inputs, "CACHE_DIR", input_cache)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bench = small_bench()
    cell = harness.find_cell(WORKLOAD, bench, DATA)

    def run(seed, traced=False):
        return harness.run_cell(cell, seed, 0.5, traced, torch.device("cpu"), time.perf_counter(),
                                harness.metric_names(bench, WORKLOAD, traced), workers=2)

    yield run
    torch.set_num_threads(threads)


def test_port_matches_the_reference(indhap_cell):
    result = indhap_cell(2**31 + 17)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    checks = result["checks"]
    # Every pick agrees: no haplotype probability is off by a draw's mass.
    assert checks["rows_differ"]["value"] == 0
    assert checks["hap_prob_gap"]["value"] < 1e-8
    assert checks["read_count_gap"]["value"] < 1e-6


def test_a_pass_drawing_another_cluster_s_stream_is_not_correct(indhap_cell, monkeypatch):
    """The port's numpy stream of each cluster keyed one rank off: every
    pick is drawn from the wrong uniforms."""
    from rpvg_tpu_torch.infer import batched_models

    original = batched_models._sample_subsets

    def shifted(estimator, cluster_data, cluster_groups, jobs, results, rng_seed, rank_of):
        return original(estimator, cluster_data, cluster_groups, jobs, results, rng_seed,
                        lambda ci: rank_of(ci) + 1)

    monkeypatch.setattr(batched_models, "_sample_subsets", shifted)
    result = indhap_cell(2**31 + 23)
    assert not result["correct"]
    assert result["checks"]["hap_prob_gap"]["value"] >= 1e-3 - 1e-12
    assert result["checks"]["rows_differ"]["value"] == 0


def test_the_float32_control_is_not_correct(input_cache, monkeypatch, tmp_path):
    monkeypatch.setattr(inputs, "CACHE_DIR", input_cache)
    cell = harness.find_cell(WORKLOAD, small_bench(), DATA)
    files = inputs.prepare(cell.config, cell.traffic, 2**31 + 19)
    with Workers(files, cell.config["run"], 2) as pool:
        clusters = hi.cluster(files, pool)
        want = hi.expected(clusters, cell.config["run"], pool)
        control = hi.expected(clusters, cell.config["run"], pool, np.float32)
    assert want.em_tasks > want.clusters
    prefix = str(tmp_path / "control")
    compare.write_estimates(control, prefix, 2)
    ok, checks = compare.judge(compare.compare(prefix, want, 2), cell.limits)
    assert not ok, checks
    # The reference in its own place is correct.
    compare.write_estimates(want, prefix, 2)
    ok, checks = compare.judge(compare.compare(prefix, want, 2), cell.limits)
    assert ok, checks


def test_subsets_follow_the_stream_contract():
    """Two jobs: draw s picks, per job, the first multiset whose cumulative
    posterior exceeds uniform s of its row; distinct subsets in the order
    first drawn, each 1/draws added once per draw."""
    job_sets = [[[0, 0], [0, 1], [1, 1]], [[2, 3]]]
    job_posteriors = [np.array([0.2, 0.5, 0.3]), np.array([1.0])]
    masses = hi.sample_subsets(42, 7, job_sets, job_posteriors, 50)
    uniforms = np.random.default_rng((42, 7)).random((2, 50))
    want = {}
    for u in uniforms[0]:
        pick = 0 if u < 0.2 else (1 if u < 0.7 else 2)
        key = tuple(sorted(job_sets[0][pick] + [2, 3]))
        want[key] = want.get(key, 0.0) + 1 / 50
    assert list(masses) == list(want)
    assert masses == pytest.approx(want, abs=0) and sum(masses.values()) == pytest.approx(1.0)
    assert hi.sample_subsets(42, 8, job_sets, job_posteriors, 50) != masses


def test_transcript_jobs_keep_first_seen_order():
    class P:
        def __init__(self, group_id):
            self.group_id = group_id

    assert hi.transcript_jobs([P(5), P(2), P(5), P(9), P(2)]) == [[0, 2], [1, 4], [3]]


def test_reference_loads_neither_jax_nor_the_port_nor_the_generator(tmp_path):
    loaded = _run("""
        import json, os
        from bench_port.reference import haplotype_transcripts_independent as hi
        from bench_port.reference.fragment_pass import Workers
        frozen = sorted(m for m in sys.modules if m.startswith("bench_port.frozen"))
        assert not frozen, frozen
        from bench_port import inputs  # the generator, for the inputs alone
        inputs.CACHE_DIR = sys.argv[4]
        config = json.load(open(os.path.join(sys.argv[3], "configs", "tiny_indhap.json")))
        traffic = json.load(open(os.path.join(sys.argv[3], "traffic", "sample3k.json")))
        traffic["reads"]["pairs"] = 300
        files = inputs.prepare(config, traffic, 3)
        if __name__ == "__main__":
            with Workers(files, config["run"], 1) as pool:
                rows = hi.expected(hi.cluster(files, pool), config["run"], pool)
            assert rows.paths and rows.em_tasks
    """, ["jax", "jaxlib", "flax", "rpvg_tpu", "rpvg_tpu_torch"], DATA, str(tmp_path))
    assert not loaded & {"jax", "jaxlib", "flax", "rpvg_tpu", "rpvg_tpu_torch", "torch"}


def _phases(**seconds):
    return {"phase_seconds": dict(seconds)}


def test_phase_readers_mean_the_passes():
    rec = record(2)
    rec.passes = [_phases(I1=1.0, I2=2.0, I3=0.5, C=9.0), _phases(I1=3.0, I2=4.0, I3=1.5)]
    assert indhap_jobs_s.read(rec) == pytest.approx(5.0)
    assert indhap_sample_s.read(rec) == pytest.approx(1.0)


@pytest.mark.parametrize("passes", [[_phases(A=1.0, B=2.0, C=3.0)],
                                    [_phases(I1=1.0, I2=1.0, I3=1.0), _phases(A=1.0)], []],
                         ids=["collapsed", "one_pass_without", "no_passes"])
def test_phase_readers_give_none_without_the_route(passes):
    rec = record(len(passes))
    rec.passes = passes
    assert indhap_jobs_s.read(rec) is None and indhap_sample_s.read(rec) is None


def _em_run(pack=None, fold=None):
    found = {"rpvg.em.launch": {"total_s": 1.0, "self_s": 0.9, "count": 1}}
    if pack is not None:
        found["rpvg.em.pack"] = {"total_s": pack, "self_s": pack, "count": 1}
    if fold is not None:
        found["rpvg.em.fold"] = {"total_s": fold, "self_s": fold, "count": 1}
    return {"spans": found, "counters": {}}


def test_em_host_s_means_pack_and_fold(recent):  # noqa: F811
    # An older run outside the window is left out.
    recent([_em_run(50.0, 50.0), _em_run(0.1, 0.2), _em_run(0.3, 0.4)])
    assert em_host_s.read(record(2)) == pytest.approx(0.5)
    assert recent.asked == [2]


@pytest.mark.parametrize("runs", [[_em_run(0.1, 0.2), _em_run()], [_em_run(fold=0.2)] * 2, []],
                         ids=["missing_spans", "missing_pack", "no_runs"])
def test_em_host_s_gives_none_without_its_spans(runs, recent):  # noqa: F811
    recent(runs)
    assert em_host_s.read(record(2)) is None


def test_em_host_s_gives_none_for_a_program_without_spans(monkeypatch):
    import rpvg_tpu_torch

    monkeypatch.delattr(rpvg_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "rpvg_tpu_torch.spans", None)
    assert em_host_s.read(record(2)) is None


def test_the_cell_and_its_metrics_are_declared():
    bench = harness.benchmark()
    config = {c["name"]: c for c in bench["configs"]}["hst_indhap"]
    assert config["file"] == "bench_port/configs/hst_indhap.json" and config["reduced"] == []
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hst_indhap", "sample100k", 1)
    found = harness.find_cell(CELL, bench)
    assert found.config["reference"] == "haplotype_transcripts_independent"
    assert found.config["run"]["options"] == {"ind_hap_inference": True}
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("indhap_jobs_s", "indhap_sample_s", "em_host_s"):
        entry = per_layer[name]
        assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
            "s", "lower", "program_span", "pairs_per_s")
        assert CELL in entry["workloads"]
    assert "hst_diploid.sample100k" in per_layer["em_host_s"]["workloads"]
    assert "hst_tetraploid.sample100k" in per_layer["em_host_s"]["workloads"]
    for name in ("load_s", "fragment_s", "matrix_s", "host_phases_s", "em_s", "output_s",
                 "em_kernel_roofline", "device_busy_share"):
        assert CELL in per_layer[name]["workloads"], name
    for name in ("posteriors_s", "group_scores_s", "group_finish_s", "group_scores_roofline",
                 "fragment_wait_s", "gc_s"):
        assert CELL not in per_layer[name]["workloads"], name
    traced = [name for name, _ in harness.metric_names(bench, CELL, True)]
    assert {"indhap_jobs_s", "indhap_sample_s", "em_host_s", "em_kernel_roofline"} <= set(traced)
