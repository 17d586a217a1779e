"""The harness finds every configuration, traffic mix, limit file and
metric reader by the names in BENCHMARK.json."""

import importlib
import json
import os

import pytest

from bench_port import harness

ROOT = harness.ROOT


def test_every_cell_of_the_benchmark_is_found_by_name():
    bench = harness.benchmark()
    for workload in bench["workloads"]:
        cell = harness.find_cell(workload["name"], bench)
        assert cell.config["name"] == workload["config"]
        assert cell.traffic["name"] == workload["traffic"]
        assert cell.chips == workload["chips"]
        assert set(cell.limits) == {"rows_differ", "hap_prob_gap", "read_count_gap", "tpm_gap"}
        importlib.import_module(f"bench_port.reference.{cell.config['reference']}")


def test_config_files_are_the_benchmark_s():
    bench = harness.benchmark()
    for config in bench["configs"]:
        with open(os.path.join(ROOT, config["file"])) as handle:
            data = json.load(handle)
        assert data["name"] == config["name"]
        assert data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]


def test_every_metric_has_a_reader():
    bench = harness.benchmark()
    for metric in bench["end_to_end"] + bench["per_layer"]:
        module = importlib.import_module(f"bench_port.metrics.{metric['name']}")
        assert callable(module.read)


def test_metrics_follow_the_trace_switch():
    bench = harness.benchmark()
    untraced = [name for name, _ in harness.metric_names(bench, "hst_diploid.sample100k", False)]
    traced = [name for name, _ in harness.metric_names(bench, "hst_diploid.sample100k", True)]
    assert untraced == ["pairs_per_s", "peak_device_mib", "setup_s"]
    assert "device_busy_share" in traced and "pairs_per_s" not in traced


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("hst_diploid.no_such_traffic")
