"""The plain reference against the port on the CPU, and the control: the
reference in float32 put in the program's place must come out not
correct under the same limits."""

import os

import numpy as np
import pytest

from bench_port import harness, inputs
from bench_port.reference import compare, haplotype_transcripts as ht
from bench_port.reference.fragment_pass import Workers
from bench_port.tests.conftest import DATA


@pytest.mark.parametrize("workload", ["tiny_diploid.sample3k", "tiny_tetraploid.sample3k"])
def test_port_matches_the_reference(small_cell, workload):
    result = small_cell(workload, seed=2**31 + 17)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    checks = result["checks"]
    # What is left is the files' 8 significant digits.
    assert checks["hap_prob_gap"]["value"] < 1e-8
    assert checks["read_count_gap"]["value"] < 1e-7


@pytest.mark.parametrize("workload", ["tiny_diploid.sample3k", "tiny_tetraploid.sample3k"])
def test_the_float32_control_is_not_correct(input_cache, monkeypatch, tmp_path, workload):
    monkeypatch.setattr(inputs, "CACHE_DIR", input_cache)
    bench = harness.load_json(os.path.join(DATA, "BENCHMARK.json"))
    cell = harness.find_cell(workload, bench, DATA)
    files = inputs.prepare(cell.config, cell.traffic, 2**31 + 19)
    ploidy = cell.config["run"]["ploidy"]
    with Workers(files, cell.config["run"], 2) as pool:
        clusters = ht.cluster(files, pool)
        want = ht.expected(clusters, cell.config["run"], pool)
        control = ht.expected(clusters, cell.config["run"], pool, np.float32)
    prefix = str(tmp_path / "control")
    compare.write_estimates(control, prefix, ploidy)
    ok, checks = compare.judge(compare.compare(prefix, want, ploidy), cell.limits)
    assert not ok, checks
    # The reference in its own place is correct.
    compare.write_estimates(want, prefix, ploidy)
    ok, checks = compare.judge(compare.compare(prefix, want, ploidy), cell.limits)
    assert ok, checks
