"""Fixtures of the benchmark's own tests: the small cells under
``data/`` (40 genes, 3,000 read pairs) run on the CPU, with the inputs
cached in a temporary directory."""

import os
import sys
import time

import pytest

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope="session")
def input_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_port_cache"))


@pytest.fixture
def small_cell(input_cache, monkeypatch):
    """run(workload, seed, seconds=1.0, traced=False): one run of a small
    cell on the CPU through the harness, its result object."""
    import torch

    from bench_port import harness, inputs

    monkeypatch.setattr(inputs, "CACHE_DIR", input_cache)
    monkeypatch.setattr(torch, "get_num_threads", torch.get_num_threads)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bench = harness.load_json(os.path.join(DATA, "BENCHMARK.json"))

    def run(workload, seed=11, seconds=1.0, traced=False):
        cell = harness.find_cell(workload, bench, DATA)
        return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                                time.perf_counter(), harness.metric_names(bench, workload, traced),
                                workers=2)

    yield run
    torch.set_num_threads(threads)
