"""The readers of the program's spans on a synthetic record: per-pass
means of self seconds over the program's recent runs, and None where a
run lacks the span."""

import importlib
import sys

import pytest

from bench_port import harness
from rpvg_tpu_torch import spans

# metric: the spans whose self seconds it sums
READS = {
    "fragment_wait_s": ("rpvg.fragments.wait",),
    "fragment_dump_s": ("rpvg.fragments.dump",),
    "refit_s": ("rpvg.refit",),
    "cluster_s": ("rpvg.clusters",),
    "info_wait_s": ("rpvg.info_wait",),
    "unspanned_s": ("rpvg.pass", "rpvg.inference"),
}
SPAN_NAMES = sorted({name for names in READS.values() for name in names})


def fake_run(scale):
    """Every span with self seconds scale x (its rank + 1), total twice that."""
    return {
        "spans": {
            name: {"total_s": 2.0 * scale * (i + 1), "self_s": scale * (i + 1), "count": 1}
            for i, name in enumerate(SPAN_NAMES)
        },
        "counters": {},
    }


def record(passes):
    return harness.Record(setup_s=1.0, load_s=0.5, window_s=3.0, pairs=passes * 1000,
                          passes=[{} for _ in range(passes)], window_peak_bytes=0)


@pytest.fixture
def recent(monkeypatch):
    """Put fabricated runs in place of the program's; returns the list of
    the sizes it was asked for."""
    asked = []

    def install(runs):
        def recent_runs(n):
            asked.append(n)
            return runs[-n:]

        monkeypatch.setattr(spans, "recent_runs", recent_runs)

    install.asked = asked
    return install


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_means_the_self_seconds_of_the_window_runs(metric, recent):
    # An older run outside the window is left out.
    recent([fake_run(100.0), fake_run(1.0), fake_run(3.0)])
    value = importlib.import_module(f"bench_port.metrics.{metric}").read(record(2))
    ranks = [SPAN_NAMES.index(name) + 1 for name in READS[metric]]
    assert value == pytest.approx((1.0 + 3.0) * sum(ranks) / 2)
    assert recent.asked == [2]


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_gives_none_when_a_span_is_missing(metric, recent):
    runs = [fake_run(1.0), fake_run(2.0)]
    del runs[1]["spans"][READS[metric][-1]]
    recent(runs)
    assert importlib.import_module(f"bench_port.metrics.{metric}").read(record(2)) is None


def test_reader_gives_none_without_runs(recent):
    recent([])
    assert importlib.import_module("bench_port.metrics.refit_s").read(record(3)) is None


def test_new_metrics_are_declared_for_the_cell():
    declared = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for metric in READS:
        entry = declared[metric]
        assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
            "s", "lower", "program_span", "pairs_per_s")
        assert entry["workloads"] == ["hst_diploid.sample100k"]


def test_reader_gives_none_for_a_program_without_spans(monkeypatch):
    # An earlier program has no span recorder to import.
    import rpvg_tpu_torch

    monkeypatch.delattr(rpvg_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "rpvg_tpu_torch.spans", None)
    for metric in READS:
        assert importlib.import_module(f"bench_port.metrics.{metric}").read(record(2)) is None
