"""``gc_s`` on a synthetic record: the per-pass mean of the self seconds
of ``rpvg.gc`` (the end-of-pass collection) over the program's recent
runs, and None where a run lacks it, where there are no runs, and for a
program without spans."""

import sys

import pytest

from bench_port import harness
from bench_port.metrics import gc_s
from bench_port.tests.test_span_metrics import recent, record  # noqa: F401


def run_with(collection_s=None):
    spans = {"rpvg.pass": {"total_s": 2.0, "self_s": 0.5, "count": 1}}
    if collection_s is not None:
        spans["rpvg.gc"] = {"total_s": collection_s, "self_s": collection_s, "count": 1}
    return {"spans": spans, "counters": {}}


def test_gc_s_means_the_window_runs(recent):
    # An older run outside the window is left out.
    recent([run_with(100.0), run_with(0.01), run_with(0.03)])
    assert gc_s.read(record(2)) == pytest.approx(0.02)
    assert recent.asked == [2]


@pytest.mark.parametrize("runs", [[run_with(0.01), run_with()], []], ids=["missing_span", "no_runs"])
def test_gc_s_gives_none_without_the_span(runs, recent):
    recent(runs)
    assert gc_s.read(record(2)) is None


def test_gc_s_gives_none_for_a_program_without_spans(monkeypatch):
    # An earlier program has no span recorder to import.
    import rpvg_tpu_torch

    monkeypatch.delattr(rpvg_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "rpvg_tpu_torch.spans", None)
    assert gc_s.read(record(2)) is None


def test_gc_s_is_declared_for_the_cell():
    entry = {m["name"]: m for m in harness.benchmark()["per_layer"]}["gc_s"]
    assert entry == {
        "name": "gc_s", "unit": "s", "better": "lower", "source": "program_span",
        "layer": "cyclic collector (pipeline.run_pipeline)", "moves": "pairs_per_s",
        "workloads": ["hst_diploid.sample100k"],
    }
