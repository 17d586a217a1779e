"""The port's span recorder (``rpvg_tpu_torch.spans``): self and total
times on an injected clock, a whole ``run_pipeline`` on a small ``.rpa``
(every span, the ``stats`` keys that read them), the profiler hook (off
without a session, the spans nested in a session's Chrome trace), the
bound on the kept runs, and no device wait of its own."""

import inspect
import itertools
import json
import os
import sys
import threading
from dataclasses import replace

import pytest
import torch

from rpvg_tpu_torch import alignments, sim, spans
from rpvg_tpu_torch.infer import batched_models
from rpvg_tpu_torch.io import rpa
from rpvg_tpu_torch.pipeline import PipelineConfig, run_pipeline
from rpvg_tpu_torch.testing import counted

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
STAGED = ("RPVG_TPU_FUSED_NESTED", "RPVG_TPU_FUSED_STRAINS", "RPVG_TPU_TORCH_PROFILE")

# Every span of a haplotype-transcripts pass on the staged route.
PASS_SPANS = (
    "rpvg.pass", "rpvg.load", "rpvg.finder", "rpvg.fragments", "rpvg.fragments.read",
    "rpvg.fragments.wait", "rpvg.fragments.project", "rpvg.fragments.dump",
    "rpvg.inference", "rpvg.refit", "rpvg.clusters", "rpvg.info_wait", "rpvg.matrices",
    "rpvg.subset_matrices", "rpvg.results", "rpvg.outputs", "rpvg.publish",
    "rpvg.phase.A", "rpvg.phase.B", "rpvg.phase.C", "rpvg.phase.D", "rpvg.phase.E", "rpvg.gc",
)


@pytest.fixture
def ticks(monkeypatch):
    """The spans' clock reads 0, 1, 2, ... in turn."""
    counter = itertools.count()
    monkeypatch.setattr(spans, "clock", lambda: float(next(counter)))


def test_nested_spans_on_an_injected_clock(ticks):
    with spans.RunSpan("root") as root:                  # 0
        run = spans.current_run()
        with spans.Span("a"):                        # 1
            with spans.Span("b"):                    # 2
                pass                                 # 3

            def reader():
                # Roots of their own thread, recorded in the run.
                assert spans.current_run() is None
                assert list(spans.each("read", [10, 20], run)) == [10, 20]  # 4-5, 6-7, 8

            thread = threading.Thread(target=reader)
            thread.start()
            thread.join()
            spans.count("blocks", 2)
        with spans.Span("b"):                        # 10
            pass                                     # 11
    assert root.seconds == 12.0                      # ends at 12
    summary = run.summary()
    assert summary["spans"] == {
        "b": {"total_s": 2.0, "self_s": 2.0, "count": 2},
        "read": {"total_s": 2.0, "self_s": 2.0, "count": 2},
        "a": {"total_s": 8.0, "self_s": 7.0, "count": 1},
        "root": {"total_s": 12.0, "self_s": 3.0, "count": 1},
    }
    assert summary["counters"] == {"blocks": 2}
    assert spans.recent_runs(1) == [summary]
    assert spans.current_run() is None


def test_a_phase_clock_names_each_phase_at_its_lap(ticks):
    with spans.RunSpan("root") as root:                  # 0
        clock = batched_models._PhaseClock(CPU)      # 1
        with spans.Span("inner"):                    # 2
            pass                                     # 3
        clock.lap("A", "first")                      # 4
        clock.lap("B", "second", sync=False)         # 5
        clock.lap("A", "again")                      # 6
        report = clock.report()
    found = root.run.summary()["spans"]
    assert report["phase_seconds"] == {"A": 4.0, "B": 1.0}
    assert found["rpvg.phase.A"] == {"total_s": 4.0, "self_s": 3.0, "count": 2}
    assert found["rpvg.phase.B"] == {"total_s": 1.0, "self_s": 1.0, "count": 1}
    # The time after the last lap is the root's own.
    assert found["root"]["self_s"] == root.seconds - 5.0


def test_threads_recording_into_one_run_lose_no_update():
    """More threads than cores record spans and counters into one run at
    a shortened switch interval: every entry and every count arrives."""
    workers, steps = (os.cpu_count() or 1) + 4, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.RunSpan("root") as root:
            run = spans.current_run()

            def work(i):
                for _ in spans.each("shared", range(steps), run):
                    run.count("items", 1)
                for _ in spans.each(f"own{i}", range(steps), run):
                    pass

            threads = [threading.Thread(target=work, args=(i,)) for i in range(workers)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=60)
                assert not thread.is_alive()
    finally:
        sys.setswitchinterval(interval)
    summary = root.run.summary()
    assert summary["spans"]["shared"]["count"] == workers * steps
    assert all(summary["spans"][f"own{i}"]["count"] == steps for i in range(workers))
    assert summary["counters"] == {"items": workers * steps}


def test_recent_runs_keep_the_last_64():
    for i in range(spans.KEEP_RUNS + 6):
        with spans.RunSpan(f"run{i}"):
            pass
    kept = spans.recent_runs(1000)
    assert len(kept) == spans.KEEP_RUNS == 64
    assert list(kept[-1]["spans"]) == [f"run{spans.KEEP_RUNS + 5}"]
    assert list(kept[0]["spans"]) == ["run6"]
    assert spans.recent_runs(0) == []


def test_counted_reads_its_own_run_and_refuses_an_open_one():
    """``testing.counted`` gives the block's own counters, 0 for one it
    never added to, and raises inside a run already open, whose counters
    it would otherwise read."""
    with spans.RunSpan("outer"):
        spans.count("before", 3)
        with pytest.raises(RuntimeError, match="open run"):
            with counted():
                pass
    with counted() as counts:
        spans.count("items", 2)
    assert counts == {"items": 2} and counts["before"] == 0
    assert spans.recent_runs(2)[0]["counters"] == {"before": 3}


# ------------------------------------------------- run_pipeline, end to end


@pytest.fixture(scope="module")
def small_rpa(tmp_path_factory):
    """20 genes x 4 isoforms x 4 haplotypes and 1,000 multipath read
    pairs as ``.rpa``, with the run's configuration."""
    work = tmp_path_factory.mktemp("spans_panel")
    panel = sim.build_gene_panel(
        num_genes=20, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=120, variant_sites=3, seed=5,
    )
    records, _ = sim.simulate_read_pairs(
        panel, 1000, read_length=100, frag_mean=250, frag_sd=25, seed=17,
        abundances=sim.gene_abundances(panel, seed=7), multipath_dag=True,
    )
    parsed = [alignments.parse_multipath_alignment(r) for r in records]
    files = {name: str(work / name) for name in ("graph.json", "panel.json", "info.tsv", "aln.rpa")}
    rpa.write_fragments(
        files["aln.rpa"], list(zip(parsed[0::2], parsed[1::2])),
        is_multipath=True, is_paired=True, frag_mean=250.0, frag_sd=25.0,
    )
    panel.write_graph_json(files["graph.json"])
    panel.write_panel_json(files["panel.json"])
    panel.write_info_tsv(files["info.tsv"])
    return PipelineConfig(
        graph=files["graph.json"], paths=files["panel.json"], alignments=files["aln.rpa"],
        inference_model="haplotype-transcripts", path_info=files["info.tsv"], threads=2,
        rng_seed=42, score_not_qual=True,
    )


@pytest.fixture
def staged(monkeypatch):
    for variable in STAGED:
        monkeypatch.delenv(variable, raising=False)


def _run(config, prefix):
    return run_pipeline(replace(config, output_prefix=str(prefix)), CPU)


@pytest.mark.parametrize("extra", [{}, {"num_gibbs_samples": 4, "write_probs": True}],
                         ids=["plain", "gibbs-probs"])
def test_pass_records_every_span_and_its_stats_read_them(small_rpa, staged, tmp_path, extra):
    stats = _run(replace(small_rpa, **extra), tmp_path / "out")
    found = stats["spans"]
    expected = PASS_SPANS + (("rpvg.phase.D2", "rpvg.gibbs_rows", "rpvg.gibbs_join") if extra else ())
    assert set(expected) <= set(found)
    assert all(name.startswith("rpvg.") for name in found)
    total = lambda name: found[name]["total_s"]  # noqa: E731
    assert stats["fragment_pass_seconds"] == total("rpvg.fragments")
    assert stats["matrix_seconds"] == total("rpvg.matrices")
    assert stats["output_seconds"] == total("rpvg.outputs")
    assert stats["wall_seconds"] == total("rpvg.pass")
    assert stats["phase_seconds"]
    for key, seconds in stats["phase_seconds"].items():
        assert seconds == total(f"rpvg.phase.{key}")
    if extra:
        assert stats["gibbs_writer_seconds"] == total("rpvg.gibbs_rows")
        assert stats["gibbs_writer_join_seconds"] == total("rpvg.gibbs_join")
    for name, entry in found.items():
        assert 0.0 <= entry["self_s"] <= entry["total_s"] + 1e-12, name
    assert found["rpvg.pass"]["count"] == found["rpvg.inference"]["count"] == 1
    # One native call reads and projects every block (the flat pass): the
    # reader's and the workers' clocks are recorded once a pass.
    assert stats["counters"]["fragments.flat_pass"] == 1
    for name in ("read", "wait", "project", "dump"):
        assert found[f"rpvg.fragments.{name}"]["count"] == 1, name
    reader = rpa.RpaReader(small_rpa.alignments)
    payloads = list(reader.blocks())
    reader.close()
    assert stats["counters"]["fragments.blocks"] == len(payloads) >= 1
    assert stats["counters"]["fragments.bytes"] == sum(map(len, payloads))
    # Loose on purpose: a tiny run's fixed costs must not flake it.
    unspanned = found["rpvg.pass"]["self_s"] + found["rpvg.inference"]["self_s"]
    assert unspanned < 0.2 * stats["wall_seconds"]
    assert spans.recent_runs(1)[0] == {"spans": found, "counters": stats["counters"]}


class RefusedRecord:
    def __init__(self, *args, **kwargs):
        raise AssertionError("record_function opened without a profiler session")


def _estimates(prefix):
    out = {}
    for suffix in (".txt", "_joint.txt"):
        with open(str(prefix) + suffix, "rb") as handle:
            out[suffix] = handle.read()
    return out


def test_spans_open_no_record_function_without_a_session(small_rpa, staged, tmp_path,
                                                          monkeypatch):
    with monkeypatch.context() as patch:
        patch.setattr(torch.profiler, "record_function", RefusedRecord)
        _run(small_rpa, tmp_path / "plain")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _run(small_rpa, tmp_path / "profiled")
    assert _estimates(tmp_path / "plain") == _estimates(tmp_path / "profiled")


def test_spans_nest_in_a_profiler_trace(small_rpa, staged, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    # A session records the thread that started it unless told to record
    # every thread.
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as session:
        stats = _run(small_rpa, tmp_path / "out")
    trace = str(tmp_path / "trace.json")
    session.export_chrome_trace(trace)
    with open(trace) as handle:
        events = [
            e for e in json.load(handle)["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("rpvg.")
        ]
    by_name = {}
    for event in events:
        by_name.setdefault(event["name"], []).append(event)
    # A phase is named by the lap that ends it, so the trace has its
    # open name.
    names = {n if not n.startswith("rpvg.phase.") else "rpvg.phase" for n in stats["spans"]}
    # The flat fragment pass's read and wait come from its native clocks,
    # with no interval of their own in the trace.
    native_clocks = {"rpvg.fragments.read", "rpvg.fragments.wait"}
    assert native_clocks <= names
    assert set(by_name) == names - native_clocks
    # One a lap (five on this route), and the clock's tail after its last.
    assert len(by_name["rpvg.phase"]) == len(stats["phase_seconds"]) + 1 == 6

    def inside(child, parent):
        return (
            child["tid"] == parent["tid"]
            and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
        )

    def parent_of(event):
        holders = [p for p in events if p is not event and inside(event, p)]
        return min(holders, key=lambda p: p["dur"])["name"] if holders else None

    assert len(by_name["rpvg.pass"]) == 1
    for child, parent in [
        ("rpvg.load", "rpvg.pass"), ("rpvg.finder", "rpvg.pass"),
        ("rpvg.fragments", "rpvg.pass"),
        ("rpvg.fragments.project", "rpvg.fragments"), ("rpvg.fragments.dump", "rpvg.fragments"),
        ("rpvg.inference", "rpvg.pass"), ("rpvg.refit", "rpvg.inference"),
        ("rpvg.clusters", "rpvg.inference"), ("rpvg.info_wait", "rpvg.inference"),
        ("rpvg.matrices", "rpvg.inference"), ("rpvg.results", "rpvg.inference"),
        ("rpvg.phase", "rpvg.inference"), ("rpvg.subset_matrices", "rpvg.phase"),
        ("rpvg.outputs", "rpvg.inference"), ("rpvg.publish", "rpvg.inference"),
        ("rpvg.gc", "rpvg.pass"),
    ]:
        for event in by_name[child]:
            assert parent_of(event) == parent, (child, parent)


def test_only_the_phase_clock_waits_for_the_device(small_rpa, staged, tmp_path, monkeypatch):
    callers, synced_laps = [], []

    def counted(device):
        callers.append(sys._getframe(1).f_code.co_name)

    def refused(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize called")

    lap = batched_models._PhaseClock.lap

    def counted_lap(self, key, label, sync=True):
        synced_laps.append(sync)
        return lap(self, key, label, sync)

    monkeypatch.setattr(batched_models, "synchronize", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    monkeypatch.setattr(batched_models._PhaseClock, "lap", counted_lap)
    _run(small_rpa, tmp_path / "out")
    assert set(callers) == {"lap"}
    assert len(callers) == sum(synced_laps) >= 5
    assert "synchronize" not in inspect.getsource(spans)
