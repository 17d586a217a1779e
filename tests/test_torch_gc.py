"""The cyclic collector around a pass (``pipeline._collector_held``) and
its span (``rpvg.gc``): automatic collections are held for the pass and
one collection of the young generations at its end frees what the pass
and its caller left there, without a full collection; the caller's
arrangement of the collector (disabled, or objects frozen) is kept, also
when the pass raises."""

import gc
import weakref
from dataclasses import replace

import pytest
import torch

from rpvg_tpu_torch import pipeline, spans

from test_torch_slice import one_torch_thread  # noqa: F401
from test_torch_spans import small_rpa, staged  # noqa: F401

CPU = torch.device("cpu")


class Cyclic:
    pass


def _cycle(finalised):
    """A reference cycle, unreachable once the caller drops it, that
    appends True to ``finalised`` when the collector frees it."""
    holder = Cyclic()
    holder.cycle = {"holder": holder}
    weakref.finalize(holder, finalised.append, True)


def _run(config, prefix):
    return pipeline.run_pipeline(replace(config, output_prefix=str(prefix)), CPU)


def _full_collections():
    return gc.get_stats()[2]["collections"]


@pytest.fixture
def collector():
    """The collector enabled or disabled as the test found it, after."""
    enabled = gc.isenabled()
    yield
    (gc.enable if enabled else gc.disable)()


@pytest.fixture
def inside(monkeypatch):
    """Wraps the pass's outputs: the collector's state they ran under,
    and a reference cycle dropped there with a finaliser on it."""
    seen = {"finalised": []}
    write_outputs = pipeline.write_outputs

    def wrapped(*args, **kwargs):
        seen["enabled"], seen["frozen"] = gc.isenabled(), gc.get_freeze_count()
        _cycle(seen["finalised"])
        out = write_outputs(*args, **kwargs)
        seen["alive_after_layer"] = not seen["finalised"]
        return out

    monkeypatch.setattr(pipeline, "write_outputs", wrapped)
    return seen


def test_a_pass_holds_the_collector_and_frees_its_cycles_at_its_end(
        small_rpa, staged, tmp_path, collector, inside):
    gc.enable()
    frozen, full = gc.get_freeze_count(), _full_collections()
    stats = _run(small_rpa, tmp_path / "out")
    assert inside["enabled"] is False and inside["frozen"] == frozen
    # Held through the rest of the pass, freed by the end's collection.
    assert inside["alive_after_layer"]
    assert inside["finalised"] == [True]
    assert gc.isenabled() and gc.get_freeze_count() == frozen
    assert _full_collections() == full
    assert stats["spans"]["rpvg.gc"]["count"] == 1
    assert stats["counters"]["gc.collected"] >= 2
    # The end's collection is timed inside the pass, under no layer.
    found = stats["spans"]
    assert found["rpvg.gc"]["total_s"] <= found["rpvg.pass"]["total_s"] - found["rpvg.pass"]["self_s"]


def test_a_pass_that_raises_leaves_the_collector_as_it_found_it(
        small_rpa, staged, tmp_path, collector):
    gc.enable()
    frozen = gc.get_freeze_count()
    missing = replace(small_rpa, alignments=str(tmp_path / "missing.rpa"))
    with pytest.raises(OSError):
        _run(missing, tmp_path / "out")
    assert gc.isenabled() and gc.get_freeze_count() == frozen
    assert spans.recent_runs(1)[0]["spans"]["rpvg.gc"]["count"] == 1


def test_a_caller_that_disabled_the_collector_keeps_it(
        small_rpa, staged, tmp_path, collector, inside):
    gc.disable()
    frozen = gc.get_freeze_count()
    stats = _run(small_rpa, tmp_path / "out")
    assert (inside["enabled"], inside["frozen"]) == (False, frozen)
    assert not gc.isenabled() and gc.get_freeze_count() == frozen
    assert "rpvg.gc" not in stats["spans"] and "gc.collected" not in stats["counters"]
    assert inside["finalised"] == []
    gc.collect()
    assert inside["finalised"] == [True]


def test_a_caller_that_froze_objects_keeps_them_frozen(
        small_rpa, staged, tmp_path, collector, inside):
    gc.enable()
    gc.freeze()
    try:
        frozen = gc.get_freeze_count()
        stats = _run(small_rpa, tmp_path / "out")
        # Neither frozen further nor thawed (a few frozen objects die of
        # their reference counts); the pass's own collection still runs.
        assert inside["enabled"] is False and frozen - 100 < inside["frozen"] <= frozen
        assert gc.isenabled() and frozen - 100 < gc.get_freeze_count() <= frozen
        assert inside["finalised"] == [True]
        assert stats["spans"]["rpvg.gc"]["count"] == 1
    finally:
        gc.unfreeze()


def test_a_cycle_dropped_between_passes_is_freed_by_the_next(
        small_rpa, staged, tmp_path, collector):
    gc.enable()
    _run(small_rpa, tmp_path / "out0")
    finalised = []
    _cycle(finalised)
    # Too few allocations since the first pass for an automatic collection.
    assert finalised == []
    _run(small_rpa, tmp_path / "out1")
    assert finalised == [True]


def test_five_passes_leave_the_tracked_objects_flat(small_rpa, staged, tmp_path, collector):
    gc.enable()
    counts = []
    for i in range(5):
        _run(small_rpa, tmp_path / f"out{i}")
        counts.append(len(gc.get_objects()))
    assert abs(counts[-1] - counts[0]) < 1000, counts


def test_the_estimates_a_pass_returns_hold_no_cycle(small_rpa, staged, tmp_path, collector):
    """What a caller drops after the end's collection is freed by its
    reference counts: none of it waits for a full collection."""
    gc.enable()
    stats = _run(small_rpa, tmp_path / "out")
    assert stats["results"]
    gc.collect()
    gc.disable()
    del stats
    assert gc.collect() == 0
