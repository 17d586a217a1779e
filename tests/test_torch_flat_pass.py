"""The `.rpa` fragment pass in one native call
(``rpvg_tpu_torch/fragment_pass.py``, ``csrc/host/fragment_pass.cpp``)
against ``pipeline.collect_fragments``, the route every other pass
takes: the same column buffer byte for byte at 1, 2, 4 and 8 threads on
paired multipath, quality-scored, single-end, single-path and partly
unaligned libraries in blocks of uneven size; the reader's errors; the
spans and counters of a run; and which runs take the route."""

import re
import struct
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch

from rpvg_tpu_torch import alignments, fragment_pass, native, sim, spans
from rpvg_tpu_torch.io import rpa
from rpvg_tpu_torch.parallel import multihost
from rpvg_tpu_torch.pipeline import (
    ColumnarFragmentIndex,
    PipelineConfig,
    PipelineInputError,
    build_finder,
    collect_fragments,
    collect_fragments_flat,
    load_inputs,
    resolve_pre_fragment_dist,
    run_pipeline,
)

from test_torch_slice import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
BLOCKS = (97, 250, 13, 400, 1)  # fragments per block, in turn


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """20 genes x 4 isoforms x 4 haplotypes, as graph and panel JSON."""
    work = tmp_path_factory.mktemp("flat_panel")
    panel = sim.build_gene_panel(
        num_genes=20, isoforms_per_gene=4, num_haplotypes=4,
        exons_per_gene=6, exon_length=120, variant_sites=3, seed=5,
    )
    files = {"graph": str(work / "graph.json"), "paths": str(work / "panel.json")}
    panel.write_graph_json(files["graph"])
    panel.write_panel_json(files["paths"])
    return work, panel, files


def _unalign(aln, how):
    """A record the finder cannot place: no path at all, or a first node
    that is not in the graph."""
    if how == "empty":
        if isinstance(aln, alignments.MultipathAlignment):
            return replace(aln, subpaths=[], start=[])
        return replace(aln, path=None)
    if isinstance(aln, alignments.MultipathAlignment):
        first = aln.subpaths[aln.start[0]]
        path = replace(first.path, mappings=[replace(first.path.mappings[0], node_id=10**6)]
                       + list(first.path.mappings[1:]))
        subpaths = list(aln.subpaths)
        subpaths[aln.start[0]] = replace(first, path=path)
        return replace(aln, subpaths=subpaths)
    mappings = [replace(aln.path.mappings[0], node_id=10**6)] + list(aln.path.mappings[1:])
    return replace(aln, path=replace(aln.path, mappings=mappings))


def _library(kind, panel):
    """(fragments, is_multipath, is_paired, configuration changes)."""
    abundances = sim.gene_abundances(panel, seed=7)
    if kind == "single_end":
        records, _ = sim.simulate_single_reads(panel, 800, read_length=100, seed=19)
        return [alignments.parse_multipath_alignment(r) for r in records], True, False, {
            "single_end": True, "frag_mean": 250.0, "frag_sd": 25.0,
        }
    if kind == "single_path":
        records, _ = sim.simulate_read_pairs(
            panel, 600, read_length=100, frag_mean=250, frag_sd=25, seed=23,
            abundances=abundances, as_multipath=False,
        )
        parsed = [alignments.parse_alignment(r) for r in records]
        return list(zip(parsed[0::2], parsed[1::2])), False, True, {"single_path": True}
    quality = kind == "paired_quality"
    records, _ = sim.simulate_read_pairs(
        panel, 600, read_length=100, frag_mean=250, frag_sd=25, seed=17,
        abundances=abundances, multipath_dag=not quality, with_qualities=quality,
        with_errors=quality,
    )
    parsed = [alignments.parse_multipath_alignment(r) for r in records]
    pairs = list(zip(parsed[0::2], parsed[1::2]))
    changes = {"score_not_qual": not quality}
    if kind == "unaligned":
        # Every seventh pair loses a mate's path, every eleventh starts off
        # the graph; others are disconnected or carry an allelic mapq.
        for i, (first, second) in enumerate(pairs):
            if i % 7 == 0:
                first = _unalign(first, "empty")
            elif i % 11 == 0:
                second = _unalign(second, "off_graph")
            elif i % 5 == 0:
                first = replace(first, annotation={"disconnected": True})
            elif i % 3 == 0:
                second = replace(second, annotation={"allelic_mapq": 17})
            pairs[i] = (first, second)
        changes["use_allelic_mapq"] = True
    return pairs, True, True, changes


def _write(path, fragments, is_multipath, is_paired, blocks=BLOCKS):
    writer = rpa.RpaWriter(path, is_multipath, is_paired, 250.0, 25.0)
    start, turn = 0, 0
    while start < len(fragments):
        size = blocks[turn % len(blocks)]
        writer.write_block(native.serialize_fragments(fragments[start:start + size]))
        start, turn = start + size, turn + 1
    writer.close()


def _config(files, rpa_path, threads, **changes):
    return PipelineConfig(
        graph=files["graph"], paths=files["paths"], alignments=rpa_path,
        inference_model="haplotypes", threads=threads, rng_seed=1, **changes,
    )


def _both_routes(config):
    _, paths_index = load_inputs(config)
    pre = resolve_pre_fragment_dist(config)
    finder = build_finder(config, paths_index, pre)
    assert fragment_pass.takes(config.alignments, finder)
    with spans.RunSpan("test.pinned"):
        pinned = collect_fragments(config, finder, pre, columnar=True)
    with spans.RunSpan("test.flat"):
        flat = collect_fragments_flat(config, finder, pre)
    return pinned, flat


def _assert_same_columns(pinned, flat):
    assert isinstance(pinned, ColumnarFragmentIndex) and isinstance(flat, ColumnarFragmentIndex)
    a, b = pinned.columnar, flat.columnar
    assert len(a) == len(b) > 0
    for name in ("counts", "anchors", "id_bounds", "all_ids", "raw_bounds", "histogram"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a.unaligned == b.unaligned
    assert a.data == b.data


LIBRARIES = ["paired_multipath", "paired_quality", "single_end", "single_path", "unaligned"]


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", LIBRARIES)
def test_flat_pass_writes_the_pinned_routes_columns(panel, kind, threads, tmp_path):
    work, sim_panel, files = panel
    fragments, is_multipath, is_paired, changes = _library(kind, sim_panel)
    path = str(tmp_path / f"{kind}.rpa")
    _write(path, fragments, is_multipath, is_paired)
    pinned, flat = _both_routes(_config(files, path, threads, **changes))
    _assert_same_columns(pinned, flat)
    if kind == "unaligned":
        assert flat.unaligned_count > 0


@pytest.mark.parametrize("library_type", ["fr", "rf"])
def test_flat_pass_follows_the_library_type(panel, library_type, tmp_path):
    work, sim_panel, files = panel
    fragments, is_multipath, is_paired, changes = _library("paired_multipath", sim_panel)
    path = str(tmp_path / "stranded.rpa")
    _write(path, fragments, is_multipath, is_paired)
    config = _config(files, path, 3, library_type=library_type, **changes)
    _assert_same_columns(*_both_routes(config))


def test_more_workers_than_cores_on_tiny_blocks_lose_nothing(panel, tmp_path):
    """16 workers on blocks of one to three fragments: every block is a
    contended hand-out and a hand-back, and a lost count, fragment or
    block would change the columns.  The pass runs on a thread joined
    with a timeout, so a stuck feed fails the test instead of hanging."""
    work, sim_panel, files = panel
    fragments, is_multipath, is_paired, changes = _library("paired_multipath", sim_panel)
    path = str(tmp_path / "tiny_blocks.rpa")
    _write(path, fragments[:300], is_multipath, is_paired, blocks=(1, 2, 3))
    config = _config(files, path, 16, **changes)
    _, paths_index = load_inputs(config)
    pre = resolve_pre_fragment_dist(config)
    finder = build_finder(config, paths_index, pre)
    pinned = collect_fragments(config, finder, pre, columnar=True)
    result = {}
    runner = threading.Thread(
        target=lambda: result.update(flat=collect_fragments_flat(config, finder, pre)),
        daemon=True,
    )
    runner.start()
    runner.join(timeout=120)
    assert not runner.is_alive(), "the flat pass did not finish"
    _assert_same_columns(pinned, result["flat"])


# ------------------------------------------------------------- the reader


def _truncations(valid: bytes):
    return {
        "header": valid + b"\x05\x00\x00",
        "length": valid + struct.pack("<q", -5),
        "block": valid + struct.pack("<q", 100) + b"\x00" * 10,
    }


@pytest.mark.parametrize("fault", ["header", "length", "block"])
def test_a_broken_rpa_raises_the_readers_error(panel, fault, tmp_path):
    work, sim_panel, files = panel
    fragments, is_multipath, is_paired, changes = _library("paired_multipath", sim_panel)
    good = str(tmp_path / "good.rpa")
    _write(good, fragments[:120], is_multipath, is_paired)
    with open(good, "rb") as handle:
        broken_bytes = _truncations(handle.read())[fault]
    broken = str(tmp_path / f"{fault}.rpa")
    with open(broken, "wb") as handle:
        handle.write(broken_bytes)
    reader = rpa.RpaReader(broken)
    with pytest.raises(ValueError) as expected:
        list(reader.blocks())
    reader.close()
    config = _config(files, broken, 2, **changes)
    _, paths_index = load_inputs(config)
    pre = resolve_pre_fragment_dist(config)
    finder = build_finder(config, paths_index, pre)
    with pytest.raises(ValueError, match=re.escape(str(expected.value))):
        collect_fragments_flat(config, finder, pre)


def test_a_header_that_disagrees_with_the_configuration_is_refused(panel, tmp_path):
    work, sim_panel, files = panel
    fragments, is_multipath, is_paired, changes = _library("paired_multipath", sim_panel)
    path = str(tmp_path / "paired.rpa")
    _write(path, fragments[:50], is_multipath, is_paired)
    config = _config(files, path, 2, single_end=True, frag_mean=250.0, frag_sd=25.0)
    _, paths_index = load_inputs(config)
    pre = resolve_pre_fragment_dist(config)
    with pytest.raises(PipelineInputError, match="rpa file is paired"):
        collect_fragments_flat(config, build_finder(config, paths_index, pre), pre)


# ------------------------------------------------ the route, spans, counters


@pytest.fixture(scope="module")
def small_run(panel, tmp_path_factory):
    work, sim_panel, files = panel
    fragments, is_multipath, is_paired, changes = _library("paired_multipath", sim_panel)
    path = str(tmp_path_factory.mktemp("flat_run") / "aln.rpa")
    _write(path, fragments, is_multipath, is_paired)
    return _config(files, path, 2, **changes)


def test_a_run_on_rpa_takes_the_flat_pass_and_records_it(small_run, tmp_path):
    stats = run_pipeline(replace(small_run, output_prefix=str(tmp_path / "out")), CPU)
    found, counters = stats["spans"], stats["counters"]
    for name in ("read", "wait", "project", "dump"):
        assert found[f"rpvg.fragments.{name}"]["count"] == 1, name
    assert counters["fragments.flat_pass"] == 1
    assert counters["fragments.arena_bytes"] > 0
    reader = rpa.RpaReader(small_run.alignments)
    payloads = list(reader.blocks())
    reader.close()
    assert counters["fragments.blocks"] == len(payloads) == 4
    assert counters["fragments.bytes"] == sum(map(len, payloads))
    inside = found["rpvg.fragments.project"]["total_s"] + found["rpvg.fragments.dump"]["total_s"]
    assert inside <= stats["fragment_pass_seconds"]
    assert found["rpvg.fragments.read"]["total_s"] <= found["rpvg.fragments.project"]["total_s"]


class Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("the flat fragment pass ran")


def test_sharded_and_json_runs_keep_the_pinned_route(small_run, panel, tmp_path, monkeypatch):
    work, sim_panel, files = panel
    monkeypatch.setattr(fragment_pass, "FlatPass", Refused)
    multihost.run_pipeline_sharded(
        replace(small_run, output_prefix=str(tmp_path / "sharded")), 2, CPU
    )
    assert "fragments.flat_pass" not in spans.recent_runs(1)[0]["counters"]

    records, _ = sim.simulate_read_pairs(
        sim_panel, 200, read_length=100, frag_mean=250, frag_sd=25, seed=29,
    )
    json_path = str(tmp_path / "aln.json")
    sim.write_alignment_json(records, json_path)
    stats = run_pipeline(
        replace(small_run, alignments=json_path, output_prefix=str(tmp_path / "json")), CPU
    )
    assert "fragments.flat_pass" not in stats["counters"]


def test_only_an_rpa_path_with_the_native_finder_takes_the_route(small_run):
    _, paths_index = load_inputs(small_run)
    pre = resolve_pre_fragment_dist(small_run)
    native_finder = build_finder(small_run, paths_index, pre)
    python_finder = build_finder(replace(small_run, native="off"), paths_index, pre)
    assert fragment_pass.takes(small_run.alignments, native_finder)
    assert not fragment_pass.takes(small_run.alignments, python_finder)
    assert not fragment_pass.takes(small_run.alignments[:-4] + ".json", native_finder)
    assert not fragment_pass.takes([("a", "b")], native_finder)


def test_the_pinned_rpa_route_keeps_its_per_block_spans(small_run):
    """``collect_fragments`` (a sharded pass's route) still spans each block."""
    _, paths_index = load_inputs(small_run)
    pre = resolve_pre_fragment_dist(small_run)
    finder = build_finder(small_run, paths_index, pre)
    with spans.RunSpan("test.pinned") as whole:
        collect_fragments(small_run, finder, pre, columnar=True)
    summary = whole.run.summary()
    found, counters = summary["spans"], summary["counters"]
    blocks = found["rpvg.fragments.read"]["count"]
    assert counters["fragments.blocks"] == blocks == 4
    assert found["rpvg.fragments.project"]["count"] == blocks
    assert found["rpvg.fragments.wait"]["count"] == blocks + 1  # the end of the blocks
    assert "fragments.flat_pass" not in counters
