"""The generator: one seed gives the same bytes, two seeds the same
library in two orders, written as the frozen writer writes them; the
panel does not follow the seed."""

import hashlib
import json
import os

from bench_port import inputs
from bench_port.frozen import alignments, rpa, sim
from bench_port.reference.fragment_pass import block_spans, decode_pairs
from bench_port.tests.conftest import DATA


def _load(name):
    with open(os.path.join(DATA, name)) as handle:
        return json.load(handle)


def _digest(path):
    with open(path, "rb") as handle:
        return hashlib.sha256(handle.read()).hexdigest()


def test_same_seed_same_bytes_other_seed_other_sample(tmp_path, monkeypatch):
    config = _load("configs/tiny_diploid.json")
    traffic = _load("traffic/sample3k.json")
    monkeypatch.setattr(inputs, "CACHE_DIR", str(tmp_path / "a"))
    first = inputs.prepare(config, traffic, 2**31 + 5)
    monkeypatch.setattr(inputs, "CACHE_DIR", str(tmp_path / "b"))
    again = inputs.prepare(config, traffic, 2**31 + 5)
    other = inputs.prepare(config, traffic, 2**31 + 6)
    for key in ("graph", "panel", "info", "reads"):
        assert _digest(first[key]) == _digest(again[key])
    for key in ("graph", "panel", "info"):
        assert _digest(first[key]) == _digest(other[key])
    assert _digest(first["reads"]) != _digest(other["reads"])


def test_a_shuffled_sample_is_the_pool_in_the_seed_s_order(tmp_path, monkeypatch):
    config = _load("configs/tiny_diploid.json")
    traffic = _load("traffic/sample3k.json")
    monkeypatch.setattr(inputs, "CACHE_DIR", str(tmp_path))
    one = inputs.prepare(config, traffic, 1)
    two = inputs.prepare(config, traffic, 2)
    assert one["pool"] == two["pool"] and one["reads"] != two["reads"]
    assert _digest(one["reads"]) != _digest(two["reads"])

    def pairs(path):
        with open(path, "rb") as handle:
            out = []
            for offset, length in block_spans(path):
                handle.seek(offset)
                out += [repr(p) for p in decode_pairs(handle.read(length))]
            return out

    assert sorted(pairs(one["reads"])) == sorted(pairs(two["reads"]))
    # The same bytes as the frozen writer over the simulator's pairs, reordered.
    panel = inputs.build_panel(config["panel"])
    reads = traffic["reads"]
    records, _ = sim.simulate_read_pairs(
        panel, reads["pairs"], read_length=reads["read_length"], frag_mean=reads["frag_mean"],
        frag_sd=reads["frag_sd"], seed=17,
        abundances=sim.gene_abundances(panel, gene_alpha=0.35, path_alpha=2.0,
                                       seed=7),
        with_errors=False, multipath_dag=True,
    )
    parsed = [alignments.parse_multipath_alignment(r) for r in records]
    fragments = list(zip(parsed[0::2], parsed[1::2]))
    import numpy as np

    order = np.random.default_rng(1).permutation(len(fragments))
    expected = tmp_path / "expected.rpa"
    rpa.write_fragments(str(expected), [fragments[i] for i in order], True, True, 250.0, 25.0)
    assert _digest(str(expected)) == _digest(one["reads"])


def test_a_cached_sample_is_not_made_again(tmp_path, monkeypatch):
    config = _load("configs/tiny_diploid.json")
    traffic = _load("traffic/sample3k.json")
    monkeypatch.setattr(inputs, "CACHE_DIR", str(tmp_path))
    first = inputs.prepare(config, traffic, 7)
    stamp = os.path.getmtime(first["reads"])
    monkeypatch.setattr(inputs.sim, "simulate_read_pairs", None)  # would fail if called
    again = inputs.prepare(config, traffic, 7)
    assert again == first and os.path.getmtime(again["reads"]) == stamp


def test_negative_and_large_seeds_are_taken():
    assert inputs.seed_material(-1) == 2**64 - 1
    assert inputs.seed_material(2**40 + 3) == 2**40 + 3
