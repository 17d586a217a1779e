"""The cell's inputs, made from seeds and cached inside the checkout.

A configuration's ``panel`` (the pantranscriptome: graph JSON, panel
JSON, info TSV) comes from its own fixed seed and does not change with
``--seed``.  The traffic's sample (paired multipath reads as an ``.rpa``
file) is one fixed library, its pool: the expression profile
(``gene_abundances``) and the reads simulated from the traffic's own
seeds, written in an order drawn from ``--seed``.  Everything is written once
under ``bench_port/cache/`` in a directory named by a digest of what
defines it, and read from there by every later run; a directory appears
under its name only when it is whole.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import tempfile
from typing import Dict

import numpy as np

from bench_port.frozen import alignments, rpa, sim

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.path.join(BENCH_DIR, "cache")
# Bump when the generator changes what it writes for the same parameters.
GENERATOR_VERSION = 1
# Samples kept in the cache; the oldest go first.
MAX_SAMPLES = 24


def _digest(kind: str, params: dict) -> str:
    text = json.dumps({"kind": kind, "version": GENERATOR_VERSION, **params}, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:20]


def seed_material(seed: int) -> int:
    """The run's seed as numpy takes it: any whole number, folded into 64 bits."""
    return int(seed) % (1 << 64)


def _cached(kind: str, params: dict, names, make) -> Dict[str, str]:
    """Paths of ``names`` in the cache directory of (kind, params),
    made by ``make(directory)`` when the directory is not there."""
    final = os.path.join(CACHE_DIR, f"{kind}-{_digest(kind, params)}")
    if not os.path.isdir(final):
        os.makedirs(CACHE_DIR, exist_ok=True)
        work = tempfile.mkdtemp(prefix=f".{kind}-", dir=CACHE_DIR)
        try:
            make(work)
            with open(os.path.join(work, "params.json"), "w") as handle:
                json.dump(params, handle, sort_keys=True)
            os.rename(work, final)
        except OSError:
            if not os.path.isdir(final):
                raise
        finally:
            shutil.rmtree(work, ignore_errors=True)
    os.utime(final)
    return {name: os.path.join(final, file) for name, file in names.items()}


def build_panel(panel: dict):
    return sim.build_gene_panel(
        num_genes=panel["num_genes"], isoforms_per_gene=panel["isoforms_per_gene"],
        num_haplotypes=panel["num_haplotypes"], exons_per_gene=panel["exons_per_gene"],
        exon_length=panel["exon_length"], variant_sites=panel["variant_sites"],
        seed=panel["seed"],
    )


def panel_files(config: dict, built) -> Dict[str, str]:
    """graph / panel / info of the configuration's pantranscriptome;
    ``built()`` gives the panel when the files have to be written."""
    def make(directory):
        panel = built()
        panel.write_graph_json(os.path.join(directory, "graph.json"))
        panel.write_panel_json(os.path.join(directory, "panel.json"))
        panel.write_info_tsv(os.path.join(directory, "info.tsv"))

    return _cached("panel", config["panel"], {"graph": "graph.json", "panel": "panel.json",
                                              "info": "info.tsv"}, make)


def _prune_samples(keep: str) -> None:
    """The newest ``MAX_SAMPLES`` samples stay, and as many reference
    results (``expected-*``, written by the harness); pools stay."""
    for prefix in ("sample-", "expected-"):
        entries = [os.path.join(CACHE_DIR, d) for d in os.listdir(CACHE_DIR) if d.startswith(prefix)]
        entries.sort(key=os.path.getmtime, reverse=True)
        for entry in entries[MAX_SAMPLES:]:
            if entry == keep:
                continue
            if os.path.isdir(entry):
                shutil.rmtree(entry, ignore_errors=True)
            else:
                os.remove(entry)


def _pool(config: dict, traffic: dict, built) -> Dict[str, str]:
    """The library's read pairs, each serialized as an ``.rpa`` block
    holds it (``fragments.bin``, with ``offsets.npy``), in the order the
    simulator drew them from the traffic's seeds."""
    reads = traffic["reads"]
    expression = traffic["expression"]
    reads_seed = seed_material(reads["seed"])
    expression_seed = seed_material(expression["seed"])
    params = {"panel": config["panel"], "reads": reads, "expression": expression}

    def make(directory):
        panel = built()
        abundances = sim.gene_abundances(
            panel, gene_alpha=expression["gene_alpha"], path_alpha=expression["path_alpha"],
            seed=expression_seed,
        )
        records, _ = sim.simulate_read_pairs(
            panel, reads["pairs"], read_length=reads["read_length"],
            frag_mean=reads["frag_mean"], frag_sd=reads["frag_sd"],
            seed=reads_seed, abundances=abundances,
            with_errors=reads["with_errors"], multipath_dag=reads["multipath_dag"],
        )
        parsed = [alignments.parse_multipath_alignment(r) for r in records]
        del records
        # serialize_fragments of one pair is its count, then the pair.
        blobs = [rpa.serialize_fragments([pair])[4:] for pair in zip(parsed[0::2], parsed[1::2])]
        np.save(os.path.join(directory, "offsets.npy"),
                np.cumsum([0] + [len(b) for b in blobs], dtype=np.int64))
        with open(os.path.join(directory, "fragments.bin"), "wb") as handle:
            handle.write(b"".join(blobs))

    return _cached("pool", params, {"fragments": "fragments.bin", "offsets": "offsets.npy"}, make)


def sample_file(config: dict, traffic: dict, seed: int, built) -> Dict[str, str]:
    """The ``.rpa`` reads of the run (``reads``) and the directory of the
    pool they come from (``pool``): the pool's pairs in an order drawn
    from ``seed``, so that every seed gets the same pairs in another
    order."""
    pool = _pool(config, traffic, built)
    reads = traffic["reads"]
    params = {"pool": os.path.basename(os.path.dirname(pool["fragments"])),
              "order": seed_material(seed)}

    def make(directory):
        offsets = np.load(pool["offsets"])
        with open(pool["fragments"], "rb") as handle:
            blob = handle.read()
        n = offsets.size - 1
        order = np.random.default_rng(seed_material(seed)).permutation(n)
        writer = rpa.RpaWriter(os.path.join(directory, "aln.rpa"), True, True,
                               float(reads["frag_mean"]), float(reads["frag_sd"]))
        for lo in range(0, n, rpa.DEFAULT_BLOCK_FRAGMENTS):
            block = order[lo:lo + rpa.DEFAULT_BLOCK_FRAGMENTS]
            writer.write_block(struct.pack("<i", block.size) + b"".join(
                blob[offsets[i]:offsets[i + 1]] for i in block.tolist()))
        writer.close()

    path = _cached("sample", params, {"reads": "aln.rpa"}, make)["reads"]
    _prune_samples(os.path.dirname(path))
    return {"reads": path, "pool": os.path.dirname(pool["fragments"])}


def prepare_apart(config: dict, traffic: dict, seed: int) -> Dict[str, str]:
    """:func:`prepare` in a child process (``spawn``), so that making a
    sample leaves nothing in the caller's heap: a run that makes its
    inputs and one that reads them from the cache run the same window."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        return pool.apply(_prepare_in, (CACHE_DIR, config, traffic, seed))
    finally:
        pool.close()
        pool.join()


def _prepare_in(cache_dir: str, config: dict, traffic: dict, seed: int) -> Dict[str, str]:
    global CACHE_DIR
    CACHE_DIR = cache_dir
    return prepare(config, traffic, seed)


def prepare(config: dict, traffic: dict, seed: int) -> Dict[str, str]:
    """Every input file of the cell: graph, panel, info and reads, and
    the pool directory the reads come from."""
    built = []

    def panel():
        if not built:
            built.append(build_panel(config["panel"]))
        return built[0]

    files = panel_files(config, panel)
    files.update(sample_file(config, traffic, seed, panel))
    return files
