"""Synthetic pantranscriptome + read simulator.

Builds small variation-graph transcript panels (transcript groups with
haplotype variants at bubble sites) and simulates paired-end fragments
as perfect-match alignments, for end-to-end tests and benchmarks.  The
reference ships a prebuilt binary example (stripped from this snapshot);
this module regenerates equivalent inputs from scratch.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class SimulatedPanel:
    bidirectional: bool
    path_names: List[str]
    # name -> (transcript_name, haplotype_names)
    info: Dict[str, Tuple[str, List[str]]]
    node_lengths: Dict[int, int]
    path_nodes: List[List[Tuple[int, bool]]]
    # variant-site metadata: allele node id -> ordered sibling allele
    # node ids at the same site (used by the multipath-DAG simulator).
    allele_siblings: Dict[int, List[int]] = None

    def write_graph_json(self, path: str) -> None:
        obj = {
            "node": [
                {"id": nid, "sequence": "A" * length}
                for nid, length in sorted(self.node_lengths.items())
            ]
        }
        with open(path, "w") as handle:
            json.dump(obj, handle)

    def write_panel_json(self, path: str) -> None:
        obj = {
            "bidirectional": self.bidirectional,
            "paths": [
                {"name": name, "nodes": [[nid, int(rev)] for nid, rev in nodes]}
                for name, nodes in zip(self.path_names, self.path_nodes)
            ],
        }
        with open(path, "w") as handle:
            json.dump(obj, handle)

    def write_info_tsv(self, path: str) -> None:
        with open(path, "w") as handle:
            handle.write("Name\tLength\tTranscript\tHaplotypes\n")
            for name, nodes in zip(self.path_names, self.path_nodes):
                transcript, haplotypes = self.info[name]
                length = sum(self.node_lengths[nid] for nid, _ in nodes)
                handle.write(f"{name}\t{length}\t{transcript}\t{','.join(haplotypes)}\n")


def build_gene_panel(
    num_genes: int = 100,
    isoforms_per_gene: float = 7.0,
    num_haplotypes: int = 4,
    exons_per_gene: int = 10,
    exon_length: int = 120,
    variant_sites: int = 3,
    bidirectional: bool = True,
    seed: int = 0,
) -> SimulatedPanel:
    """Gene-structured pantranscriptome: isoforms of a gene share its
    exon nodes (alternative splicing) and haplotype allele nodes, so
    reads multimap across isoform x haplotype paths exactly as in a real
    pantranscriptome — per-gene path clusters are isoforms*haplotypes
    wide and power-law sized, the regime the reference's size-sorted
    scheduling and B&B pruning exist for (src/main.cpp:811-827,
    src/path_estimator.cpp:379).  build_panel's isolated-transcript
    panels produce only toy clusters (<= haplotypes paths each).

    Isoform counts per gene are lognormal around `isoforms_per_gene`;
    every isoform keeps the first and last exon and a random middle
    subset.  Each variant site sits after a fixed exon and contributes
    one allele node per haplotype, shared by every isoform containing
    that exon."""
    rng = np.random.default_rng(seed)
    node_lengths: Dict[int, int] = {}
    next_node = 1

    def new_node(length: int) -> int:
        nonlocal next_node
        nid = next_node
        node_lengths[nid] = length
        next_node += 1
        return nid

    path_names: List[str] = []
    path_nodes: List[List[Tuple[int, bool]]] = []
    info: Dict[str, Tuple[str, List[str]]] = {}
    allele_siblings: Dict[int, List[int]] = {}

    for g in range(num_genes):
        exons = [new_node(exon_length) for _ in range(exons_per_gene)]
        n_sites = min(variant_sites, exons_per_gene)
        site_exons = sorted(
            rng.choice(exons_per_gene, size=n_sites, replace=False).tolist()
        )
        allele_of = {
            e: [new_node(max(4, exon_length // 8)) for _ in range(num_haplotypes)]
            for e in site_exons
        }
        for alleles in allele_of.values():
            for a in alleles:
                allele_siblings[a] = alleles

        n_iso = max(
            1, int(round(rng.lognormal(np.log(max(1.0, isoforms_per_gene)), 0.35)))
        )
        seen = set()
        isoforms: List[Tuple[int, ...]] = []
        attempts = 0
        while len(isoforms) < n_iso and attempts < 20 * n_iso:
            attempts += 1
            middle = [
                e for e in range(1, exons_per_gene - 1) if rng.random() < 0.7
            ]
            key = tuple([0] + middle + [exons_per_gene - 1])
            if key not in seen:
                seen.add(key)
                isoforms.append(key)

        for i, iso in enumerate(isoforms):
            tname = f"ENST{g:05d}T{i:02d}"
            for h in range(num_haplotypes):
                nodes: List[Tuple[int, bool]] = []
                for e in iso:
                    nodes.append((exons[e], False))
                    if e in allele_of:
                        nodes.append((allele_of[e][h], False))
                name = f"{tname}_na_h{h}_1"
                path_names.append(name)
                path_nodes.append(nodes)
                info[name] = (tname, [f"hap{h}"])

    return SimulatedPanel(bidirectional, path_names, info, node_lengths,
                          path_nodes, allele_siblings)


def gene_abundances(
    panel: SimulatedPanel,
    gene_alpha: float = 0.35,
    path_alpha: float = 2.0,
    seed: int = 7,
) -> np.ndarray:
    """Power-law expression: sparse Dirichlet over genes (a few hot genes
    carry most reads, as in real RNA-seq) times a within-gene Dirichlet
    over isoform/haplotype paths."""
    rng = np.random.default_rng(seed)
    transcripts = [panel.info[name][0] for name in panel.path_names]
    genes = sorted({t[:9] for t in transcripts})
    gene_index = {g: i for i, g in enumerate(genes)}
    gene_of = np.array([gene_index[t[:9]] for t in transcripts])
    gene_ab = rng.dirichlet(np.ones(len(genes)) * gene_alpha)
    ab = gene_ab[gene_of] * rng.dirichlet(np.ones(len(transcripts)) * path_alpha)
    return ab / ab.sum()


def _mappings_for_interval(
    path: Sequence[Tuple[int, bool]],
    node_lengths: Dict[int, int],
    start: int,
    length: int,
) -> List[dict]:
    """Perfect-match mapping list covering [start, start+length) of the
    path's concatenated sequence."""
    mappings = []
    offset = 0
    remaining = length
    pos = start
    for nid, rev in path:
        node_len = node_lengths[nid]
        if pos >= offset + node_len:
            offset += node_len
            continue
        in_node_offset = pos - offset
        take = min(node_len - in_node_offset, remaining)
        mappings.append(
            {
                "position": {"node_id": nid, "offset": in_node_offset, "is_reverse": rev},
                "edit": [{"from_length": take, "to_length": take}],
            }
        )
        remaining -= take
        pos += take
        offset += node_len
        if remaining == 0:
            break
    assert remaining == 0, "interval extends past path end"
    return mappings


def _reverse_interval_mappings(
    path: Sequence[Tuple[int, bool]],
    node_lengths: Dict[int, int],
    start: int,
    length: int,
) -> List[dict]:
    """Mapping list for the reverse-complement read of the interval."""
    forward = _mappings_for_interval(path, node_lengths, start, length)
    reversed_mappings = []
    for mapping in reversed(forward):
        node_id = mapping["position"]["node_id"]
        node_len = node_lengths[node_id]
        used = sum(e["from_length"] for e in mapping["edit"])
        fwd_offset = mapping["position"].get("offset", 0)
        reversed_mappings.append(
            {
                "position": {
                    "node_id": node_id,
                    "offset": node_len - used - fwd_offset,
                    "is_reverse": not mapping["position"].get("is_reverse", False),
                },
                "edit": list(reversed(mapping["edit"])),
            }
        )
    return reversed_mappings


def _draw_qualities(rng, read_length: int) -> np.ndarray:
    """Illumina-shaped per-base qualities: high plateau with a noisy
    3'-end ramp-down and occasional low-quality bases."""
    quals = rng.normal(37.0, 2.5, read_length)
    ramp_len = max(1, read_length // 5)
    quals[-ramp_len:] -= np.linspace(0.0, 12.0, ramp_len)
    low = rng.random(read_length) < 0.01
    quals[low] = rng.uniform(2, 15, int(low.sum()))
    return np.clip(np.round(quals), 2, 41).astype(np.uint8)


def _inject_errors(mappings: List[dict], err_read_pos: np.ndarray) -> None:
    """Split match edits at error read-positions, inserting 1-base
    mismatch edits (from==to with a sequence, the vg convention).  The
    mapping list is in read order for both mates."""
    errs = set(int(p) for p in err_read_pos)
    read_pos = 0
    for mapping in mappings:
        new_edits = []
        for edit in mapping["edit"]:
            length = edit["from_length"]
            taken = 0
            while taken < length:
                run = length - taken
                # Next error inside this run?
                nxt = None
                for p in range(read_pos, read_pos + run):
                    if p in errs:
                        nxt = p
                        break
                if nxt is None:
                    new_edits.append({"from_length": run, "to_length": run})
                    taken += run
                    read_pos += run
                else:
                    before = nxt - read_pos
                    if before:
                        new_edits.append(
                            {"from_length": before, "to_length": before}
                        )
                    new_edits.append(
                        {"from_length": 1, "to_length": 1, "sequence": "C"}
                    )
                    taken += before + 1
                    read_pos += before + 1
        mapping["edit"] = new_edits


def _qual_adjusted_score(quals: np.ndarray, errs: np.ndarray) -> int:
    """mpmap-style quality-adjusted alignment score for a full-length
    alignment: per-base qual-adjusted match/mismatch plus both per-qual
    full-length bonuses (the same GSSW tables the engine publishes in
    scoring.py, reference utils.hpp:514-597)."""
    from .scoring import (
        QUAL_FULL_LENGTH_BONUSES,
        QUAL_MATCH_SCORES,
        QUAL_SCORE_TENSOR,
    )

    per_base = np.where(
        errs,
        QUAL_SCORE_TENSOR[quals, 0, 1].astype(np.int32),  # A ref, C read
        QUAL_MATCH_SCORES[quals],
    )
    return int(
        per_base.sum()
        + QUAL_FULL_LENGTH_BONUSES[quals[0]]
        + QUAL_FULL_LENGTH_BONUSES[quals[-1]]
    )


MISMATCH_DELTA = 5  # match(+1) -> mismatch(-4), reference scoring


def _multipath_dag_record(
    panel: SimulatedPanel,
    mappings: List[dict],
    read_length: int,
    mapq: int,
    per_base_scores: Optional[np.ndarray],
    quals: Optional[np.ndarray],
) -> Optional[dict]:
    """mpmap-shaped subpath DAG for a read: contiguous runs of
    non-variant mappings become shared subpaths; each variant-site
    mapping fans out into one subpath per allele, the true allele
    scoring as matches and each sibling carrying a 1-base mismatch
    penalty — the scored alternative alignments a real multipath
    aligner reports over a pangenome bubble (what the reference's
    multipath DFS + branch-and-bound exist for,
    reference/src/alignment_path_finder.cpp:685-806).

    `per_base_scores`: per read position (match table values; error
    positions already hold mismatch scores); None = score-only mode
    (1/base).  Returns None when the read crosses no variant site (the
    caller emits the plain single-subpath record)."""
    siblings = panel.allele_siblings or {}
    # Read-coordinate span per mapping.
    spans = []
    pos = 0
    for m in mappings:
        length = sum(e["to_length"] for e in m["edit"])
        spans.append((pos, pos + length))
        pos += length
    if not any(
        len(siblings.get(m["position"]["node_id"], ())) > 1 for m in mappings
    ):
        return None

    def span_score(a: int, b: int) -> int:
        if per_base_scores is None:
            return b - a
        return int(per_base_scores[a:b].sum())

    def bonus(read_pos: int) -> int:
        if quals is None:
            return 5
        from .scoring import QUAL_FULL_LENGTH_BONUSES

        return int(QUAL_FULL_LENGTH_BONUSES[quals[read_pos]])

    # Layers: each a list of subpath dicts; consecutive layers connect
    # all-to-all (variant layers carry one subpath per allele).
    layers: List[List[dict]] = []
    run: List[dict] = []
    run_start = None

    def flush_run(run_end: int) -> None:
        nonlocal run, run_start
        if not run:
            return
        score = span_score(run_start, run_end)
        if run_start == 0:
            score += bonus(0)
        if run_end == read_length:
            score += bonus(read_length - 1)
        layers.append([{"path": {"mapping": run}, "score": score}])
        run = []
        run_start = None

    for m, (a, b) in zip(mappings, spans):
        node = m["position"]["node_id"]
        alleles = siblings.get(node, ())
        if len(alleles) > 1:
            flush_run(a)
            base = span_score(a, b)
            if a == 0:
                base += bonus(0)
            if b == read_length:
                base += bonus(read_length - 1)
            layer = []
            for allele in alleles:
                if allele == node:
                    layer.append({"path": {"mapping": [m]}, "score": base})
                    continue
                # Sibling allele: same walk through the sibling node,
                # one mismatched base at the site (first covered base).
                alt = {
                    "position": dict(m["position"], node_id=allele),
                    "edit": [],
                }
                covered = b - a
                alt["edit"].append(
                    {"from_length": 1, "to_length": 1, "sequence": "C"}
                )
                if covered > 1:
                    alt["edit"].append(
                        {"from_length": covered - 1, "to_length": covered - 1}
                    )
                if per_base_scores is None:
                    delta = MISMATCH_DELTA
                else:
                    from .scoring import QUAL_MATCH_SCORES, QUAL_SCORE_TENSOR

                    q = quals[a]
                    delta = int(QUAL_MATCH_SCORES[q]) - int(
                        QUAL_SCORE_TENSOR[q, 0, 1]
                    )
                layer.append({"path": {"mapping": [alt]}, "score": base - delta})
            layers.append(layer)
        else:
            if not run:
                run_start = a
            run.append(m)
    flush_run(read_length)

    subpaths: List[dict] = []
    layer_index: List[List[int]] = []
    for layer in layers:
        idxs = []
        for sp in layer:
            idxs.append(len(subpaths))
            subpaths.append(sp)
        layer_index.append(idxs)
    for prev, nxt in zip(layer_index, layer_index[1:]):
        for i in prev:
            subpaths[i]["next"] = list(nxt)
    return {
        "mapping_quality": mapq,
        "start": list(layer_index[0]),
        "subpath": subpaths,
    }


def simulate_read_pairs(
    panel: SimulatedPanel,
    num_pairs: int,
    read_length: int = 75,
    frag_mean: float = 200.0,
    frag_sd: float = 20.0,
    abundances: Optional[np.ndarray] = None,
    mapq: int = 60,
    seed: int = 1,
    as_multipath: bool = True,
    with_qualities: bool = False,
    with_errors: bool = False,
    multipath_dag: bool = False,
) -> Tuple[List[dict], np.ndarray]:
    """Simulate paired-end fragments; returns (records, true per-path
    fragment counts).  Records are interleaved protobuf-JSON dicts
    (multipath single-subpath by default, matching mpmap output
    structure).

    `with_errors` produces the reference's DEFAULT regime (quality-
    adjusted scoring, src/main.cpp:385): Illumina-shaped per-base
    qualities, quality-driven sequencing errors as mismatch edits, and
    quality-adjusted alignment scores.

    `multipath_dag` emits mpmap-shaped subpath DAGs for reads crossing
    variant sites: scored alternative subpaths over every allele of the
    bubble (1-base mismatch penalty on the non-sampled alleles), so the
    projection's multipath DFS weighs soft evidence exactly as with
    real aligner output."""
    rng = np.random.default_rng(seed)
    num_paths = len(panel.path_names)
    if abundances is None:
        abundances = rng.dirichlet(np.ones(num_paths) * 1.5)
    abundances = np.asarray(abundances, dtype=np.float64)
    abundances = abundances / abundances.sum()

    path_lengths = np.array(
        [
            sum(panel.node_lengths[nid] for nid, _ in nodes)
            for nodes in panel.path_nodes
        ]
    )

    records: List[dict] = []
    true_counts = np.zeros(num_paths, dtype=np.int64)

    # Vectorised fragment draws (paths too short for a fragment are
    # excluded up front — the rejection loop they would spin on).
    eligible = np.flatnonzero(path_lengths >= 2 * read_length)
    assert eligible.size, "no path is long enough for a fragment"
    elig_probs = abundances[eligible] / abundances[eligible].sum()
    path_choices = eligible[
        rng.choice(eligible.size, size=num_pairs, p=elig_probs)
    ]
    frag_draws = np.round(rng.normal(frag_mean, frag_sd, size=num_pairs)).astype(int)
    frag_draws = np.clip(frag_draws, 2 * read_length, path_lengths[path_choices])
    start_draws = rng.integers(
        0, path_lengths[path_choices] - frag_draws + 1, size=num_pairs
    )

    first = True
    for pair_idx in range(num_pairs):
        path_idx = int(path_choices[pair_idx])
        path_len = int(path_lengths[path_idx])
        frag_len = int(frag_draws[pair_idx])
        start = int(start_draws[pair_idx])
        nodes = panel.path_nodes[path_idx]
        true_counts[path_idx] += 1

        score = read_length + 10  # all-match + both full-length bonuses
        read_1 = {
            "sequence": "A" * read_length,
            "mapping_quality": mapq,
            "mapping": _mappings_for_interval(
                nodes, panel.node_lengths, start, read_length
            ),
            "score": score,
        }
        read_2 = {
            "sequence": "A" * read_length,
            "mapping_quality": mapq,
            "mapping": _reverse_interval_mappings(
                nodes, panel.node_lengths, start + frag_len - read_length, read_length
            ),
            "score": score,
        }
        if with_errors:
            import base64

            for read in (read_1, read_2):
                quals = _draw_qualities(rng, read_length)
                errs = rng.random(read_length) < 10.0 ** (
                    -quals.astype(np.float64) / 10.0
                )
                if errs.any():
                    _inject_errors(read["mapping"], np.flatnonzero(errs))
                read["quality"] = base64.b64encode(bytes(quals)).decode()
                read["score"] = _qual_adjusted_score(quals, errs)
                read["sequence"] = "".join(
                    "C" if e else "A" for e in errs
                )
                if multipath_dag:
                    from .scoring import QUAL_MATCH_SCORES, QUAL_SCORE_TENSOR

                    read["_dag_scores"] = np.where(
                        errs,
                        QUAL_SCORE_TENSOR[quals, 0, 1].astype(np.int64),
                        QUAL_MATCH_SCORES[quals].astype(np.int64),
                    )
                    read["_dag_quals"] = quals
        elif with_qualities:
            import base64

            for read in (read_1, read_2):
                quals = rng.integers(20, 41, size=read_length).astype(np.uint8)
                read["quality"] = base64.b64encode(bytes(quals)).decode()

        for read in (read_1, read_2):
            if as_multipath:
                record = None
                if multipath_dag:
                    record = _multipath_dag_record(
                        panel, read["mapping"], read_length,
                        read["mapping_quality"],
                        read.get("_dag_scores"), read.get("_dag_quals"),
                    )
                    if record is not None:
                        record["sequence"] = read["sequence"]
                        if "quality" in read:
                            record["quality"] = read["quality"]
                if record is None:
                    record = {
                        "sequence": read["sequence"],
                        "mapping_quality": read["mapping_quality"],
                        "start": [0],
                        "subpath": [
                            {"path": {"mapping": read["mapping"]}, "score": read["score"]}
                        ],
                    }
            else:
                record = {
                    "sequence": read["sequence"],
                    "mapping_quality": read["mapping_quality"],
                    "path": {"mapping": read["mapping"]},
                    "score": read["score"],
                }
            if "quality" in read:
                record["quality"] = read["quality"]
            if first:
                record["annotation"] = {
                    "fragment_length_distribution": f"-I {frag_mean} -D {frag_sd}"
                }
                first = False
            records.append(record)

    return records, true_counts
