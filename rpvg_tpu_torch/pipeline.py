"""End-to-end quantification pipeline of the port (counterpart of
``rpvg_tpu/pipeline.py``).

The framework-free host functions below the rewritten entry points are
verbatim copies of the JAX package's (relative imports made absolute);
tests/test_torch_slice.py pins every copy against its original.  They
are copied, not imported, because ``rpvg_tpu.pipeline`` imports jax.

Only :func:`run_pipeline` and :func:`run_inference_phases` are
rewritten: the device is passed down explicitly, there is no backend
probe or watchdog, ``RPVG_TPU_TORCH_PROFILE=<dir>`` takes the place
of the ``jax.profiler`` hook (a ``torch.profiler`` Chrome trace of the
batched dispatch per call), and their timings are spans
(:mod:`rpvg_tpu_torch.spans`).  :func:`collect_fragments` is the JAX
package's with spans and counters added (pinned with them stripped); a
single-process pass over an ``.rpa`` file takes the port's own
:func:`collect_fragments_flat` instead, which gives the same index.
Every configuration
of the JAX package runs: the four inference models, read-count Gibbs
sampling (``-n``), ``haplotypes`` and ``haplotype-transcripts`` at every
ploidy, ``--use-hap-gibbs`` and ``--ind-hap-inference``; the
multi-process entry points are in :mod:`rpvg_tpu_torch.parallel.multihost`.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rpvg_tpu_torch import fragment_pass, spans
from rpvg_tpu_torch.clustering import PathClusters, split_by_bounds
from rpvg_tpu_torch.constants import FRAG_LENGTH_MIN_MAPQ
from rpvg_tpu_torch.device import peak_memory_mib
from rpvg_tpu_torch.fragments import FragmentLengthDist
from rpvg_tpu_torch.graph import Graph, load_graph
from rpvg_tpu_torch.infer.estimates import PathClusterEstimates
from rpvg_tpu_torch.io import json_stream, writers
from rpvg_tpu_torch.io.info import parse_haplotype_transcript_info
from rpvg_tpu_torch.pathindex import PathIndex
from rpvg_tpu_torch.probabilities import PathInfo, ReadPathProbs
from rpvg_tpu_torch.projection import AlignmentPath, AlignmentPathFinder
from rpvg_tpu_torch.infer.batched_models import (
    batched_haplotype_transcripts,
    batched_haplotype_transcripts_independent,
    batched_haplotypes,
    batched_strains,
    batched_transcripts,
    supports_batched_nested,
    supports_batched_strains,
    supports_batched_transcripts,
)
from rpvg_tpu_torch.infer.estimators import make_estimator


# ------------------------------------------------- verbatim host functions


@dataclass
class PipelineConfig:
    graph: Union[str, Graph] = None
    paths: Union[str, PathIndex] = None
    alignments: Union[str, Iterable] = None
    output_prefix: str = "rpvg_tpu"
    inference_model: str = "transcripts"

    threads: int = 1
    rng_seed: int = 0
    library_type: str = "unstranded"
    single_path: bool = False
    single_end: bool = False
    long_reads: bool = False
    score_not_qual: bool = False

    frag_mean: Optional[float] = None
    frag_sd: Optional[float] = None
    max_num_sd_frag: int = 10

    write_probs: bool = False
    max_par_offset: int = 4
    max_score_diff: int = 20
    filt_best_score: float = 0.9
    use_allelic_mapq: bool = False
    min_noise_prob: float = 1e-4
    prob_precision: float = 1e-8
    path_node_cluster: bool = False

    ploidy: int = 2
    path_info: Optional[str] = None
    min_hap_prob: float = 0.001
    ind_hap_inference: bool = False
    use_hap_gibbs: bool = False

    num_gibbs_samples: int = 0
    max_em_its: int = 10000
    max_rel_em_conv: float = 0.001
    gibbs_thin_its: int = 25

    # "auto" = C++ kernels when the toolchain is available, else Python.
    native: str = "auto"

    def is_single_end(self) -> bool:
        return self.single_end or self.long_reads


def _mem_gb() -> float:
    """Peak RSS in gigabytes (the reference logs
    gbwt::inGigabytes(memoryUsage()) at each phase, src/main.cpp:640-649)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1024.0 * 1024.0)


def condense_alignment_paths(align_paths: List[AlignmentPath]) -> List[AlignmentPath]:
    """Collapse consecutive sorted entries with identical (search state,
    fragment length), keeping the first (reference
    addAlignmentPathsToBuffer, src/main.cpp:54-96)."""
    if not align_paths:
        return align_paths
    if len(align_paths) == 2:
        return align_paths
    out = [align_paths[0]]
    for ap in align_paths[1:]:
        prev = out[-1]
        if prev.search == ap.search and prev.frag_length == ap.frag_length:
            continue
        out.append(ap)
    return out


class FragmentIndex:
    """Deduplicated fragment alignment-path lists with multiplicities,
    plus the high-confidence fragment-length histogram (reference
    addAlignmentPathsBufferToIndexes, src/main.cpp:200-237)."""

    def __init__(self, pre_frag_length_dist: FragmentLengthDist, is_single_end: bool):
        # key -> (align_paths, count, raw_serialized_bytes | None)
        self.entries: Dict[tuple, Tuple[List[AlignmentPath], int, Optional[bytes]]] = {}
        self.frag_length_counts = np.zeros(
            pre_frag_length_dist.max_length + 1, dtype=np.int64
        )
        self.pre_loc = int(pre_frag_length_dist.loc)
        self.is_single_end = is_single_end
        self.unaligned_count = 0

    def add(self, align_paths: List[AlignmentPath]) -> None:
        if not align_paths:
            self.unaligned_count += 1
            return
        align_paths = condense_alignment_paths(align_paths)

        first = align_paths[0]
        if (
            not self.is_single_end
            and first.is_simple
            and first.min_mapq >= FRAG_LENGTH_MIN_MAPQ
            and first.frag_length < self.frag_length_counts.size
        ):
            self.frag_length_counts[first.frag_length] += 1

        if len(align_paths) == 2:
            # Unique hit: score/length carry no information; fragment
            # length standardised to the prior mean so all unique hits
            # on a path dedup together.
            first.score_sum = 1
            first.align_length = 1
            first.frag_length = self.pre_loc

        key = tuple(ap.key() for ap in align_paths)
        entry = self.entries.get(key)
        if entry is None:
            self.entries[key] = (align_paths, 1, None)
        else:
            self.entries[key] = (entry[0], entry[1] + 1, entry[2])

    def lists(self) -> List[Tuple[List[AlignmentPath], int]]:
        return list(self.entries.values())

    def merge_from(self, other: "FragmentIndex") -> None:
        """Fold another shard's index into this one: sum duplicate
        fragment-list counts, add histograms and unaligned counts (the
        cross-host reduction of the fragment pass)."""
        for key, (align_paths, count, raw) in other.entries.items():
            entry = self.entries.get(key)
            if entry is None:
                self.entries[key] = (align_paths, count, raw)
            else:
                self.entries[key] = (entry[0], entry[1] + count, entry[2])
        self.frag_length_counts += other.frag_length_counts
        self.unaligned_count += other.unaligned_count


FRAGMENT_BATCH_SIZE = 10000


class _NativeIndexerSession:
    """Drives the C++ project-and-index path: fragments are condensed,
    histogrammed and deduplicated natively; Python parses only the
    distinct lists once at the end."""

    def __init__(self, finder, pre_frag_length_dist: FragmentLengthDist, is_single_end: bool):
        self.finder = finder
        self.pre = pre_frag_length_dist
        self.is_single_end = is_single_end
        self.hist_size = pre_frag_length_dist.max_length + 1
        self.indexer = finder.create_indexer(
            self.hist_size, int(pre_frag_length_dist.loc), is_single_end
        )

    def add_payload(self, payload: bytes) -> None:
        self.finder.project_and_index(payload, self.indexer)

    def finish(self) -> FragmentIndex:
        return self.finish_columnar().to_fragment_index()

    def finish_columnar(self) -> "ColumnarFragmentIndex":
        cols = self.finder.dump_indexer_columnar(self.indexer, self.hist_size)
        self.finder.free_indexer(self.indexer)
        return ColumnarFragmentIndex(cols, self.pre, self.is_single_end)


class ColumnarFragmentIndex:
    """Deduplicated fragment index held as native column arrays (see
    native.ColumnarFragments) — the single-host fast path: clustering,
    partitioning and matrix-builder blob assembly run as array ops with
    no per-entry Python objects.  Falls back to a materialised
    FragmentIndex for consumers that need per-entry rows (probability
    writer, shard merging)."""

    def __init__(self, cols, pre_frag_length_dist: FragmentLengthDist,
                 is_single_end: bool):
        self.columnar = cols
        self.frag_length_counts = cols.histogram
        self.unaligned_count = cols.unaligned
        self.pre = pre_frag_length_dist
        self.is_single_end = is_single_end

    def num_entries(self) -> int:
        return len(self.columnar)

    def to_fragment_index(self) -> FragmentIndex:
        index = FragmentIndex(self.pre, self.is_single_end)
        # The native serialization is the canonical dedup key (stable
        # across shards); entries carry pre-located ids, so no per-path
        # Python parsing happens on this path.
        index.entries = {
            raw[8:]: (located, count, raw)
            for located, count, raw in self.columnar.entry_list()
        }
        index.frag_length_counts = self.frag_length_counts
        index.unaligned_count = self.unaligned_count
        return index


def run_fragment_pass(
    finder,
    fragments: Iterable,
    pre_frag_length_dist: FragmentLengthDist,
    is_single_end: bool,
    columnar: bool = False,
) -> FragmentIndex:
    """Project all fragments and index the results.  `fragments` yields
    Alignment/MultipathAlignment objects (single-end) or pairs.  A
    NativeFinder is driven in batches (the reference's 10k-fragment
    buffers, src/main.cpp:41); the Python engine per fragment."""
    if hasattr(finder, "project_and_index"):
        from rpvg_tpu_torch.native import serialize_fragments

        session = _NativeIndexerSession(finder, pre_frag_length_dist, is_single_end)
        batch = []
        for fragment in fragments:
            batch.append(fragment)
            if len(batch) == FRAGMENT_BATCH_SIZE:
                session.add_payload(serialize_fragments(batch))
                batch = []
        if batch:
            session.add_payload(serialize_fragments(batch))
        return session.finish_columnar() if columnar else session.finish()

    index = FragmentIndex(pre_frag_length_dist, is_single_end)
    if is_single_end:
        for aln in fragments:
            index.add(finder.find_alignment_paths(aln))
    else:
        for aln_1, aln_2 in fragments:
            index.add(finder.find_paired_alignment_paths(aln_1, aln_2))
    return index


def partition_fragments(
    paths_index: PathIndex,
    clusters: PathClusters,
    fragment_lists: Sequence[Tuple[List[AlignmentPath], int]],
) -> List[List[Tuple[List[AlignmentPath], int]]]:
    """Assign each distinct fragment list to its anchor path's cluster
    (reference src/main.cpp:731-754)."""
    per_cluster: List[List[Tuple[List[AlignmentPath], int]]] = [
        [] for _ in range(clusters.num_clusters())
    ]
    for entry in fragment_lists:
        align_paths = entry[0]
        if hasattr(align_paths, "anchor"):  # pre-located native entry
            anchor_path_id = align_paths.anchor
        else:
            anchor_path_id = int(paths_index.locate_cached(align_paths[0].search)[0])
        per_cluster[clusters.path_to_cluster[anchor_path_id]].append(entry)
    return per_cluster


@dataclass
class ClusterResult:
    cluster_id: int
    estimates: PathClusterEstimates
    cluster_probs: List[ReadPathProbs] = field(default_factory=list)


def _build_cluster_path_infos(
    config: PipelineConfig,
    paths_index: PathIndex,
    frag_length_dist: FragmentLengthDist,
    cluster_path_ids: np.ndarray,
    haplotype_info: Optional[Dict[str, PathInfo]],
    collapse_haps: bool,
    all_lengths: Optional[np.ndarray],
    all_eff_lengths: Optional[np.ndarray],
) -> Tuple[List[PathInfo], Dict[str, int]]:
    """PathInfo metadata (name, lengths, groups) for one cluster."""
    paths: List[PathInfo] = []
    group_name_index: Dict[str, int] = {}
    for pid in cluster_path_ids:
        pid = int(pid)
        name = paths_index.path_name(pid)
        if haplotype_info is None:
            info = PathInfo(name=name)
        else:
            info = haplotype_info[name].copy()
        info.length = (
            int(all_lengths[pid]) if all_lengths is not None
            else paths_index.path_length(pid)
        )
        if config.long_reads:
            info.effective_length = float(info.length)
        elif all_eff_lengths is not None:
            info.effective_length = float(all_eff_lengths[pid])
        else:
            info.effective_length = paths_index.effective_path_length(
                pid, frag_length_dist
            )
        if collapse_haps:
            group_name_index.setdefault(info.name, len(group_name_index))
        paths.append(info)
    return paths, group_name_index


def _clusters_meta(
    config: PipelineConfig,
    paths_index: PathIndex,
    frag_length_dist: FragmentLengthDist,
    cluster_path_id_lists: Sequence[np.ndarray],
    haplotype_info: Optional[Dict[str, PathInfo]],
    collapse_haps: bool,
    all_lengths: np.ndarray,
    all_eff_lengths: Optional[np.ndarray],
    id_concat: Optional[np.ndarray] = None,
    id_offsets: Optional[np.ndarray] = None,
):
    """Per-cluster PathInfos and the column arrays the native matrix
    builder needs (shared by the list- and columnar-input drivers).
    Equivalent to mapping _build_cluster_path_infos over the clusters,
    restructured as one pass with table lookups (each path id belongs
    to exactly one cluster, so PathInfos are constructed directly
    instead of copy-then-patch).  When the caller already holds the
    clusters' member ids concatenated (PathClusters.members_concat),
    the eff/length gathers run once over the concat and the native
    marshalling arrays are returned pre-concatenated (meta[6]) so the
    builder skips its 1-array-per-cluster concatenations."""
    names = getattr(paths_index, "names", None)
    if all_eff_lengths is not None:
        eff_table = all_eff_lengths
    elif config.long_reads:
        eff_table = all_lengths.astype(np.float64)
    else:
        eff_table = paths_index.all_effective_path_lengths(frag_length_dist)
    empty_fs = frozenset()

    eff_concat = None
    group_concat = None
    log_src_concat = None
    if id_concat is not None:
        eff_concat = eff_table[id_concat]
        len_concat = all_lengths[id_concat]
        # One whole-concat tolist each (the per-cluster loop then slices
        # plain lists — ~3x20k small ndarray.tolist calls hoisted).
        pids_list = id_concat.tolist()
        lens_list = len_concat.tolist()
        effl_list = eff_concat.tolist()
        off_list = id_offsets.tolist()
        if collapse_haps:
            group_concat = np.empty(id_concat.size, dtype=np.int32)
            log_src_concat = np.empty(id_concat.size, dtype=np.float64)

    if id_concat is not None and not collapse_haps:
        # Flat fast path: no per-cluster grouping state to carry, so the
        # PathInfo stream is built with whole-concat comprehensions and
        # each cluster is a slice of it.
        names_flat = (
            [names[p] for p in pids_list]
            if names is not None
            else [str(p + 1) for p in pids_list]
        )
        if haplotype_info is None:
            infos_flat = [
                PathInfo(name, 0, 1, empty_fs, length, eff)
                for name, length, eff in zip(names_flat, lens_list, effl_list)
            ]
        else:
            info_get = haplotype_info.__getitem__
            srcs = [info_get(name) for name in names_flat]
            infos_flat = [
                PathInfo(
                    src.name, src.group_id, src.source_count,
                    src.source_ids, length, eff,
                )
                for src, length, eff in zip(srcs, lens_list, effl_list)
            ]
        n = len(cluster_path_id_lists)
        pid_arrays = [id_concat[off_list[k] : off_list[k + 1]] for k in range(n)]
        effs = [eff_concat[off_list[k] : off_list[k + 1]] for k in range(n)]
        all_paths = [infos_flat[off_list[k] : off_list[k + 1]] for k in range(n)]
        return (
            all_paths, pid_arrays, effs, [None] * n, [0] * n, [None] * n,
            {
                "ids": id_concat,
                "offsets": np.ascontiguousarray(id_offsets, dtype=np.int64),
                "eff": eff_concat,
                "group_of": None,
                "log_src": None,
                # Flat output-row metadata for the native composers, in
                # the exact per-cluster PathInfo order, so write_outputs
                # can skip re-gathering name/length/eff from objects.
                "names": names_flat,
                "lens": len_concat,
            },
        )

    pid_arrays = []
    effs = []
    groups = []
    n_groups_list = []
    log_srcs = []
    all_paths = []
    for k, cluster_path_ids in enumerate(cluster_path_id_lists):
        if id_concat is not None:
            lo, hi = off_list[k], off_list[k + 1]
            pid_arrays.append(id_concat[lo:hi])
            effs.append(eff_concat[lo:hi])
            pids = pids_list[lo:hi]
            lens = lens_list[lo:hi]
            effl = effl_list[lo:hi]
        else:
            pid_arr = np.asarray(cluster_path_ids, dtype=np.int64)
            pid_arrays.append(pid_arr)
            eff_vec = eff_table[pid_arr]
            effs.append(eff_vec)
            pids = pid_arr.tolist()
            lens = all_lengths[pid_arr].tolist()
            effl = eff_vec.tolist()

        group_name_index: Dict[str, int] = {}
        paths = []
        if haplotype_info is None:
            for pid, length, eff in zip(pids, lens, effl):
                name = names[pid] if names is not None else str(pid + 1)
                if collapse_haps:
                    group_name_index.setdefault(name, len(group_name_index))
                paths.append(PathInfo(name, 0, 1, empty_fs, length, eff))
        else:
            for pid, length, eff in zip(pids, lens, effl):
                key = names[pid] if names is not None else str(pid + 1)
                src = haplotype_info[key]
                if collapse_haps:
                    group_name_index.setdefault(src.name, len(group_name_index))
                paths.append(
                    PathInfo(
                        src.name, src.group_id, src.source_count,
                        src.source_ids, length, eff,
                    )
                )

        if collapse_haps:
            if group_concat is not None:
                gview = group_concat[lo:hi]
                sview = log_src_concat[lo:hi]
                for j, info in enumerate(paths):
                    gview[j] = group_name_index[info.name]
                    sview[j] = info.source_count
                np.log(sview, out=sview)
                groups.append(gview)
                log_srcs.append(sview)
            else:
                groups.append(
                    np.array([group_name_index[info.name] for info in paths], dtype=np.int32)
                )
                log_srcs.append(
                    np.log(np.array([info.source_count for info in paths], dtype=np.float64))
                )
            n_groups_list.append(len(group_name_index))
            paths = _collapse_cluster_paths(paths, group_name_index)
        else:
            groups.append(None)
            n_groups_list.append(0)
            log_srcs.append(None)
        all_paths.append(paths)
    concats = None
    if id_concat is not None:
        concats = {
            "ids": id_concat,
            "offsets": np.ascontiguousarray(id_offsets, dtype=np.int64),
            "eff": eff_concat,
            "group_of": group_concat,
            "log_src": log_src_concat,
        }
    return all_paths, pid_arrays, effs, groups, n_groups_list, log_srcs, concats


def _run_native_matrix_build(
    config, finder, blobs, entry_counts, meta, frag_log_probs
):
    from rpvg_tpu_torch.infer.matrices import DenseCluster

    all_paths, pid_arrays, effs, groups, n_groups_list, log_srcs, concats = meta
    matrices = finder.build_cluster_matrices(
        blobs,
        entry_counts,
        pid_arrays,
        effs,
        groups,
        n_groups_list,
        log_srcs,
        frag_log_probs,
        config.is_single_end(),
        config.min_noise_prob,
        config.prob_precision,
        n_threads=config.threads,
        concats=concats,
    )
    return [
        (paths, DenseCluster(probs, noise, counts))
        for paths, (probs, noise, counts) in zip(all_paths, matrices)
    ]


def build_cluster_matrices_batched(
    config: PipelineConfig,
    paths_index: PathIndex,
    frag_length_dist: FragmentLengthDist,
    cluster_path_id_lists: Sequence[np.ndarray],
    cluster_fragment_lists: Sequence[Sequence],
    haplotype_info: Optional[Dict[str, PathInfo]],
    collapse_haps: bool,
    finder,
    frag_log_probs: np.ndarray,
    all_lengths: np.ndarray,
    all_eff_lengths: Optional[np.ndarray],
):
    """Dense probability matrices for EVERY cluster in one multithreaded
    native call.  Returns a list of (paths, DenseCluster) — the matrix
    is elementwise identical to what build_cluster_probs +
    construct_probability_matrix produce."""
    import struct as _struct

    blobs = []
    entry_counts = []
    for fragment_lists in cluster_fragment_lists:
        blobs.append(
            b"".join(
                _struct.pack("<Q", count) + raw[8:]
                for _, count, raw in fragment_lists
            )
        )
        entry_counts.append(len(fragment_lists))

    meta = _clusters_meta(
        config, paths_index, frag_length_dist, cluster_path_id_lists,
        haplotype_info, collapse_haps, all_lengths, all_eff_lengths,
    )
    return _run_native_matrix_build(
        config, finder, blobs, entry_counts, meta, frag_log_probs
    )


def build_cluster_matrices_columnar(
    config: PipelineConfig,
    paths_index: PathIndex,
    frag_length_dist: FragmentLengthDist,
    cluster_path_id_lists: Sequence[np.ndarray],
    cols,
    cluster_entry_idx: Sequence[np.ndarray],
    haplotype_info: Optional[Dict[str, PathInfo]],
    collapse_haps: bool,
    finder,
    frag_log_probs: np.ndarray,
    all_lengths: np.ndarray,
    all_eff_lengths: Optional[np.ndarray],
    prob_digits: Optional[int] = None,
    id_concat: Optional[np.ndarray] = None,
    id_offsets: Optional[np.ndarray] = None,
):
    """Columnar-input twin of build_cluster_matrices_batched: per-cluster
    blobs come from ONE vectorised byte gather over the native dump (the
    raw entries embed their final dedup counts — no shard merging has
    touched them on this path)."""
    entry_counts = [idx.size for idx in cluster_entry_idx]
    entry_order = (
        np.concatenate(cluster_entry_idx)
        if cluster_entry_idx else np.empty(0, dtype=np.int64)
    )
    blob_arr, lens = cols.gather_blob(entry_order)
    blob_offsets = np.zeros(len(cluster_entry_idx) + 1, dtype=np.int64)
    bounds = np.cumsum(entry_counts)
    byte_cum = np.concatenate(([0], np.cumsum(lens)))
    blob_offsets[1:] = byte_cum[bounds]

    meta = _clusters_meta(
        config, paths_index, frag_length_dist, cluster_path_id_lists,
        haplotype_info, collapse_haps, all_lengths, all_eff_lengths,
        id_concat=id_concat, id_offsets=id_offsets,
    )
    results = _run_native_matrix_build(
        config, finder, (blob_arr, blob_offsets), entry_counts, meta,
        frag_log_probs,
    )
    path_meta = None
    concats = meta[6]
    if concats is not None and "names" in concats:
        path_meta = (
            concats["names"], concats["lens"], concats["eff"],
            np.diff(concats["offsets"]),
        )
    if prob_digits is None:
        return results, None, path_meta
    # '-b': the same native row derivation, formatted as writer text.
    _, pid_arrays, effs, groups, n_groups_list, log_srcs, _ = meta
    texts = finder.format_prob_rows(
        (blob_arr, blob_offsets), entry_counts, pid_arrays, effs, groups,
        n_groups_list, log_srcs, frag_log_probs, config.is_single_end(),
        config.min_noise_prob, config.prob_precision, prob_digits,
        n_threads=config.threads,
        concats=meta[6],
    )
    return results, texts, path_meta


def build_cluster_probs(
    config: PipelineConfig,
    paths_index: PathIndex,
    frag_length_dist: FragmentLengthDist,
    cluster_path_ids: np.ndarray,
    fragment_lists: Sequence[Tuple[List[AlignmentPath], int, Optional[bytes]]],
    haplotype_info: Optional[Dict[str, PathInfo]],
    collapse_haps: bool,
    finder=None,
    frag_log_probs: Optional[np.ndarray] = None,
    all_lengths: Optional[np.ndarray] = None,
    all_eff_lengths: Optional[np.ndarray] = None,
) -> Tuple[List[PathInfo], List[ReadPathProbs]]:
    """Assemble PathInfos and deduplicated ReadPathProbs for one cluster
    (reference src/main.cpp:846-973).  When the native engine holds the
    serialized fragment lists, probability construction runs in C++."""
    clustered_path_index = {int(pid): i for i, pid in enumerate(cluster_path_ids)}

    paths, group_name_index = _build_cluster_path_infos(
        config, paths_index, frag_length_dist, cluster_path_ids,
        haplotype_info, collapse_haps, all_lengths, all_eff_lengths,
    )

    use_native = (
        finder is not None
        and hasattr(finder, "build_cluster_probs")
        and frag_log_probs is not None
        and fragment_lists
        and all(entry[2] is not None for entry in fragment_lists)
    )
    if use_native:
        import struct as _struct

        # Blobs embed the dedup count at serialization time; shard
        # merging may have summed counts since, so splice in the current
        # value.
        entry_blobs = b"".join(
            _struct.pack("<Q", count) + raw[8:]
            for _, count, raw in fragment_lists
        )
        group_of = None
        log_source_counts = None
        n_groups = 0
        if collapse_haps:
            group_of = np.array(
                [group_name_index[info.name] for info in paths], dtype=np.int32
            )
            log_source_counts = np.log(
                np.array([info.source_count for info in paths], dtype=np.float64)
            )
            n_groups = len(group_name_index)
        cluster_probs = finder.build_cluster_probs(
            entry_blobs,
            len(fragment_lists),
            cluster_path_ids,
            np.array([info.effective_length for info in paths]),
            frag_log_probs,
            config.is_single_end(),
            config.min_noise_prob,
            config.prob_precision,
            group_of,
            n_groups,
            log_source_counts,
        )
        if collapse_haps:
            paths = _collapse_cluster_paths(paths, group_name_index)
        return paths, cluster_probs

    cluster_probs: List[ReadPathProbs] = []
    for align_paths, count, _ in fragment_lists:
        align_paths_ids = [
            paths_index.locate_cached(ap.search) for ap in align_paths
        ]
        rpp = ReadPathProbs(count, config.prob_precision)
        rpp.add_path_probs(
            align_paths,
            align_paths_ids,
            clustered_path_index,
            paths,
            frag_length_dist,
            config.is_single_end(),
            config.min_noise_prob,
            collapse_haps,
            group_name_index,
        )
        cluster_probs.append(rpp)

    if collapse_haps:
        paths = _collapse_cluster_paths(paths, group_name_index)

    cluster_probs.sort(key=ReadPathProbs.sort_key)
    deduped: List[ReadPathProbs] = []
    for rpp in cluster_probs:
        if deduped and deduped[-1].quick_merge_identical(rpp):
            continue
        deduped.append(rpp)

    return paths, deduped


def _collapse_cluster_paths(
    paths: List[PathInfo], group_name_index: Dict[str, int]
) -> List[PathInfo]:
    """Merge per-transcript paths: lengths weighted by source counts
    (reference src/main.cpp:909-951)."""
    collapsed = [None] * len(group_name_index)
    for info in paths:
        g = group_name_index[info.name]
        if collapsed[g] is None:
            merged = info.copy()
            merged.length = info.length * info.source_count
            merged.effective_length = info.effective_length * info.source_count
            collapsed[g] = merged
        else:
            merged = collapsed[g]
            merged.source_count += info.source_count
            merged.length += info.length * info.source_count
            merged.effective_length += info.effective_length * info.source_count
    for merged in collapsed:
        merged.length = round(merged.length / merged.source_count)
        merged.effective_length /= merged.source_count
    return collapsed


def _is_gbwt_container(path: str) -> bool:
    """True when `path` starts with the gbwt::GBWT header tag (the
    reference's serialized panel input, src/main.cpp:616-629)."""
    import struct

    try:
        with open(path, "rb") as handle:
            head = handle.read(4)
    except OSError:
        return False
    from rpvg_tpu_torch.io.gbwt_file import GBWT_TAG

    return len(head) == 4 and struct.unpack("<I", head)[0] == GBWT_TAG


def load_inputs(config: PipelineConfig) -> Tuple[Graph, PathIndex]:
    graph = config.graph if isinstance(config.graph, Graph) else load_graph(config.graph)
    if isinstance(config.paths, PathIndex):
        paths_index = config.paths
    elif config.paths.endswith(".gbwt") or _is_gbwt_container(config.paths):
        paths_index = PathIndex.from_gbwt_file(config.paths, graph)
        # The reference auto-loads a `<paths>.ri` FastLocate sidecar when
        # present (src/main.cpp:616-631).  Our locate() is already a
        # vectorised searchsorted over the occurrence index, so the body
        # is validated-and-ignored; a bad magic still fails loudly.
        ri_path = config.paths + ".ri"
        if os.path.exists(ri_path):
            from rpvg_tpu_torch.io.gbwt_file import read_ri_header

            read_ri_header(ri_path)
            paths_index.has_r_index = True
    else:
        paths_index = PathIndex.from_json_file(config.paths, graph)
    assert paths_index.number_of_paths() > 0, "path index contains no paths"
    return graph, paths_index


def resolve_pre_fragment_dist(config: PipelineConfig) -> FragmentLengthDist:
    """Initial fragment-length parameters: unit for long reads, CLI
    values, or scanned from the alignment stream (reference
    src/main.cpp:514-551)."""
    if config.long_reads:
        return FragmentLengthDist.from_normal(1, 1, config.max_num_sd_frag)
    if config.frag_mean is not None and config.frag_sd is not None:
        return FragmentLengthDist.from_normal(
            config.frag_mean, config.frag_sd, config.max_num_sd_frag
        )
    if config.single_end:
        # Loud input validation (survives python -O); the reference
        # exits with a message for the same misconfiguration
        # (src/main.cpp:576-592).
        raise PipelineInputError(
            "--frag-mean and --frag-sd are required for single-end short reads"
        )
    assert isinstance(config.alignments, str)
    if config.alignments.endswith(".rpa"):
        from rpvg_tpu_torch.io.rpa import RpaReader

        reader = RpaReader(config.alignments)
        try:
            if reader.frag_sd > 0:
                return FragmentLengthDist.from_params(
                    reader.frag_mean, reader.frag_sd, 0.0, config.max_num_sd_frag
                )
            raise ValueError(
                "rpa header carries no fragment length parameters; "
                "use frag_mean/frag_sd"
            )
        finally:
            reader.close()
    from rpvg_tpu_torch.io.gam import is_gam_path, stream_gam_dicts

    if is_gam_path(config.alignments):
        dict_stream = stream_gam_dicts(
            config.alignments, None, not config.single_path
        )
    else:
        dict_stream = json_stream.stream_alignment_dicts(config.alignments)
    for obj in dict_stream:
        from rpvg_tpu_torch.alignments import _parse_annotation

        record = dict(obj)
        if "annotation" in record:
            record["annotation"] = _parse_annotation(record["annotation"])
        fld = record.get("fragment_length_distribution") or record.get(
            "fragmentLengthDistribution"
        )
        if fld:
            record["fragment_length_distribution"] = fld
        parsed = FragmentLengthDist.parse_alignment(record)
        if parsed is not None:
            return FragmentLengthDist.from_params(*parsed, 0.0, config.max_num_sd_frag)
    raise ValueError(
        "no fragment length distribution found in alignments; "
        "use frag_mean/frag_sd"
    )


def iter_fragments(config: PipelineConfig):
    if not isinstance(config.alignments, str):
        yield from config.alignments
        return
    from rpvg_tpu_torch.io.gam import is_gam_path, stream_gam_alignments

    if is_gam_path(config.alignments):
        it = stream_gam_alignments(config.alignments, not config.single_path)
        if config.is_single_end():
            yield from it
        else:
            while True:
                first = next(it, None)
                if first is None:
                    return
                yield first, next(it)  # interleaved mates
        return
    if config.is_single_end():
        yield from json_stream.stream_alignments(config.alignments, not config.single_path)
    else:
        yield from json_stream.stream_alignment_pairs(
            config.alignments, not config.single_path
        )


def build_finder(config: PipelineConfig, paths_index: PathIndex,
                 pre_frag_length_dist: FragmentLengthDist):
    """Construct the projection engine (native C++ kernels when
    available, else the Python engine)."""
    finder_kwargs = dict(
        library_type=config.library_type,
        score_not_qual=config.score_not_qual,
        use_allelic_mapq=config.use_allelic_mapq,
        max_pair_frag_length=pre_frag_length_dist.max_length,
        max_partial_offset=config.max_par_offset,
        est_missing_noise_prob=False,
        max_score_diff=config.max_score_diff,
        min_best_score_filter=config.filt_best_score,
    )
    if config.native in ("auto", "on"):
        from rpvg_tpu_torch import native as native_mod

        if native_mod.native_available():
            return native_mod.NativeFinder(
                paths_index, threads=config.threads, **finder_kwargs
            )
        if config.native == "on":
            raise RuntimeError("native projection requested but unavailable")
    return AlignmentPathFinder(paths_index, **finder_kwargs)


def collect_fragments(
    config: PipelineConfig,
    finder,
    pre_frag_length_dist: FragmentLengthDist,
    shard: int = 0,
    num_shards: int = 1,
    columnar: bool = False,
) -> FragmentIndex:
    """Fragment pass over this shard of the input (block-interleaved for
    rpa, fragment-interleaved otherwise).  Each host runs its own shard
    against a replicated index; results merge via
    FragmentIndex.merge_from."""
    if isinstance(config.alignments, str) and config.alignments.endswith(".rpa"):
        assert hasattr(finder, "project_payload"), (
            "binary .rpa input requires the native projection engine"
        )
        import queue
        import threading

        from rpvg_tpu_torch.io.rpa import RpaReader

        session = _NativeIndexerSession(
            finder, pre_frag_length_dist, config.is_single_end()
        )

        # Producer-consumer overlap (the reference's reader/indexer thread
        # split, src/main.cpp:654-693): a reader thread prefetches blocks
        # while the native engine (which releases the GIL) projects.
        block_queue: "queue.Queue" = queue.Queue(maxsize=4)

        header = RpaReader(config.alignments)
        assert header.is_paired == (not config.is_single_end()), (
            f"rpa file is {'paired' if header.is_paired else 'single-end'} "
            f"but the pipeline is configured otherwise"
        )
        assert header.is_multipath == (not config.single_path), (
            "rpa record type (multipath/single-path) does not match configuration"
        )
        header.close()

        run = spans.current_run()

        def read_blocks():
            reader = RpaReader(config.alignments)
            blocks = spans.each("rpvg.fragments.read", reader.blocks(), run)
            for block_idx, payload in enumerate(blocks):
                if block_idx % num_shards == shard:
                    block_queue.put(payload)
            reader.close()
            block_queue.put(None)

        reader_thread = threading.Thread(target=read_blocks, daemon=True)
        reader_thread.start()
        while True:
            with spans.Span("rpvg.fragments.wait"):
                payload = block_queue.get()
            if payload is None:
                break
            with spans.Span("rpvg.fragments.project"):
                session.add_payload(payload)
            spans.count("fragments.blocks")
            spans.count("fragments.bytes", len(payload))
        reader_thread.join()
        with spans.Span("rpvg.fragments.dump"):
            return session.finish_columnar() if columnar else session.finish()

    fragments = iter_fragments(config)
    if num_shards > 1:
        fragments = (
            fragment
            for i, fragment in enumerate(fragments)
            if i % num_shards == shard
        )
    return run_fragment_pass(
        finder, fragments, pre_frag_length_dist, config.is_single_end(),
        columnar=columnar,
    )


def submit_info_parse(config: PipelineConfig):
    """Kick the info-TSV parse onto a background thread, or None when
    the run has no info file.  The parse is independent of the fragment
    pass, whose native calls release the GIL — overlapping the two is
    free (the reference parses it between the read and inference
    passes, main.cpp:759).  Shared by the single-process and
    multiprocess drivers so the parse arguments cannot diverge."""
    if config.path_info is None:
        return None
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(
        parse_haplotype_transcript_info,
        config.path_info,
        config.inference_model == "haplotype-transcripts",
        config.inference_model == "transcripts",
    )
    pool.shutdown(wait=False)
    return future


class PipelineInputError(RuntimeError):
    """Unusable inputs detected mid-pipeline; the CLI prints the message
    and exits 1 instead of showing a traceback."""



# ------------------------------------------------------------ entry points


def collect_fragments_flat(
    config: PipelineConfig, finder, pre_frag_length_dist: FragmentLengthDist
) -> "ColumnarFragmentIndex":
    """:func:`collect_fragments`'s columnar index of a whole ``.rpa`` file,
    from one GIL-free native call (:mod:`rpvg_tpu_torch.fragment_pass`).
    Spans ``rpvg.fragments.project`` and ``.dump`` are the two calls;
    ``.read`` (the reader's seconds in reads) and ``.wait`` (the workers'
    mean seconds waiting for a block) come from the native clocks.
    Counters ``fragments.blocks``, ``.bytes``, ``.flat_pass`` (1) and
    ``.arena_bytes`` (the workers' peak arena bytes)."""
    from rpvg_tpu_torch.io.rpa import RpaReader

    header = RpaReader(config.alignments)
    header.close()
    if header.is_paired != (not config.is_single_end()):
        raise PipelineInputError(
            f"rpa file is {'paired' if header.is_paired else 'single-end'} "
            f"but the pipeline is configured otherwise"
        )
    if header.is_multipath != (not config.single_path):
        raise PipelineInputError(
            "rpa record type (multipath/single-path) does not match configuration"
        )
    with spans.Span("rpvg.fragments.project"):
        flat = fragment_pass.FlatPass(
            finder, config.alignments, pre_frag_length_dist.max_length + 1,
            int(pre_frag_length_dist.loc), config.is_single_end(),
        )
    stats = flat.stats
    run = spans.current_run()
    if run is not None:
        run.add("rpvg.fragments.read", stats.read_s, stats.read_s)
        run.add("rpvg.fragments.wait", stats.wait_s, stats.wait_s)
    spans.count("fragments.blocks", stats.blocks)
    spans.count("fragments.bytes", stats.bytes)
    spans.count("fragments.flat_pass")
    spans.count("fragments.arena_bytes", stats.arena_bytes)
    with spans.Span("rpvg.fragments.dump"):
        cols = flat.dump()
    return ColumnarFragmentIndex(cols, pre_frag_length_dist, config.is_single_end())


@contextlib.contextmanager
def _collector_held():
    """Automatic collections of the cyclic collector held for the block,
    and one collection of the young generations at its end (span
    ``rpvg.gc``, counter ``gc.collected``).  With the collector off,
    nothing the block allocates leaves generation 0, so that collection
    walks what the block made and still holds, and the caller's young
    objects, never the long-lived state: it frees the block's cycles and
    the caller's young ones.  Older garbage waits, as it would without
    the hold, for a full collection that the collector schedules itself
    between blocks.  A caller that disabled the collector (a pass inside
    a pass, one on another thread) keeps its own arrangement."""
    if not gc.isenabled():
        yield
        return
    # A full collection walks every tracked object the process holds
    # (the modules, the resident panel, the kernels: ~186,000 on a
    # benchmark pass), and a pass's allocations trip three of them only
    # to find the few hundred cyclic objects it made.
    gc.disable()
    try:
        yield
    finally:
        # Collected while the collector is still off: once on, it counts
        # the pass's allocations and would run a collection of its own at
        # the next one, leaving this one nothing to find.
        try:
            with spans.Span("rpvg.gc"):
                spans.count("gc.collected", gc.collect(1))
        finally:
            gc.enable()


def run_pipeline(config: PipelineConfig, device: torch.device) -> Dict:
    """Run the full pipeline with the device half on ``device``;
    returns summary stats, among them the seconds of the fragment pass,
    the matrix build, inference phases A-E (``phase_seconds``), the
    outputs and the whole run (``wall_seconds``, which includes the one
    collection of the pass's own garbage: :func:`_collector_held`), and
    the run's spans and counters (``spans``, ``counters``:
    :mod:`rpvg_tpu_torch.spans`)."""
    with spans.RunSpan("rpvg.pass") as whole:
        with _collector_held():
            stats = _run_pass(config, device, whole)
    stats["wall_seconds"] = whole.seconds
    stats.update(whole.run.summary())
    return stats


def _run_pass(config: PipelineConfig, device: torch.device, whole: spans.RunSpan) -> Dict:
    """The body of :func:`run_pipeline`, a frame of its own so that what
    it holds (the info parse, the finder, the fragment index) is freed
    before the end's collection walks what is left."""
    log = lambda msg: print(msg, file=sys.stderr)  # noqa: E731

    from rpvg_tpu_torch.native import set_thread_budget

    set_thread_budget(config.threads)

    with spans.Span("rpvg.load"):
        graph, paths_index = load_inputs(config)
    pre_frag_length_dist = resolve_pre_fragment_dist(config)
    # Phase-line parity with the reference (src/main.cpp:640-649).
    loaded_what = (
        "graph, GBWT and r-index"
        if getattr(paths_index, "has_r_index", False)
        else "graph and path index"
    )
    log(f"Loaded {loaded_what} ({whole.elapsed():.2f}s, {_mem_gb():.2f}GB)")

    with spans.Span("rpvg.finder"):
        finder = build_finder(config, paths_index, pre_frag_length_dist)

    info_future = submit_info_parse(config)

    with spans.Span("rpvg.fragments") as fragments:
        if fragment_pass.takes(config.alignments, finder):
            fragment_index = collect_fragments_flat(config, finder, pre_frag_length_dist)
        else:
            fragment_index = collect_fragments(
                config, finder, pre_frag_length_dist, columnar=True
            )
    num_entries = (
        fragment_index.num_entries()
        if isinstance(fragment_index, ColumnarFragmentIndex)
        else len(fragment_index.entries)
    )
    log(
        f"Found {num_entries} distinct alignment path lists and "
        f"{fragment_index.unaligned_count} unaligned reads "
        f"({fragments.seconds:.2f}s, {_mem_gb():.2f}GB)"
    )

    stats = run_inference_phases(
        config, paths_index, fragment_index, pre_frag_length_dist, device, log,
        finder=finder, info_future=info_future,
    )
    stats["fragment_pass_seconds"] = fragments.seconds
    return stats


_PROFILE_CALLS = itertools.count()


def _start_profile(device: torch.device):
    """``RPVG_TPU_TORCH_PROFILE=<dir>``: a ``torch.profiler`` session over
    the batched dispatch, the span the JAX package's
    ``RPVG_TPU_JAX_PROFILE`` traces, with host activity always and the
    card's (kernels, copies, sets on every stream) on ``cuda``.  Returns
    None, having called nothing, when the switch is unset."""
    profile_dir = os.environ.get("RPVG_TPU_TORCH_PROFILE")
    if not profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    session = profile(activities=activities)
    session.__enter__()
    return session, profile_dir


def _finish_profile(profile) -> None:
    """Stop the session and write its Chrome trace into the switch's
    directory, named by process id and call number: shards, ranks and
    forked workers each run the inference phases."""
    session, profile_dir = profile
    session.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    name = f"rpvg_torch_{os.getpid()}_{next(_PROFILE_CALLS)}.pt.trace.json"
    session.export_chrome_trace(os.path.join(profile_dir, name))


def run_inference_phases(
    config: PipelineConfig,
    paths_index: PathIndex,
    fragment_index: FragmentIndex,
    pre_frag_length_dist: FragmentLengthDist,
    device: torch.device,
    log=lambda msg: print(msg, file=sys.stderr),
    finder=None,
    cluster_filter=None,
    skip_outputs: bool = False,
    prob_collector: Optional[List] = None,
    info_future=None,
) -> Dict:
    """Everything downstream of the fragment index: distribution
    re-fit, clustering, the batched inference phases on ``device`` and
    the outputs.

    The distributed runner's hooks, as in the JAX package:
    ``cluster_filter(rank)`` keeps the cluster ranks this process owns;
    ``skip_outputs`` writes no file (the Gibbs samples stay on the
    results); ``prob_collector``, with ``skip_outputs`` and ``-b``,
    receives the formatted probability blocks as (rank, text)."""
    from rpvg_tpu_torch.native import set_thread_budget

    with spans.RunSpan("rpvg.inference"):
        set_thread_budget(config.threads)
        # The re-fit, the density table and the effective lengths.
        with spans.Span("rpvg.refit"):
            if config.is_single_end():
                frag_length_dist = pre_frag_length_dist
            else:
                frag_length_dist = FragmentLengthDist.from_counts(
                    fragment_index.frag_length_counts, skew_normal=True
                )
                if not frag_length_dist.is_valid():
                    if config.frag_mean is None:
                        raise PipelineInputError(
                            "too few unambiguous read pairs to re-estimate fragment "
                            "lengths; provide --frag-mean/--frag-sd (a multipath "
                            "alignment file read with --single-path yields no "
                            "aligned pairs at all)"
                        )
                    frag_length_dist = pre_frag_length_dist
                else:
                    log(
                        "Fragment length distribution re-estimated "
                        f"(loc: {frag_length_dist.loc:.4f}, "
                        f"scale: {frag_length_dist.scale:.4f}, "
                        f"shape: {frag_length_dist.shape:.4f})"
                    )

            frag_log_probs = frag_length_dist.log_prob_array(pre_frag_length_dist.max_length)
            all_lengths = paths_index.all_path_lengths()
            all_eff_lengths = (
                None if config.long_reads
                else paths_index.all_effective_path_lengths(frag_length_dist)
            )

        collapse_haps = config.inference_model == "transcripts" and config.path_info is not None

        estimator = make_estimator(
            config.inference_model,
            ploidy=config.ploidy,
            use_hap_gibbs=config.use_hap_gibbs,
            min_hap_prob=config.min_hap_prob,
            ind_hap_inference=config.ind_hap_inference,
            max_em_its=config.max_em_its,
            max_rel_em_conv=config.max_rel_em_conv,
            num_gibbs_samples=config.num_gibbs_samples,
            gibbs_thin_its=config.gibbs_thin_its,
            prob_precision=config.prob_precision,
        )

        # Clusters, the partition of the entries and the cluster order.
        with spans.Span("rpvg.clusters") as clustering:
            cols = None
            if isinstance(fragment_index, ColumnarFragmentIndex):
                # The columnar fast path requires the native matrix builder;
                # otherwise materialise the legacy index.
                if (
                    finder is not None
                    and hasattr(finder, "build_cluster_matrices")
                    and (not config.write_probs or hasattr(finder, "format_prob_rows"))
                ):
                    cols = fragment_index.columnar
                else:
                    fragment_index = fragment_index.to_fragment_index()

            if cols is not None:
                clusters = PathClusters.from_columnar(paths_index, cols)
                if config.path_node_cluster or collapse_haps:
                    clusters.add_node_clusters(paths_index)
                # Partition entries by their anchor's cluster with one stable
                # argsort (within-cluster order = dump order).
                entry_cluster = clusters.path_to_cluster[cols.anchors]
                cluster_sizes = np.bincount(
                    entry_cluster, minlength=clusters.num_clusters()
                )
                sort_idx = np.argsort(entry_cluster, kind="stable")
                entry_bounds = np.zeros(cluster_sizes.size + 1, dtype=np.int64)
                np.cumsum(cluster_sizes, out=entry_bounds[1:])
                entry_idx_per_cluster = split_by_bounds(sort_idx, entry_bounds)
                per_cluster = None
                all_sizes = cluster_sizes
            else:
                fragment_lists = fragment_index.lists()
                located_entries = bool(fragment_lists) and hasattr(fragment_lists[0][0], "anchor")
                if not located_entries and hasattr(paths_index, "locate_batch"):
                    paths_index.locate_batch(
                        ap.search for fl in fragment_lists for ap in fl[0]
                    )
                clusters = PathClusters(paths_index, [fl[0] for fl in fragment_lists])
                if config.path_node_cluster or collapse_haps:
                    clusters.add_node_clusters(paths_index)
                per_cluster = partition_fragments(paths_index, clusters, fragment_lists)
                all_sizes = np.fromiter(
                    (len(fl) for fl in per_cluster), np.int64, len(per_cluster)
                )

            # Clusters largest first, ties by descending index (the reference's
            # schedule); the rank becomes the output ClusterID.
            order = np.lexsort((np.arange(all_sizes.size), all_sizes))[::-1].tolist()
            # A process of a distributed run owns a subset of the cluster ranks
            # (the rank keys the random streams and is the ClusterID).
            owned_ranks = [
                rank for rank in range(len(order))
                if cluster_filter is None or cluster_filter(rank)
            ]
            order = [order[rank] for rank in owned_ranks]
        log(f"Clustered alignment paths ({clustering.seconds:.2f}s, {_mem_gb():.2f}GB)")

        haplotype_info = None
        if config.path_info is not None:
            # The parse started beside the fragment pass (submit_info_parse).
            with spans.Span("rpvg.info_wait"):
                haplotype_info = (
                    info_future.result()
                    if info_future is not None
                    else parse_haplotype_transcript_info(
                        config.path_info,
                        parse_haplotype_ids=config.inference_model == "haplotype-transcripts",
                        use_transcript_names=collapse_haps,
                    )
                )

        prob_writer = None
        if config.write_probs and not skip_outputs:
            prob_writer = writers.ProbabilityClusterWriter(
                config.output_prefix + "_probs", config.prob_precision,
                defer_publish=True,
            )
        gibbs_writer = None
        if (
            config.num_gibbs_samples > 0
            and config.inference_model != "haplotypes"
            and not skip_outputs
        ):
            gibbs_writer = writers.ReadCountGibbsSamplesWriter(
                config.output_prefix + "_gibbs", config.num_gibbs_samples,
                defer_publish=True,
            )

        try:
            with spans.Span("rpvg.matrices") as matrices:
                prob_digits = None
                if config.write_probs:
                    prob_digits = max(
                        writers.OUT_PRECISION_DIGITS,
                        math.ceil(-math.log10(config.prob_precision)),
                    )

                # Host half: per-cluster path metadata + probability matrices,
                # one multithreaded native call when the native engine holds
                # the fragments; ReadPathProbs objects per cluster otherwise.
                matrix_mode = cols is not None or (
                    not config.write_probs
                    and finder is not None
                    and hasattr(finder, "build_cluster_matrices")
                    and all(entry[2] is not None for fl in per_cluster for entry in fl)
                )
                prob_texts = None
                path_meta = None
                if cols is not None:
                    id_concat, id_offsets = clusters.members_concat(order)
                    matrix_results, prob_texts, path_meta = build_cluster_matrices_columnar(
                        config, paths_index, frag_length_dist,
                        split_by_bounds(id_concat, id_offsets), cols,
                        [entry_idx_per_cluster[ci] for ci in order],
                        haplotype_info, collapse_haps, finder, frag_log_probs,
                        all_lengths, all_eff_lengths,
                        prob_digits=prob_digits, id_concat=id_concat, id_offsets=id_offsets,
                    )
                    cluster_data = list(zip(owned_ranks, matrix_results))
                elif matrix_mode:
                    matrix_results = build_cluster_matrices_batched(
                        config, paths_index, frag_length_dist,
                        [clusters.cluster_to_paths[ci] for ci in order],
                        [per_cluster[ci] for ci in order],
                        haplotype_info, collapse_haps, finder, frag_log_probs,
                        all_lengths, all_eff_lengths,
                    )
                    cluster_data = list(zip(owned_ranks, matrix_results))
                else:
                    cluster_data = [
                        (
                            rank,
                            build_cluster_probs(
                                config, paths_index, frag_length_dist,
                                clusters.cluster_to_paths[cluster_idx],
                                per_cluster[cluster_idx], haplotype_info, collapse_haps,
                                finder=finder, frag_log_probs=frag_log_probs,
                                all_lengths=all_lengths, all_eff_lengths=all_eff_lengths,
                            ),
                        )
                        for rank, cluster_idx in zip(owned_ranks, order)
                    ]

            with spans.Span("rpvg.results"):
                # Native '-b' fast path: the formatted blocks exist before any
                # inference runs, so the writer thread compresses them during it.
                if prob_texts is not None:
                    for i, (rank, (paths, _)) in enumerate(cluster_data):
                        block = (
                            writers.probability_block_header(paths) + prob_texts[i]
                            if prob_texts[i]
                            else ""
                        )
                        if prob_writer is not None:
                            prob_writer.add_block(block)
                        elif prob_collector is not None and block:
                            prob_collector.append((rank, block))
                    if prob_writer is not None:
                        prob_writer.close_async()

                results: List[ClusterResult] = []
                batch_data = []
                batch_ranks = []
                for rank, (paths, cluster_probs) in cluster_data:
                    estimates = PathClusterEstimates()
                    estimates.paths = paths
                    batch_data.append((estimates, cluster_probs))
                    batch_ranks.append(rank)
                    results.append(ClusterResult(rank + 1, estimates))
            # The rank keys each cluster's random streams (-n, --use-hap-gibbs).
            seeded = (config.rng_seed, batch_ranks)
            profile = _start_profile(device)
            try:
                if supports_batched_nested(estimator) and estimator.infer_collapsed:
                    inference = batched_haplotype_transcripts(
                        estimator, batch_data, device, *seeded
                    )
                elif supports_batched_nested(estimator):
                    inference = batched_haplotype_transcripts_independent(
                        estimator, batch_data, device, *seeded
                    )
                elif supports_batched_strains(estimator):
                    inference = batched_strains(estimator, batch_data, device, *seeded)
                elif supports_batched_transcripts(estimator):
                    inference = batched_transcripts(estimator, batch_data, device, *seeded)
                else:
                    inference = batched_haplotypes(estimator, batch_data, device, *seeded)
            finally:
                # The trace is written even when the dispatch raises.
                if profile is not None:
                    _finish_profile(profile)

            with spans.Span("rpvg.results"):
                if prob_writer is not None and prob_texts is None:
                    for _, (paths, cluster_probs) in cluster_data:
                        prob_writer.add_cluster(cluster_probs, paths)
                    prob_writer.close_async()
                elif (
                    prob_collector is not None and prob_digits is not None
                    and prob_texts is None
                ):
                    for rank, (paths, cluster_probs) in cluster_data:
                        block = writers.format_probability_cluster_block(
                            cluster_probs, paths, prob_digits
                        )
                        if block:
                            prob_collector.append((rank, block))
            gibbs_writer_seconds = gibbs_join_seconds = 0.0
            if gibbs_writer is not None:
                with spans.Span("rpvg.gibbs_rows") as gibbs_rows:
                    for result in results:
                        gibbs_writer.add_samples(result.cluster_id, result.estimates)
                        result.estimates.gibbs_read_count_samples = []
                    gibbs_writer.finish_async(fragment_index.unaligned_count)
                gibbs_writer_seconds = gibbs_rows.seconds

            log(
                f"Inferred path posterior probabilities"
                f"{' and abundances' if config.inference_model != 'haplotypes' else ''} "
                f"({matrices.elapsed():.2f}s, {_mem_gb():.2f}GB)"
            )

            with spans.Span("rpvg.outputs") as outputs:
                if not skip_outputs:
                    # The native output composer reads the streams the route left
                    # (RPVG_TPU_COMPOSE_OUT=0: the object writers).
                    write_outputs(
                        config, results, fragment_index.unaligned_count,
                        columnar=getattr(estimator, "_columnar_outputs", None),
                        path_meta=path_meta,
                    )
            # Join both writers before publishing either; the wait for the
            # _gibbs.txt.gz thread's compression is timed on its own.
            with spans.Span("rpvg.publish"):
                if prob_writer is not None:
                    prob_writer.join()
                if gibbs_writer is not None:
                    with spans.Span("rpvg.gibbs_join") as gibbs_join:
                        gibbs_writer.join()
                    gibbs_join_seconds = gibbs_join.seconds
                for writer in (prob_writer, gibbs_writer):
                    if writer is not None:
                        writer.publish()
            peaks = peak_memory_mib(device)
        except BaseException:
            # Failure: no partial outputs under the real filenames.
            for writer in (prob_writer, gibbs_writer):
                if writer is not None:
                    writer.discard()
            _remove_partial_outputs(config)
            raise
    return {
        "num_fragment_lists": (
            fragment_index.num_entries()
            if isinstance(fragment_index, ColumnarFragmentIndex)
            else len(fragment_index.entries)
        ),
        "unaligned_reads": fragment_index.unaligned_count,
        "num_clusters": clusters.num_clusters(),
        "frag_length_dist": frag_length_dist,
        "results": results,
        "matrix_seconds": matrices.seconds,
        "output_seconds": outputs.seconds,
        # -n: collecting and formatting the _gibbs.txt.gz rows on the main
        # thread, then the wait for its writer thread after the outputs.
        "gibbs_writer_seconds": gibbs_writer_seconds,
        "gibbs_writer_join_seconds": gibbs_join_seconds,
        # Peak allocated device memory per data shard's device, and the
        # largest of them (MiB; empty and 0 on the CPU).
        "device_peak_mib": peaks,
        "device_peak_mib_max": max(peaks.values(), default=0.0),
        **inference,
    }


def _remove_partial_outputs(config: PipelineConfig) -> None:
    """Best-effort sweep of `.tmp` staging files after a failed run.

    AtomicTextHandle keeps partial data out of the real output names;
    this removes the abandoned staging files so a failed run leaves NO
    output artifacts at all (the reference cannot fail mid-inference on
    valid inputs — src/main.cpp:827-998 runs unconditionally on host —
    so any file it leaves is complete)."""
    prefix = config.output_prefix
    for name in (
        prefix + ".txt",
        prefix + "_joint.txt",
        prefix + "_probs.txt.gz",
        prefix + "_gibbs.txt.gz",
    ):
        try:
            os.remove(name + ".tmp")
        except OSError:
            pass


def compute_tpm_normalizer(results: Sequence[ClusterResult]) -> float:
    """Global sum of abundance / effective length over every group-set
    slot — the TPM denominator (reference src/main.cpp:1029-1057).  On a
    multi-host run this is the psum reduction point."""
    total = 0.0
    for result in results:
        est = result.estimates
        abundance_it = iter(est.abundances)
        for group_set in est.path_group_sets:
            for path in group_set:
                abundance = next(abundance_it)
                eff_len = est.paths[path].effective_length
                if eff_len > 0:
                    total += abundance / eff_len
    return total


def _write_hapjoint_columnar(
    config: PipelineConfig,
    results: Sequence[ClusterResult],
    unaligned_read_count: int,
    columnar: Dict,
    path_meta=None,
) -> bool:
    """Native composition of the haplotype-transcripts estimate files
    from the fused kernel's columnar set streams (byte-identical to the
    object writers; regression-pinned by tests).  Returns False to fall
    back to the object writers."""
    from rpvg_tpu_torch.native import compose_hapjoint_rows, tpm_normalizer_columnar

    # Every result contributes path rows (clusters with no probability
    # rows still list their paths with zero counts, like the object
    # writer); only `meta` clusters have set streams.  Slots whose EM
    # deferred to the device (hybrid accelerator runs) combined in
    # Python — splice those few clusters' sets from their estimates.
    meta = columnar["meta"]
    meta_arr = np.asarray(meta, dtype=np.int64)
    combined_mask = np.asarray(columnar["combined"], dtype=bool)
    n_sets_stream = np.asarray(columnar["n_sets"], dtype=np.int64)
    set_lens = columnar["set_lens"]
    set_posteriors = columnar["set_posteriors"]
    set_ids = columnar["set_ids"]
    set_abundances = columnar["set_abundances"]
    n_sets = np.zeros(len(results), dtype=np.int64)
    n_sets[meta_arr] = n_sets_stream
    if not combined_mask.all():
        set_bounds = np.zeros(len(meta) + 1, dtype=np.int64)
        np.cumsum(n_sets_stream, out=set_bounds[1:])
        slot_bounds = np.zeros(len(set_lens) + 1, dtype=np.int64)
        np.cumsum(set_lens, out=slot_bounds[1:])
        lens_segs, post_segs, ids_segs, ab_segs = [], [], [], []
        cursor_set = 0
        for i in np.flatnonzero(~combined_mask):
            cut = int(set_bounds[i])
            lens_segs.append(set_lens[cursor_set:cut])
            post_segs.append(set_posteriors[cursor_set:cut])
            ids_segs.append(set_ids[slot_bounds[cursor_set]:slot_bounds[cut]])
            ab_segs.append(
                set_abundances[slot_bounds[cursor_set]:slot_bounds[cut]]
            )
            cursor_set = cut
            est = results[meta[i]].estimates
            sets = est.path_group_sets
            n_sets[meta[i]] = len(sets)
            lens_segs.append(
                np.fromiter((len(gs) for gs in sets), np.int64, len(sets))
            )
            post_segs.append(np.asarray(est.posteriors, dtype=np.float64))
            ids_segs.append(
                np.fromiter((p for gs in sets for p in gs), np.int64)
            )
            ab_segs.append(np.asarray(est.abundances, dtype=np.float64))
        lens_segs.append(set_lens[cursor_set:])
        post_segs.append(set_posteriors[cursor_set:])
        ids_segs.append(set_ids[slot_bounds[cursor_set]:])
        ab_segs.append(set_abundances[slot_bounds[cursor_set]:])
        set_lens = np.concatenate(lens_segs)
        set_posteriors = np.concatenate(post_segs)
        set_ids = np.concatenate(ids_segs)
        set_abundances = np.concatenate(ab_segs)

    meta_rows = _gather_path_row_meta(results, path_meta)
    if meta_rows is None:
        return False
    names, lengths, effs, cids, n_paths = meta_rows

    total = tpm_normalizer_columnar(
        effs, n_paths, n_sets, set_lens, set_ids, set_abundances,
    )
    if total is None:
        return False

    composed = compose_hapjoint_rows(
        names, lengths, effs, cids, n_paths,
        n_sets, set_lens, set_posteriors, set_ids, set_abundances,
        ploidy=config.ploidy, min_posterior=config.prob_precision,
        total_transcript_count=total, threads=config.threads,
    )
    if composed is None:
        return False
    hap_text, joint_text = composed

    # Noise accumulation in the writers' exact order over ALL results.
    hap_noise = 0.0
    joint_noise = 0.0
    for result in results:
        hap_noise += result.estimates.noise_count
        joint_noise += result.estimates.noise_count / config.ploidy

    fmt = writers.fmt
    with writers.atomic_open(config.output_prefix + ".txt") as handle:
        handle.write(
            "Name\tClusterID\tLength\tEffectiveLength\tHaplotypeProbability\tReadCount\tTPM\n"
        )
        handle.write(hap_text)
        handle.write(
            f"Unknown\t0\t0\t0\t0\t{fmt(hap_noise + unaligned_read_count)}\t0\n"
        )
    header = [f"Name_{i + 1}" for i in range(config.ploidy)]
    header += ["ClusterID", "HaplotypingProbability"]
    for i in range(config.ploidy):
        header += [f"ReadCount_{i + 1}", f"TPM_{i + 1}"]
    unknown = ["Unknown"] * config.ploidy + ["0", "0"]
    for _ in range(config.ploidy):
        unknown += [fmt(joint_noise + unaligned_read_count / config.ploidy), "0"]
    with writers.atomic_open(config.output_prefix + "_joint.txt") as handle:
        handle.write("\t".join(header) + "\n")
        handle.write(joint_text)
        handle.write("\t".join(unknown) + "\n")
    return True


def _gather_path_row_meta(results: Sequence[ClusterResult], path_meta=None):
    """Flatten every result's path rows for the native output composers:
    (names, lengths, effs, cids, n_paths), or None when a name cannot be
    ASCII-encoded (composer fallback to the object writers).  When the
    columnar builder already emitted the flat (names, lens, effs,
    n_paths) in cluster order (`path_meta`), the per-object gather is
    skipped — the streams are the exact per-cluster PathInfo order."""
    if path_meta is not None:
        names, lengths, effs, n_paths = path_meta
        if (
            len(n_paths) == len(results)
            and len(names) == int(np.sum(n_paths))
            and names
            and all(name.isascii() for name in names)
        ):
            cids = [result.cluster_id for result in results]
            return names, lengths, effs, cids, n_paths
    names: List[str] = []
    lengths: List[int] = []
    effs: List[float] = []
    cids: List[int] = []
    n_paths: List[int] = []
    for result in results:
        est = result.estimates
        cids.append(result.cluster_id)
        n_paths.append(len(est.paths))
        for info in est.paths:
            names.append(info.name)
            lengths.append(info.length)
            effs.append(info.effective_length)
    try:
        if not names or not all(name.isascii() for name in names):
            return None
    except AttributeError:
        return None
    return names, lengths, effs, cids, n_paths


def _write_abundance_columnar(
    config: PipelineConfig,
    results: Sequence[ClusterResult],
    unaligned_read_count: int,
    columnar: Dict,
    path_meta=None,
) -> bool:
    """Native composition of the transcripts/strains estimate file from
    per-path abundance streams (singleton group sets after reset(P, 1);
    byte-identical to AbundanceEstimatesWriter, regression-pinned)."""
    from rpvg_tpu_torch.native import compose_abundance_rows, tpm_normalizer_perpath

    meta_rows = _gather_path_row_meta(results, path_meta)
    if meta_rows is None:
        return False
    names, lengths, effs, cids, n_paths = meta_rows
    noise_total = 0.0
    for result in results:
        noise_total += result.estimates.noise_count

    row_base = np.zeros(len(results) + 1, dtype=np.int64)
    np.cumsum(np.asarray(n_paths, dtype=np.int64), out=row_base[1:])
    abundances = np.zeros(int(row_base[-1]), dtype=np.float64)
    meta = columnar["meta"]
    if columnar["kind"] == "perpath":
        for ci, ab in zip(meta, columnar["ab"]):
            abundances[row_base[ci] : row_base[ci] + len(ab)] = ab
    else:  # cover: scatter per-cover abundances into the path rows
        for ci, cover, ab in zip(meta, columnar["covers"], columnar["ab"]):
            np.add.at(
                abundances,
                row_base[ci] + np.asarray(cover, dtype=np.int64),
                np.asarray(ab, dtype=np.float64),
            )

    eff_arr = np.asarray(effs, dtype=np.float64)
    total = tpm_normalizer_perpath(eff_arr, abundances)
    if total is None:
        return False
    text = compose_abundance_rows(
        names, lengths, eff_arr, abundances, cids, n_paths,
        total_transcript_count=total, threads=config.threads,
    )
    if text is None:
        return False

    with writers.atomic_open(config.output_prefix + ".txt") as handle:
        handle.write("Name\tClusterID\tLength\tEffectiveLength\tReadCount\tTPM\n")
        handle.write(text)
        handle.write(
            f"Unknown\t0\t0\t0\t{writers.fmt(noise_total + unaligned_read_count)}\t0\n"
        )
    return True


def write_outputs(
    config: PipelineConfig,
    results: Sequence[ClusterResult],
    unaligned_read_count: int,
    columnar: Optional[Dict] = None,
    path_meta=None,
) -> None:
    if config.inference_model == "haplotypes":
        writer = writers.JointHaplotypeEstimatesWriter(
            config.output_prefix, config.ploidy, config.prob_precision
        )
        for result in results:
            writer.add_estimates(result.cluster_id, result.estimates)
        writer.close()
        return

    compose_ok = columnar is not None and (
        os.environ.get("RPVG_TPU_COMPOSE_OUT", "1") != "0"
    )
    if (
        config.inference_model == "haplotype-transcripts"
        and compose_ok
        and columnar.get("kind") == "sets"
        and _write_hapjoint_columnar(
            config, results, unaligned_read_count, columnar, path_meta
        )
    ):
        return
    if (
        config.inference_model in ("transcripts", "strains")
        and compose_ok
        and columnar.get("kind") in ("perpath", "cover")
        and _write_abundance_columnar(
            config, results, unaligned_read_count, columnar, path_meta
        )
    ):
        return

    total_transcript_count = compute_tpm_normalizer(results)

    if config.inference_model == "haplotype-transcripts":
        hap_writer = writers.HaplotypeAbundanceEstimatesWriter(
            config.output_prefix, config.ploidy, total_transcript_count
        )
        joint_writer = writers.JointHaplotypeAbundanceEstimatesWriter(
            config.output_prefix + "_joint",
            config.ploidy,
            config.prob_precision,
            total_transcript_count,
        )
        for result in results:
            hap_writer.add_estimates(result.cluster_id, result.estimates)
            joint_writer.add_estimates(result.cluster_id, result.estimates)
        hap_writer.finish(unaligned_read_count)
        joint_writer.finish(unaligned_read_count)
    else:
        writer = writers.AbundanceEstimatesWriter(
            config.output_prefix, total_transcript_count
        )
        for result in results:
            writer.add_estimates(result.cluster_id, result.estimates)
        writer.finish(unaligned_read_count)


