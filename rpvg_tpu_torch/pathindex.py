"""Haplotype path index: a GBWT-equivalent substring index over the
pantranscriptome path panel.

Provides the search API the projection engine needs —
``find(node) -> SearchState``, ``extend(state, node)``, ``locate(state)``
— with the same semantics as the reference's GBWT/r-index facade
(reference/src/paths_index.cpp), but re-designed around flat
positional occurrence arrays instead of succinct rank/select structures:

* all path sequences (both orientations when bidirectional) are
  concatenated into one node array with endmarker separators;
* each oriented node maps to the sorted array of its occurrence
  positions (a ``find`` is one dict lookup);
* ``extend`` advances every occurrence by one position and keeps those
  whose successor matches — a single vectorised compare;
* ``locate`` maps positions to sequence ids with one searchsorted.

This trades memory (O(total path length) int32s) for branch-free
vectorised search, which is the right trade on a modern host feeding a
TPU, and makes the whole index trivially serialisable/replicable across
hosts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .constants import (
    ENDMARKER,
    double_compare,
    encode_node,
    flip_node,
    node_id,
)
from .fragments import FragmentLengthDist
from .graph import Graph
from . import mathutils as mu


class SearchState:
    """Set of occurrence positions of a (searched substring ending at)
    ``node`` inside the concatenated path panel.  Equivalent to a GBWT
    SearchState: ``size`` is the number of matching path occurrences."""

    __slots__ = ("node", "positions")

    def __init__(self, node: int = ENDMARKER, positions: Optional[np.ndarray] = None):
        self.node = node
        self.positions = (
            positions if positions is not None else np.empty(0, dtype=np.int64)
        )

    @property
    def size(self) -> int:
        return int(self.positions.size)

    def empty(self) -> bool:
        return self.positions.size == 0

    def key(self) -> tuple:
        return (self.node, self.positions.tobytes())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SearchState)
            and self.node == other.node
            and self.positions.size == other.positions.size
            and bool(np.all(self.positions == other.positions))
        )

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return f"SearchState(node={self.node}, size={self.size})"


@dataclass
class PathMetadata:
    name: str


class PathIndex:
    """Pantranscriptome path panel with vectorised search.

    Parameters
    ----------
    paths:
        One node sequence per path, as GBWT-encoded nodes
        (2 * node_id + is_reverse), in forward orientation.
    graph:
        Node length source.
    bidirectional:
        When True both orientations of every path are indexed (sequence
        2i forward / 2i+1 reverse), matching a bidirectional GBWT; path
        ids reported by :meth:`locate` are orientation-collapsed.
    """

    def __init__(
        self,
        paths: Sequence[Sequence[int]],
        graph: Graph,
        names: Optional[Sequence[str]] = None,
        bidirectional: bool = True,
    ):
        self.graph = graph
        self.is_bidirectional = bidirectional
        self.names = list(names) if names is not None else None
        self.num_paths = len(paths)

        sequences: List[np.ndarray] = []
        for path in paths:
            arr = np.asarray(path, dtype=np.int64)
            assert arr.size > 0 and np.all(arr != ENDMARKER)
            sequences.append(arr)
            if bidirectional:
                sequences.append(np.flip(arr) ^ 1)

        # Concatenate with endmarker separators so successor lookups are a
        # single index into `concat`.
        pieces = []
        seq_starts = np.empty(len(sequences), dtype=np.int64)
        offset = 0
        for i, seq in enumerate(sequences):
            seq_starts[i] = offset
            pieces.append(seq)
            pieces.append(np.array([ENDMARKER], dtype=np.int64))
            offset += seq.size + 1
        self.concat = (
            np.concatenate(pieces) if pieces else np.empty(0, dtype=np.int64)
        )
        self.seq_starts = seq_starts
        self._sequences = sequences

        # Occurrence lists per oriented node (positions sorted ascending).
        order = np.argsort(self.concat, kind="stable")
        sorted_nodes = self.concat[order]
        uniq, first = np.unique(sorted_nodes, return_index=True)
        boundaries = np.append(first, sorted_nodes.size)
        self._occ: Dict[int, np.ndarray] = {}
        for i, node in enumerate(uniq):
            if node == ENDMARKER:
                continue
            self._occ[int(node)] = np.sort(order[boundaries[i] : boundaries[i + 1]])

        # Outgoing edges per oriented node (successors incl. endmarker).
        self._edges: Dict[int, np.ndarray] = {}
        for node, positions in self._occ.items():
            self._edges[node] = np.unique(self.concat[positions + 1])

        self._path_length_cache: Dict[int, int] = {}
        self._locate_cache: Dict[tuple, np.ndarray] = {}

    # ----------------------------------------------------------- builders
    @classmethod
    def from_node_tuples(
        cls,
        paths: Sequence[Sequence[Tuple[int, bool]]],
        graph: Graph,
        names: Optional[Sequence[str]] = None,
        bidirectional: bool = True,
    ) -> "PathIndex":
        encoded = [[encode_node(nid, rev) for nid, rev in path] for path in paths]
        return cls(encoded, graph, names, bidirectional)

    @classmethod
    def from_gbwt_file(cls, path: str, graph: Graph) -> "PathIndex":
        """Load a serialized gbwt::GBWT (sdsl stream layout, the
        reference's `-p` input, reference/src/main.cpp:616-629):
        sequences are extracted by LF-walking the records, bidirectional
        indexes keep the forward orientation of each path pair, and path
        names come from the metadata with the reference's formatting
        (reference/src/paths_index.cpp:146-170)."""
        from .io.gbwt_file import GBWTFile

        gbwt = GBWTFile.read(path)
        sequences = gbwt.extract_all()
        paths = sequences[0::2] if gbwt.bidirectional else sequences
        names = None
        if gbwt.metadata is not None and gbwt.metadata.path_names:
            names = [
                gbwt.metadata.path_name_string(i) for i in range(len(paths))
            ]
        return cls(paths, graph, names, gbwt.bidirectional)

    def to_gbwt_file(self, path: str) -> None:
        """Serialize this panel as a gbwt::GBWT container (fixture
        writer; inverse of :meth:`from_gbwt_file`).  Path names are
        stored as metadata sample names (one sample per path, no contig
        names), which the reference formats back as the bare name."""
        from .io.gbwt_file import GBWTMetadata, build_gbwt

        meta = None
        if self.names is not None:
            meta = GBWTMetadata(
                sample_names=list(self.names),
                path_names=[(i, 0, 0, 0) for i in range(len(self.names))],
                haplotype_count=len(self.names),
            )
        build_gbwt(
            [seq.tolist() for seq in self._sequences],
            bidirectional=self.is_bidirectional,
            metadata=meta,
        ).write(path)

    @classmethod
    def from_json_file(cls, path: str, graph: Graph) -> "PathIndex":
        """Load from our native JSON panel format:
        {"bidirectional": bool, "paths": [{"name": str, "nodes": [[id, is_reverse], ...]}]}
        """
        import gzip

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as handle:
            obj = json.load(handle)
        names = [p.get("name", str(i + 1)) for i, p in enumerate(obj["paths"])]
        node_paths = [
            [(int(nid), bool(rev)) for nid, rev in p["nodes"]] for p in obj["paths"]
        ]
        return cls.from_node_tuples(
            node_paths, graph, names, bool(obj.get("bidirectional", True))
        )

    # ------------------------------------------------------------- queries
    def number_of_nodes(self) -> int:
        return self.graph.num_nodes()

    def has_node_id(self, nid: int) -> bool:
        return self.graph.has_node(nid)

    def node_length(self, nid: int) -> int:
        return self.graph.node_length(nid)

    def number_of_paths(self) -> int:
        return self.num_paths

    def find(self, node: int) -> SearchState:
        positions = self._occ.get(node)
        if positions is None:
            return SearchState(node)
        return SearchState(node, positions)

    def extend(self, state: SearchState, node: int) -> SearchState:
        if state.empty():
            return SearchState(node)
        advanced = state.positions + 1
        matched = advanced[self.concat[advanced] == node]
        return SearchState(node, matched)

    def edges(self, node: int) -> np.ndarray:
        """Distinct successor nodes of `node` across the panel (may
        include the endmarker for path-terminal nodes)."""
        return self._edges.get(node, np.empty(0, dtype=np.int64))

    def locate(self, state: SearchState) -> np.ndarray:
        """Sorted unique path ids containing the state's occurrences.

        For bidirectional indexes the orientation is collapsed
        (sequence id // 2) WITHOUT a second dedup pass, matching the
        reference facade (reference/src/paths_index.cpp:124-146)."""
        if state.empty():
            return np.empty(0, dtype=np.int64)
        seq_ids = np.searchsorted(self.seq_starts, state.positions, side="right") - 1
        seq_ids = np.unique(seq_ids)
        if self.is_bidirectional:
            seq_ids = seq_ids // 2
        return seq_ids

    def locate_batch(self, states: Iterable[SearchState]) -> None:
        """Fill the locate cache for every distinct state in ONE
        vectorised pass (one searchsorted + one global sort), instead of
        per-state numpy calls whose fixed overhead dominates on the tiny
        occurrence arrays typical of fragment search states."""
        todo: List[Tuple[tuple, SearchState]] = []
        for st in states:
            if st.empty():
                continue
            key = st.key()
            if key not in self._locate_cache:
                self._locate_cache[key] = None  # dedupe placeholder
                todo.append((key, st))
        if not todo:
            return

        lengths = np.fromiter(
            (st.positions.size for _, st in todo), dtype=np.int64, count=len(todo)
        )
        all_pos = np.concatenate([st.positions for _, st in todo])
        seg = np.repeat(np.arange(len(todo), dtype=np.int64), lengths)
        seq_ids = np.searchsorted(self.seq_starts, all_pos, side="right") - 1

        # Per-segment sorted unique via one global unique on the packed
        # (segment, seq) key; then the same single //2 collapse as
        # :meth:`locate` (no second dedup).
        num_seqs = len(self._sequences) + 1
        combined = np.unique(seg * num_seqs + seq_ids)
        seg_out = combined // num_seqs
        ids_out = combined % num_seqs
        if self.is_bidirectional:
            ids_out = ids_out // 2
        bounds = np.searchsorted(seg_out, np.arange(len(todo) + 1))
        for i, (key, _) in enumerate(todo):
            self._locate_cache[key] = ids_out[bounds[i] : bounds[i + 1]]

    def locate_cached(self, state: SearchState) -> np.ndarray:
        """Memoised locate: repeated fragments share search states, so
        the probability pass hits the same states many times (the job
        the reference's r-index accelerates)."""
        key = state.key()
        ids = self._locate_cache.get(key)
        if ids is None:
            ids = self.locate(state)
            self._locate_cache[key] = ids
        return ids

    def path_name(self, path_id: int) -> str:
        if self.names is None or path_id >= len(self.names):
            return str(path_id + 1)
        return self.names[path_id]

    def path_nodes(self, path_id: int) -> np.ndarray:
        seq_idx = path_id * 2 if self.is_bidirectional else path_id
        return self._sequences[seq_idx]

    def path_length(self, path_id: int) -> int:
        cached = self._path_length_cache.get(path_id)
        if cached is None:
            nodes = self.path_nodes(path_id)
            cached = int(self.graph.node_lengths[nodes >> 1].sum())
            self._path_length_cache[path_id] = cached
        return cached

    def all_path_lengths(self) -> np.ndarray:
        """Sequence lengths for every path in one vectorised pass."""
        lengths = np.empty(self.num_paths, dtype=np.int64)
        for pid in range(self.num_paths):
            cached = self._path_length_cache.get(pid)
            if cached is None:
                nodes = self.path_nodes(pid)
                cached = int(self.graph.node_lengths[nodes >> 1].sum())
                self._path_length_cache[pid] = cached
            lengths[pid] = cached
        return lengths

    def all_effective_path_lengths(
        self, fragment_length_dist: FragmentLengthDist
    ) -> np.ndarray:
        """Effective lengths for every path at once (vectorised over the
        distinct path lengths, which are few)."""
        lengths = self.all_path_lengths()
        unique_lengths = np.unique(lengths)
        table = {
            int(length): self._effective_length_for(int(length), fragment_length_dist)
            for length in unique_lengths
        }
        return np.array([table[int(length)] for length in lengths])

    def effective_path_length(
        self, path_id: int, fragment_length_dist: FragmentLengthDist
    ) -> float:
        return self._effective_length_for(self.path_length(path_id), fragment_length_dist)

    def _effective_length_for(
        self, path_length: int, fragment_length_dist: FragmentLengthDist
    ) -> float:
        """Path length minus the expected [1, L]-truncated fragment
        length, clamped to >= 1 (reference paths_index.cpp:190-219)."""
        if path_length == 0:
            return 0.0

        if double_compare(fragment_length_dist.shape, 0.0):
            loc, scale = fragment_length_dist.loc, fragment_length_dist.scale
            alpha = (1.0 - loc) / scale
            beta = (path_length - loc) / scale
            denom = mu.std_normal_cdf(beta) - mu.std_normal_cdf(alpha)
            with np.errstate(all="ignore"):
                trunc_mean = loc + scale * (
                    (mu.std_normal_pdf(alpha) - mu.std_normal_pdf(beta)) / denom
                    if denom != 0
                    else np.nan
                )
        else:
            try:
                trunc_mean = mu.truncated_skew_normal_expected_value(
                    fragment_length_dist.loc,
                    fragment_length_dist.scale,
                    fragment_length_dist.shape,
                    1.0,
                    float(path_length),
                )
            except ZeroDivisionError:
                trunc_mean = float("nan")

        if not np.isfinite(trunc_mean):
            return 1.0
        return max(1.0, path_length - trunc_mean)
