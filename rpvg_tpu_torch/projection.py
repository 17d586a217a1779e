"""Alignment -> haplotype-path projection engine.

Projects each read (or read pair) onto the haplotype panel by walking
its graph mappings node-by-node while narrowing a path-index search
state, supporting:

* single-path and multipath (subpath-DAG) alignments,
* partial/internal matches up to ``max_partial_offset`` bases at either
  read end with score penalties,
* paired-end merging via overlap scan plus a bounded DFS through the
  panel's out-edges,
* fr / rf / unstranded library types with lazy reverse complements,
* quality-adjusted scoring, allelic-MAPQ override, best-score-fraction
  and max-score-diff filters, and log-noise-score aggregation.

Behavioural contract: reference/src/alignment_path_finder.cpp and
src/alignment_path.cpp; every branch here has a counterpart there (cited
inline), re-expressed for this engine's positional search states.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .alignments import Alignment, GraphPath, Mapping, MultipathAlignment
from .constants import (
    ENDMARKER,
    INT32_MAX,
    INT32_MIN,
    MAX_NOISE_SCORE_DIFF,
    NOISE_SCORE_LOG_BASE,
    SCORE_LOG_BASE,
    double_compare,
    double_to_int,
)
from .mathutils import add_log
from .pathindex import PathIndex, SearchState
from .scoring import alignment_score, optimal_alignment_score

_LOWEST = float(INT32_MIN)


@dataclass
class InternalAlignment:
    is_internal: bool = False
    penalty: int = 0
    offset: int = 0
    max_offset: int = 0

    def copy(self) -> "InternalAlignment":
        return InternalAlignment(self.is_internal, self.penalty, self.offset, self.max_offset)

    def key(self) -> tuple:
        return (self.is_internal, self.penalty, self.offset, self.max_offset)


@dataclass
class AlignmentStats:
    """Per-read bookkeeping within a fragment's search."""

    score: int = 0
    length: int = 0
    complete: bool = False
    left_softclip: int = 0
    right_softclip: int = 0
    internal_start: InternalAlignment = field(default_factory=InternalAlignment)
    internal_end: InternalAlignment = field(default_factory=InternalAlignment)
    internal_end_next_node: int = ENDMARKER

    def copy(self) -> "AlignmentStats":
        return AlignmentStats(
            self.score,
            self.length,
            self.complete,
            self.left_softclip,
            self.right_softclip,
            self.internal_start.copy(),
            self.internal_end.copy(),
            self.internal_end_next_node,
        )

    def update_left_softclip(self, path: GraphPath) -> None:
        first_edit = path.mappings[0].edits[0]
        self.left_softclip = first_edit.to_length if first_edit.from_length == 0 else 0

    def update_right_softclip(self, path: GraphPath) -> None:
        last_edit = path.mappings[-1].edits[-1]
        self.right_softclip = last_edit.to_length if last_edit.from_length == 0 else 0

    def is_internal(self) -> bool:
        return self.internal_start.is_internal or self.internal_end.is_internal

    def internal_penalty(self) -> int:
        return self.internal_start.penalty + self.internal_end.penalty

    def max_internal_offset(self) -> int:
        return max(self.internal_start.offset, self.internal_end.offset)

    def adjusted_score(self) -> int:
        return self.score - self.internal_penalty()

    def clipped_left(self) -> int:
        return self.left_softclip + self.internal_start.offset

    def clipped_right(self) -> int:
        return self.right_softclip + self.internal_end.offset

    def clipped_total(self) -> int:
        return self.clipped_left() + self.clipped_right()

    def key(self) -> tuple:
        return (
            self.score,
            self.length,
            self.complete,
            self.left_softclip,
            self.right_softclip,
            self.internal_start.key(),
            self.internal_end.key(),
            self.internal_end_next_node,
        )


class SearchPath:
    """In-progress projection of a fragment onto the panel (the
    reference's AlignmentSearchPath, src/alignment_path.hpp:145-175)."""

    __slots__ = ("path", "search", "start_offset", "end_offset", "insert_length", "read_stats")

    def __init__(self):
        self.path: List[int] = []
        self.search: SearchState = SearchState()
        self.start_offset: int = 0
        self.end_offset: int = 0
        self.insert_length: int = 0
        self.read_stats: List[AlignmentStats] = []

    def copy(self) -> "SearchPath":
        dup = SearchPath()
        dup.path = list(self.path)
        dup.search = SearchState(self.search.node, self.search.positions)
        dup.start_offset = self.start_offset
        dup.end_offset = self.end_offset
        dup.insert_length = self.insert_length
        dup.read_stats = [s.copy() for s in self.read_stats]
        return dup

    def clear(self) -> None:
        """Drop the searched path (stats are kept; reference
        alignment_path.cpp:540-548)."""
        self.path = []
        self.search = SearchState()

    def alignment_length(self) -> int:
        stats = self.read_stats
        if len(stats) == 1:
            return stats[0].length - stats[0].clipped_total()
        return (
            stats[0].length
            + stats[-1].length
            - stats[0].clipped_total()
            - stats[-1].clipped_total()
        )

    def fragment_length(self) -> int:
        stats = self.read_stats
        if len(stats) == 1:
            if self.insert_length == 0:
                return stats[0].length
            frag = stats[0].length + self.insert_length
            return frag - stats[0].clipped_right()
        frag = stats[0].length + stats[-1].length + self.insert_length
        return frag - stats[0].clipped_right() - stats[-1].clipped_left()

    def score_sum(self) -> int:
        return sum(s.adjusted_score() for s in self.read_stats)

    def min_optimal_score_fraction(self, optimal_scores: Sequence[int]) -> float:
        frac = 1.0
        for stats, optimal in zip(self.read_stats, optimal_scores):
            frac = min(frac, stats.adjusted_score() / float(optimal))
        return max(0.0, frac)

    def is_complete(self) -> bool:
        return all(s.complete for s in self.read_stats)

    def is_internal(self) -> bool:
        return any(s.is_internal() for s in self.read_stats)

    def sort_key(self) -> tuple:
        """Ordering used before duplicate-path collapsing; ranks equal
        node paths by insert length, score then stats (reference
        alignment_path.cpp:565-621)."""
        return (
            len(self.path),
            tuple(self.path),
            self.insert_length,
            self.score_sum(),
            tuple(s.key() for s in self.read_stats),
            self.start_offset,
            self.end_offset,
        )


class AlignmentPath:
    """Finished search result for a fragment (reference
    src/alignment_path.hpp:22-39)."""

    __slots__ = ("search", "is_simple", "min_mapq", "score_sum", "align_length", "frag_length")

    def __init__(self, search, is_simple, min_mapq, score_sum, align_length, frag_length):
        self.search = search
        self.is_simple = is_simple
        self.min_mapq = min_mapq
        self.score_sum = score_sum
        self.align_length = align_length
        self.frag_length = frag_length

    @classmethod
    def from_search_path(cls, sp: SearchPath, is_simple: bool, min_mapq: int) -> "AlignmentPath":
        return cls(
            SearchState(sp.search.node, sp.search.positions),
            is_simple,
            min_mapq,
            sp.score_sum(),
            sp.alignment_length(),
            sp.fragment_length(),
        )

    def key(self) -> tuple:
        return (
            self.search.key(),
            self.is_simple,
            self.min_mapq,
            self.score_sum,
            self.align_length,
            self.frag_length,
        )

    def sort_key(self) -> tuple:
        # Field order mirrors reference operator< (alignment_path.cpp:111-154).
        return (
            self.search.node,
            self.search.key()[1],
            self.is_simple,
            self.min_mapq,
            self.frag_length,
            self.align_length,
            self.score_sum,
        )

    def __repr__(self):
        return (
            f"AlignmentPath(node={self.search.node}, n={self.search.size}, "
            f"simple={self.is_simple}, mapq={self.min_mapq}, score={self.score_sum}, "
            f"alen={self.align_length}, flen={self.frag_length})"
        )


def finalize_search_paths(
    search_paths: List[SearchPath], is_multimap: bool, min_mapq: int
) -> List[AlignmentPath]:
    """Convert completed search paths into AlignmentPaths, detect the
    "simple" property and append the trailing noise record (reference
    alignment_path.cpp:13-94)."""
    if not search_paths:
        return []

    is_simple = not is_multimap
    if is_simple:
        frag_length = 0
        for sp in search_paths:
            if sp.is_complete():
                if sp.is_internal() or (frag_length > 0 and sp.fragment_length() != frag_length):
                    is_simple = False
                    break
                frag_length = sp.fragment_length()

    align_paths: List[AlignmentPath] = []
    noise_prob = 1.0

    for sp in search_paths:
        if sp.search.empty():
            non_noise_prob = 1.0
            for stats in sp.read_stats:
                with _float_overflow_guard():
                    read_error_prob = 1.0 / (1.0 + _safe_exp(stats.score * NOISE_SCORE_LOG_BASE))
                non_noise_prob *= 1.0 - read_error_prob
            noise_prob = min(noise_prob, 1.0 - non_noise_prob)
        elif sp.is_complete():
            align_paths.append(AlignmentPath.from_search_path(sp, is_simple, min_mapq))

    align_paths.sort(key=AlignmentPath.sort_key, reverse=True)

    if align_paths:
        if double_compare(noise_prob, 0.0):
            noise_score = INT32_MIN
        else:
            noise_score = double_to_int(math.log(noise_prob) / NOISE_SCORE_LOG_BASE)
        align_paths.append(
            AlignmentPath(SearchState(), is_simple, min_mapq, noise_score, 0, 0)
        )

    return align_paths


def _safe_exp(x: float) -> float:
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf


class _float_overflow_guard:
    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


class AlignmentPathFinder:
    """Projection driver (reference AlignmentPathFinder,
    src/alignment_path_finder.hpp:19-95)."""

    def __init__(
        self,
        paths_index: PathIndex,
        library_type: str = "unstranded",
        score_not_qual: bool = False,
        use_allelic_mapq: bool = False,
        max_pair_frag_length: int = 1000,
        max_partial_offset: int = 4,
        est_missing_noise_prob: bool = False,
        max_score_diff: int = 20,
        min_best_score_filter: float = 0.9,
    ):
        assert library_type in ("unstranded", "fr", "rf")
        self.index = paths_index
        self.library_type = library_type
        self.score_not_qual = score_not_qual
        self.use_allelic_mapq = use_allelic_mapq
        self.max_pair_frag_length = max_pair_frag_length
        self.max_partial_offset = max_partial_offset
        self.est_missing_noise_prob = est_missing_noise_prob
        self.max_score_diff = max_score_diff
        self.min_best_score_filter = min_best_score_filter

    # ------------------------------------------------------------ helpers
    def _node_length(self, node_id: int) -> int:
        return self.index.node_length(node_id)

    def _mapping_quality(self, aln) -> int:
        mapq = aln.mapping_quality
        if self.use_allelic_mapq and "allelic_mapq" in aln.annotation:
            return min(int(aln.annotation["allelic_mapq"]), mapq)
        return mapq

    def _start_nodes(self, aln) -> List[int]:
        if isinstance(aln, MultipathAlignment):
            return [aln.subpaths[s].path.mappings[0].gbwt_node() for s in aln.start]
        return [aln.path.mappings[0].gbwt_node()]

    def _starts_in_graph(self, aln) -> bool:
        return all(self.index.has_node_id(node >> 1) for node in self._start_nodes(aln))

    @staticmethod
    def _is_disconnected(aln) -> bool:
        if isinstance(aln, MultipathAlignment):
            return "disconnected" in aln.annotation
        return False

    # ------------------------------------------------- public entry points
    def find_alignment_paths(self, aln) -> List[AlignmentPath]:
        """Single-end projection (reference :117-184)."""
        if not aln.has_path() or not self._starts_in_graph(aln):
            return []

        search_paths: List[SearchPath] = []
        if self.library_type == "fr":
            self._find_single_search_paths(search_paths, aln)
        elif self.library_type == "rf":
            self._find_single_search_paths(search_paths, aln.reverse_complement(self._node_length))
        else:
            self._find_single_search_paths(search_paths, aln)
            if not self.index.is_bidirectional:
                self._find_single_search_paths(
                    search_paths, aln.reverse_complement(self._node_length)
                )

        return finalize_search_paths(
            search_paths, self._is_disconnected(aln), self._mapping_quality(aln)
        )

    def find_paired_alignment_paths(self, aln_1, aln_2) -> List[AlignmentPath]:
        """Paired-end projection (reference :808-869)."""
        if not aln_1.has_path() or not aln_2.has_path():
            return []
        if not self._starts_in_graph(aln_1) or not self._starts_in_graph(aln_2):
            return []

        paired: List[SearchPath] = []
        if self.library_type == "fr":
            self._find_paired_search_paths(
                paired, aln_1, aln_2.reverse_complement(self._node_length)
            )
        elif self.library_type == "rf":
            self._find_paired_search_paths(
                paired, aln_2, aln_1.reverse_complement(self._node_length)
            )
        else:
            self._find_paired_search_paths(
                paired, aln_1, aln_2.reverse_complement(self._node_length)
            )
            if not self.index.is_bidirectional:
                self._find_paired_search_paths(
                    paired, aln_2, aln_1.reverse_complement(self._node_length)
                )

        is_multimap = self._is_disconnected(aln_1) or self._is_disconnected(aln_2)
        min_mapq = min(self._mapping_quality(aln_1), self._mapping_quality(aln_2))
        return finalize_search_paths(paired, is_multimap, min_mapq)

    # ----------------------------------------------- single-read extension
    def _extend_with_alignment(self, base: SearchPath, aln) -> List[SearchPath]:
        if isinstance(aln, MultipathAlignment):
            return self._extend_with_multipath(base, aln)
        return self._extend_with_single_path(base, aln)

    def _extend_with_single_path(self, base: SearchPath, aln: Alignment) -> List[SearchPath]:
        """Extend with a single-path alignment, producing the full +
        partial search paths (reference :186-253)."""
        optimal_score = optimal_alignment_score(aln.quality, len(aln.sequence), self.score_not_qual)
        seq_length = len(aln.sequence)

        paths = [base.copy()]
        stats = AlignmentStats()
        stats.score = aln.score
        stats.internal_start.max_offset = min(self.max_partial_offset, seq_length)
        stats.internal_end.max_offset = min(self.max_partial_offset, seq_length)
        paths[0].read_stats.append(stats)

        self._extend_with_path(paths, aln.path, True, True, aln.quality, seq_length, True)

        max_score = 0
        for sp in paths:
            if (sp.is_internal() or not self.est_missing_noise_prob) and sp.search.empty():
                continue
            if sp.read_stats[-1].length == seq_length:
                sp.read_stats[-1].complete = True
                max_score = max(max_score, sp.score_sum())

        for sp in paths:
            if sp.read_stats[-1].complete and max_score - sp.score_sum() > self.max_score_diff:
                sp.read_stats[-1].complete = False

        if self._below_best_score_filter(paths, [optimal_score]):
            paths.append(_make_error_sentinel(seq_length))
        return paths

    def _extend_with_path(
        self,
        paths: List[SearchPath],
        graph_path: GraphPath,
        is_first_path: bool,
        is_last_path: bool,
        quality: bytes,
        seq_length: int,
        add_internal_start: bool,
    ) -> None:
        """Walk one vg Path mapping-by-mapping, maintaining the main
        search plus partial-at-start/partial-at-end side searches
        (reference :255-535)."""
        assert len(paths) == 1 and paths[0].read_stats

        if is_first_path:
            paths[0].read_stats[-1].update_left_softclip(graph_path)
        if is_last_path:
            paths[0].read_stats[-1].update_right_softclip(graph_path)

        last_internal_start_idx = 0
        first_main_idx = 0
        mappings = graph_path.mappings
        n_mappings = len(mappings)

        for m_idx, mapping in enumerate(mappings):
            cur_node = mapping.gbwt_node()
            mapping_read_length = mapping.to_length()
            is_last_mapping = is_last_path and m_idx == n_mappings - 1

            # Select the "main" search for a potential partial-at-end match.
            main_path: Optional[SearchPath] = None
            if self.max_partial_offset > 0 and paths[0].path:
                while first_main_idx < len(paths):
                    candidate = paths[first_main_idx]
                    if candidate.search.empty() or candidate.read_stats[-1].internal_end.is_internal:
                        first_main_idx += 1
                        continue
                    if (
                        seq_length - candidate.read_stats[-1].length
                        <= candidate.read_stats[-1].internal_end.max_offset
                    ):
                        main_path = candidate.copy()
                    break

            for sp in paths:
                stats = sp.read_stats[-1]
                if stats.internal_end.is_internal:
                    delta = mapping_read_length
                    if is_last_mapping:
                        delta -= stats.right_softclip
                    stats.internal_end.offset += delta
                    if stats.internal_end.offset <= self.max_partial_offset:
                        stats.internal_end.penalty += alignment_score(
                            quality, stats.length, delta, self.score_not_qual
                        )
                    else:
                        sp.clear()
                else:
                    self._extend_with_mapping(sp, mapping)

            if main_path is not None:
                candidate = paths[first_main_idx]
                if main_path.search.size > candidate.search.size:
                    # Extension shrank the candidate: branch a partial
                    # match ending before this mapping.
                    mstats = main_path.read_stats[-1]
                    mstats.internal_end.is_internal = True
                    mstats.internal_end.offset = mapping_read_length
                    if is_last_mapping:
                        mstats.internal_end.offset -= mstats.right_softclip
                    if mstats.internal_end.offset <= self.max_partial_offset:
                        mstats.internal_end_next_node = cur_node
                        mstats.internal_end.penalty = alignment_score(
                            quality, mstats.length, mstats.internal_end.offset, self.score_not_qual
                        )
                        paths.append(main_path)

            if (
                self.max_partial_offset > 0
                and add_internal_start
                and len(paths[last_internal_start_idx].path) > 1
                and not paths[last_internal_start_idx].read_stats[-1].internal_end.is_internal
            ):
                anchor_stats = paths[last_internal_start_idx].read_stats[-1]
                if anchor_stats.length <= anchor_stats.internal_start.max_offset:
                    new_stats = anchor_stats.copy()
                    new_stats.internal_start.is_internal = True
                    new_stats.internal_start.offset = new_stats.length - new_stats.left_softclip
                    if new_stats.internal_start.offset <= self.max_partial_offset:
                        fresh = SearchPath()
                        self._extend_with_mapping(fresh, mapping)
                        if (
                            not fresh.search.empty()
                            and fresh.search.size > paths[last_internal_start_idx].search.size
                        ):
                            new_stats.internal_start.penalty = alignment_score(
                                quality,
                                new_stats.left_softclip,
                                new_stats.internal_start.offset,
                                self.score_not_qual,
                            )
                            fresh.read_stats = [new_stats]
                            paths.append(fresh)
                            last_internal_start_idx = len(paths) - 1

            for sp in paths:
                sp.read_stats[-1].length += mapping_read_length

    def _extend_with_mapping(self, sp: SearchPath, mapping: Mapping) -> None:
        """Node-level search-state extension with cycle-visit handling
        (reference :537-606)."""
        cur_node = mapping.gbwt_node()

        if not sp.path:
            sp.path.append(cur_node)
            sp.search = self.index.find(cur_node)
            sp.start_offset = mapping.offset
        else:
            is_cycle_visit = sp.path[-1] == cur_node and mapping.offset != sp.end_offset
            if is_cycle_visit and mapping.offset != 0:
                # Re-entering the same node mid-node: unsimplified input.
                sp.clear()
            elif sp.path[-1] != cur_node or is_cycle_visit:
                sp.path.append(cur_node)
                if not sp.search.empty():
                    sp.search = self.index.extend(sp.search, cur_node)

        sp.end_offset = mapping.offset + mapping.from_length()

    # ------------------------------------------------- multipath extension
    def _extend_with_multipath(
        self, base: SearchPath, aln: MultipathAlignment
    ) -> List[SearchPath]:
        """DFS over the subpath DAG with branch-and-bound pruning
        (reference :608-806)."""
        optimal_score = optimal_alignment_score(aln.quality, len(aln.sequence), self.score_not_qual)
        seq_length = len(aln.sequence)
        out: List[SearchPath] = []

        sink_softclips = []
        probe = AlignmentStats()
        for sp in aln.subpaths:
            if not sp.next:
                probe.update_right_softclip(sp.path)
                sink_softclips.append(probe.right_softclip)
        min_right_softclip = min(sink_softclips)
        max_right_softclip = max(sink_softclips)

        start_order = sorted(
            ((aln.subpaths[s].score, s) for s in aln.start), reverse=True
        )

        internal_node_subpaths: Dict[Tuple[int, int], int] = {}
        best_align_score = math.floor(optimal_score * self.min_best_score_filter)
        has_right_bonus = min_right_softclip == 0

        for _, start_idx in start_order:
            init = base.copy()
            init_stats = AlignmentStats()
            probe.update_left_softclip(aln.subpaths[start_idx].path)
            init_stats.internal_start.max_offset = min(
                probe.left_softclip + self.max_partial_offset, seq_length
            )
            init_stats.internal_end.max_offset = min(
                max_right_softclip + self.max_partial_offset, seq_length
            )
            init.read_stats.append(init_stats)

            best_align_score = self._multipath_dfs(
                out,
                init,
                aln,
                start_idx,
                seq_length,
                internal_node_subpaths,
                best_align_score,
                has_right_bonus,
            )

        for sp in out:
            if best_align_score - sp.score_sum() > self.max_score_diff:
                sp.read_stats[-1].complete = False

        if self._below_best_score_filter(out, [optimal_score]):
            out.append(_make_error_sentinel(seq_length))
        return out

    def _multipath_dfs(
        self,
        out: List[SearchPath],
        init: SearchPath,
        aln: MultipathAlignment,
        start_idx: int,
        seq_length: int,
        internal_node_subpaths: Dict[Tuple[int, int], int],
        best_align_score: int,
        has_right_bonus: bool,
    ) -> int:
        from .constants import FULL_LENGTH_BONUS

        stack: List[Tuple[SearchPath, int]] = [(init, start_idx)]

        while stack:
            sp, subpath_idx = stack.pop()
            sp = sp.copy()
            subpath = aln.subpaths[subpath_idx]
            stats = sp.read_stats[-1]
            stats.score += subpath.score

            subpath_length = sum(m.to_length() for m in subpath.path.mappings)
            seq_left = seq_length - (stats.length + subpath_length)

            max_score = stats.score + seq_left
            if has_right_bonus and subpath.next:
                max_score += FULL_LENGTH_BONUS
            if best_align_score - max_score > self.max_score_diff:
                continue

            add_internal_start = False
            if (
                self.max_partial_offset > 0
                and stats.length <= stats.internal_start.max_offset
            ):
                add_internal_start = True
                memo_key = (subpath_idx, stats.length - stats.left_softclip)
                prev = internal_node_subpaths.get(memo_key)
                if prev is not None:
                    if stats.score <= prev:
                        add_internal_start = False
                    else:
                        internal_node_subpaths[memo_key] = stats.score
                else:
                    internal_node_subpaths[memo_key] = stats.score
            elif sp.search.empty():
                if best_align_score - max_score > MAX_NOISE_SCORE_DIFF:
                    continue

            extended = [sp]
            self._extend_with_path(
                extended,
                subpath.path,
                subpath_idx == start_idx,
                not subpath.next,
                aln.quality,
                seq_length,
                add_internal_start,
            )

            for ext in extended:
                if ext.search.empty():
                    if ext.is_internal():
                        continue
                    if not self.est_missing_noise_prob and self.max_partial_offset == 0:
                        continue
                    if (
                        not self.est_missing_noise_prob
                        and ext.read_stats[-1].length
                        > ext.read_stats[-1].internal_start.max_offset
                    ):
                        continue

                if subpath.next:
                    for _, next_idx in sorted(
                        (aln.subpaths[n].score, n) for n in subpath.next
                    ):
                        stack.append((ext, next_idx))
                elif not subpath.connections:
                    best_align_score = max(best_align_score, ext.score_sum())
                    ext.read_stats[-1].complete = True
                    out.append(ext)

        return best_align_score

    # --------------------------------------------------- single-read lists
    def _find_single_search_paths(self, out: List[SearchPath], aln) -> None:
        """Extend one read, dedup by node path, accumulate joint log
        scores and append the per-read noise record (reference :871-932)."""
        candidates = self._extend_with_alignment(SearchPath(), aln)
        if not candidates:
            return

        candidates.sort(key=SearchPath.sort_key, reverse=True)

        joint_score = _LOWEST
        joint_empty_score = _LOWEST
        seq_length = len(aln.sequence)

        for i, sp in enumerate(candidates):
            if not sp.is_complete():
                continue
            assert sp.read_stats[-1].length == seq_length
            # Adjacent-duplicate collapse against the previous *sorted*
            # element (complete or not), as the reference does (:899-908).
            if i > 0 and sp.path == candidates[i - 1].path:
                continue

            score_sum = sp.score_sum()
            if sp.search.empty():
                joint_empty_score = add_log(joint_empty_score, score_sum * SCORE_LOG_BASE)
                continue
            if not sp.is_internal():
                joint_score = add_log(joint_score, score_sum * SCORE_LOG_BASE)
            out.append(sp)

        noise = SearchPath()
        noise_stats = AlignmentStats()
        noise_stats.score = double_to_int((joint_score - joint_empty_score) / NOISE_SCORE_LOG_BASE)
        noise.read_stats.append(noise_stats)
        out.append(noise)

    # ----------------------------------------------------- paired pipeline
    def _find_paired_search_paths(
        self, out: List[SearchPath], start_aln, end_aln
    ) -> None:
        """Pair completion: overlap-merge plus DFS extension through
        panel out-edges bounded by the max fragment length
        (reference :934-1198)."""
        start_candidates = self._extend_with_alignment(SearchPath(), start_aln)
        end_candidates = self._extend_with_alignment(SearchPath(), end_aln)
        if not start_candidates or not end_candidates:
            return

        start_candidates.sort(key=SearchPath.sort_key, reverse=True)
        end_candidates.sort(key=SearchPath.sort_key, reverse=True)

        end_seq_length = len(end_aln.sequence)
        start_seq_length = len(start_aln.sequence)

        num_unique_end = 0
        end_max_left_softclip = 0
        end_node_counts: Dict[int, int] = {}
        end_start_node_index: Dict[int, List[int]] = {}

        joint_end = _LOWEST
        joint_empty_end = _LOWEST

        for i, sp in enumerate(end_candidates):
            if not sp.is_complete():
                continue
            assert sp.read_stats[-1].length == end_seq_length
            if i > 0 and sp.path == end_candidates[i - 1].path:
                continue

            score_sum = sp.score_sum()
            if sp.search.empty():
                joint_empty_end = add_log(joint_empty_end, score_sum * SCORE_LOG_BASE)
                continue
            if not sp.is_internal():
                joint_end = add_log(joint_end, score_sum * SCORE_LOG_BASE)

            num_unique_end += 1
            end_max_left_softclip = max(end_max_left_softclip, sp.read_stats[-1].left_softclip)
            for node in sp.path:
                end_node_counts[node] = end_node_counts.get(node, 0) + 1
            end_start_node_index.setdefault(sp.path[0], []).append(i)

        # A cycle through any end-path start node breaks the "all end
        # paths seen" DFS shortcut (reference :1011-1026).
        end_alignment_in_cycle = False
        for node in end_start_node_index:
            state = self.index.find(node)
            if len(self.index.locate(state)) < state.size:
                end_alignment_in_cycle = True
                break

        stack: List[Tuple[SearchPath, bool]] = []

        joint_start = _LOWEST
        joint_empty_start = _LOWEST

        for i, sp in enumerate(start_candidates):
            if not sp.is_complete():
                continue
            assert sp.read_stats[-1].length == start_seq_length
            if i > 0 and sp.path == start_candidates[i - 1].path:
                continue

            score_sum = sp.score_sum()
            if sp.search.empty():
                joint_empty_start = add_log(joint_empty_start, score_sum * SCORE_LOG_BASE)
                continue
            if not sp.is_internal():
                joint_start = add_log(joint_start, score_sum * SCORE_LOG_BASE)

            node_length = self.index.node_length(sp.search.node >> 1)
            assert sp.end_offset <= node_length

            # Overlapping mates: merge the end path at every occurrence
            # of its start node inside the start path.
            for end_start_node, end_indices in end_start_node_index.items():
                search_from = 0
                while True:
                    try:
                        pos = sp.path.index(end_start_node, search_from)
                    except ValueError:
                        break
                    for end_idx in end_indices:
                        merged = sp.copy()
                        self._merge_paired(merged, pos, end_candidates[end_idx])
                        if (
                            not merged.search.empty()
                            and merged.fragment_length() <= self.max_pair_frag_length
                        ):
                            out.append(merged)
                    search_from = pos + 1

            extended = sp.copy()
            extended.insert_length += node_length - sp.end_offset
            extended.end_offset = node_length
            stack.append((extended, False))

        # DFS through panel out-edges until the mate's start node.
        while stack:
            cur, try_complete = stack.pop()

            if try_complete:
                end_indices = end_start_node_index.get(cur.path[-1])
                if end_indices is not None:
                    for end_idx in end_indices:
                        merged = cur.copy()
                        merged.insert_length -= merged.end_offset
                        merged.end_offset = end_candidates[end_idx].start_offset
                        merged.insert_length += merged.end_offset
                        self._merge_paired(merged, len(cur.path) - 1, end_candidates[end_idx])
                        if (
                            not merged.search.empty()
                            and merged.fragment_length() <= self.max_pair_frag_length
                        ):
                            out.append(merged)

            if not end_alignment_in_cycle:
                if end_node_counts.get(cur.path[-1]) == num_unique_end:
                    continue

            if (
                cur.fragment_length() + end_seq_length - end_max_left_softclip
                > self.max_pair_frag_length
            ):
                continue

            blocked_node = cur.read_stats[-1].internal_end_next_node
            for succ in self.index.edges(cur.search.node):
                succ = int(succ)
                if succ == ENDMARKER or succ == blocked_node:
                    continue
                new_search = self.index.extend(cur.search, succ)
                if new_search.empty():
                    continue
                nxt = cur.copy()
                nxt.path.append(succ)
                nxt.search = new_search
                nxt.end_offset = self.index.node_length(succ >> 1)
                nxt.insert_length += nxt.end_offset
                nxt.read_stats[-1].internal_end_next_node = ENDMARKER
                stack.append((nxt, True))

        noise = SearchPath()
        stats_1 = AlignmentStats()
        stats_1.score = double_to_int((joint_start - joint_empty_start) / NOISE_SCORE_LOG_BASE)
        stats_2 = AlignmentStats()
        stats_2.score = double_to_int((joint_end - joint_empty_end) / NOISE_SCORE_LOG_BASE)
        noise.read_stats = [stats_1, stats_2]
        out.append(noise)

    def _merge_paired(
        self, main: SearchPath, main_start_idx: int, second: SearchPath
    ) -> None:
        """Merge the mate's search path onto the fragment's path starting
        at main.path[main_start_idx], adjusting the insert length for the
        overlap (reference :1200-1329).  Clears `main` on inconsistency."""
        if len(second.path) < len(main.path) - main_start_idx:
            main.clear()
            return

        main_stats = main.read_stats[-1]
        second_stats = second.read_stats[0]

        if main_start_idx == 0:
            main_left = main.start_offset - main_stats.clipped_left()
            second_left = second.start_offset - second_stats.clipped_left()
            if second_left < main_left:
                main.clear()
                return

        second_idx = 0
        idx = main_start_idx
        n_main = len(main.path)

        while idx < n_main:
            if main.path[idx] != second.path[second_idx]:
                main.clear()
                return

            if idx + 1 == n_main:
                if second_idx + 1 == len(second.path):
                    main_right = main.end_offset + main_stats.clipped_right()
                    second_right = second.end_offset + second_stats.clipped_right()
                    if second_right < main_right:
                        main.clear()
                        return
                    if idx == 0:
                        main.insert_length += max(
                            main.start_offset, second.start_offset
                        ) - min(main.end_offset, second.end_offset)
                    elif second_idx == 0:
                        main.insert_length += second.start_offset - min(
                            main.end_offset, second.end_offset
                        )
                    else:
                        main.insert_length -= min(main.end_offset, second.end_offset)
                elif second_idx == 0:
                    main.insert_length += second.start_offset - main.end_offset
                else:
                    main.insert_length -= main.end_offset
            elif second_idx == 0:
                node_length = self.index.node_length(main.path[idx] >> 1)
                if idx == 0:
                    main.insert_length -= node_length - max(
                        main.start_offset, second.start_offset
                    )
                else:
                    main.insert_length -= node_length - second.start_offset
            else:
                main.insert_length -= self.index.node_length(main.path[idx] >> 1)

            idx += 1
            second_idx += 1

        main.end_offset = second.end_offset
        main.read_stats.append(second.read_stats[0].copy())

        while second_idx < len(second.path):
            main.path.append(second.path[second_idx])
            main.search = self.index.extend(main.search, main.path[-1])
            if main.search.empty():
                break
            second_idx += 1

    # ------------------------------------------------------------- filters
    def _below_best_score_filter(
        self, paths: List[SearchPath], optimal_scores: List[int]
    ) -> bool:
        """True when the best complete path is below the best-score
        fraction of optimal (reference :1416-1437)."""
        best_frac = 0.0
        for sp in paths:
            if sp.is_complete():
                best_frac = max(best_frac, sp.min_optimal_score_fraction(optimal_scores))
        return best_frac < self.min_best_score_filter


def _make_error_sentinel(seq_length: int) -> SearchPath:
    """Marker search path flagging a fragment whose alignments were all
    filtered; drives the downstream noise probability to one
    (reference :238-250)."""
    sentinel = SearchPath()
    sentinel.path.append(ENDMARKER)
    stats = AlignmentStats()
    stats.score = INT32_MAX
    stats.length = seq_length
    stats.complete = True
    sentinel.read_stats.append(stats)
    return sentinel
