"""The reference fragment pass: every read pair of an ``.rpa`` file
decoded here, placed on the panel's paths, and indexed as rpvg indexes
it (``src/alignment_path_finder.cpp``, ``src/alignment_path.cpp``,
``src/main.cpp:54-237``).  Written for this benchmark from those
semantics; it shares no code with the program.

What rpvg does by searching its path index mate by mate, this does by
placing each read's alignments on the paths that hold them:

1. Each read's **interpretations** (:func:`interpretations`): every walk
   through its subpath graph, scored by its subpaths; beside it, where
   the first (last) node visit covers at most ``MAX_PARTIAL_OFFSET``
   bases and more paths hold the walk without it, the walk without that
   visit (a partial match, its bases a penalty off the score, rpvg's
   internal start and end).  Walks no path holds are dropped, then
   those more than ``MAX_SCORE_DIFF`` below the best; one per node walk
   stays, the best scored.
2. A **fragment** is the first read's interpretation and the second
   read's (reverse complement) placed on one path, the second starting
   at or after the first and reaching at least its end, the fragment at
   most the pre-set distribution's maximum length long.  Each distinct
   node walk the pair covers is one alignment path, holding every path
   that contains that walk, with the pair's score, aligned length and
   fragment length.
3. The alignment paths of one pair: a trailing noise record from the
   reads' scores; alignment paths whose paths and fragment length agree
   merged (the longest alignment kept); a pair with one alignment path
   left standardised; unique unambiguous pairs' fragment lengths
   counted for the re-fit; identical lists counted once.

The reference runs only the settings of this benchmark's
configurations (scores without base qualities, unstranded, no allelic
mapping quality, no missing-path noise estimate) and refuses others.

Blocks of the file are spread over worker processes (``spawn``), each
loading the panel once (:class:`Workers`)."""

from __future__ import annotations

import math
import multiprocessing
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from bench_port.reference.panel import Panel

MAGIC = b"RPATPU01"
SCORE_LOG_BASE = 1.383325268738
NOISE_SCORE_LOG_BASE = 1e-6
FULL_LENGTH_BONUS = 5
MAX_PARTIAL_OFFSET = 4
MAX_SCORE_DIFF = 20
MIN_BEST_SCORE_FRACTION = 0.9
FRAG_LENGTH_MIN_MAPQ = 30
INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)
LOWEST = float(INT32_MIN)

# One alignment path as it crosses between processes: (path ids, is the
# noise record, is_simple, min_mapq, score, aligned length, fragment length).
CompactPath = Tuple[Tuple[int, ...], bool, bool, int, int, int, int]


def read_header(path: str) -> Tuple[bool, bool, float, float]:
    with open(path, "rb") as handle:
        if handle.read(8) != MAGIC:
            raise ValueError(f"not an rpa file: {path}")
        multipath, paired, frag_mean, frag_sd = struct.unpack("<BBdd", handle.read(18))
    return bool(multipath), bool(paired), frag_mean, frag_sd


def block_spans(path: str) -> List[Tuple[int, int]]:
    """(offset, length) of every payload of the file."""
    spans = []
    with open(path, "rb") as handle:
        handle.seek(8 + 18)
        while True:
            header = handle.read(8)
            if not header:
                return spans
            if len(header) != 8:
                raise ValueError("truncated rpa block header")
            (length,) = struct.unpack("<q", header)
            spans.append((handle.tell(), length))
            handle.seek(length, 1)


def max_fragment_length(frag_mean: float, frag_sd: float) -> int:
    """The pre-set distribution's maximum: mean + 10 sd, rounded up
    (``src/fragment_length_dist.cpp``)."""
    return int(math.ceil(frag_mean + 10.0 * frag_sd))


# --- reads ---------------------------------------------------------------

class Mapping(NamedTuple):
    node: int            # 2 * id + is_reverse
    offset: int
    from_length: int     # bases of the node
    to_length: int       # bases of the read
    left_clip: int       # read bases before the node (a leading insertion)
    right_clip: int


class Subpath(NamedTuple):
    score: int
    next: Tuple[int, ...]
    mappings: Tuple[Mapping, ...]


class Read(NamedTuple):
    length: int
    mapq: int
    starts: Tuple[int, ...]
    subpaths: Tuple[Subpath, ...]


def _decode_read(data: bytes, pos: int) -> Tuple[Read, int]:
    length, mapq, allelic_mapq, disconnected, has_quality = struct.unpack_from("<iiiBB", data, pos)
    pos += 14
    if disconnected:
        raise ValueError("disconnected multipath reads are not in this benchmark's traffic")
    pos += length if has_quality else 0
    n_subpaths, n_starts = struct.unpack_from("<ii", data, pos)
    pos += 8
    starts = struct.unpack_from(f"<{n_starts}i", data, pos)
    pos += 4 * n_starts
    subpaths = []
    for _ in range(n_subpaths):
        score, n_conn, n_next = struct.unpack_from("<iii", data, pos)
        pos += 12
        if n_conn:
            raise ValueError("subpath connections are not in this benchmark's traffic")
        nxt = struct.unpack_from(f"<{n_next}i", data, pos)
        pos += 4 * n_next
        (n_mappings,) = struct.unpack_from("<i", data, pos)
        pos += 4
        mappings = []
        for _ in range(n_mappings):
            node, offset, to_len, from_len, f_from, f_to, l_from, l_to = struct.unpack_from(
                "<qiiiiiii", data, pos)
            pos += 36
            mappings.append(Mapping(node, offset, from_len, to_len,
                                    f_to if f_from == 0 else 0, l_to if l_from == 0 else 0))
        subpaths.append(Subpath(score, nxt, tuple(mappings)))
    return Read(length, mapq, starts, tuple(subpaths)), pos


def decode_pairs(payload: bytes) -> List[Tuple[Read, Read]]:
    """The paired multipath reads of one block."""
    (n,) = struct.unpack_from("<i", payload, 0)
    pos = 4
    pairs = []
    for _ in range(n):
        if payload[pos] != 3:
            raise ValueError(f"fragment kind {payload[pos]}: only paired multipath reads are read")
        first, pos = _decode_read(payload, pos + 1)
        second, pos = _decode_read(payload, pos)
        pairs.append((first, second))
    return pairs


def reverse_complement(read: Read, panel: Panel) -> Read:
    """The read as the other strand sees it: subpaths in reverse order,
    each mapping's node flipped and its offset counted from the node's
    other end, edges reversed, sinks made starts."""
    n = len(read.subpaths)
    incoming: List[List[int]] = [[] for _ in range(n)]
    for i, sp in enumerate(read.subpaths):
        for j in sp.next:
            incoming[j].append(i)
    subpaths = []
    for i in range(n - 1, -1, -1):
        sp = read.subpaths[i]
        mappings = tuple(
            Mapping(m.node ^ 1, panel.length_of(m.node) - m.offset - m.from_length,
                    m.from_length, m.to_length, m.right_clip, m.left_clip)
            for m in reversed(sp.mappings))
        subpaths.append(Subpath(sp.score, tuple(n - 1 - j for j in reversed(incoming[i])), mappings))
    starts = tuple(n - 1 - i for i in range(n - 1, -1, -1) if not read.subpaths[i].next)
    return Read(read.length, read.mapq, starts, tuple(subpaths))


# --- one read ------------------------------------------------------------

class Interp(NamedTuple):
    """One way a read lies on the panel."""

    nodes: Tuple[int, ...]
    start: int              # offset of the first aligned base in nodes[0]
    end: int                # offset after the last aligned base in nodes[-1]
    score: int              # subpath scores less the partial-match penalties
    softclip_left: int
    softclip_right: int
    cut_left: int           # bases a partial start leaves out
    cut_right: int
    internal: bool          # a partial match
    blocked: Optional[int]  # the node a partial end leaves out

    @property
    def clip_left(self) -> int:
        return self.softclip_left + self.cut_left

    @property
    def clip_right(self) -> int:
        return self.softclip_right + self.cut_right


def _walks(read: Read):
    """(node visits, score, left softclip, right softclip) of every walk
    through the subpath graph; a visit is (node, offset, end offset, read
    bases), one per node entered."""
    out = []
    stack = [(s, (), 0, read.subpaths[s].mappings[0].left_clip) for s in read.starts]
    while stack:
        index, visits, score, softclip_left = stack.pop()
        sp = read.subpaths[index]
        visits = list(visits)
        for m in sp.mappings:
            if visits and visits[-1][0] == m.node and m.offset == visits[-1][2]:
                node, offset, _, bases = visits[-1]
                visits[-1] = (node, offset, m.offset + m.from_length, bases + m.to_length)
            elif visits and visits[-1][0] == m.node and m.offset != 0:
                raise ValueError("a walk re-enters a node mid-node")
            else:
                visits.append((m.node, m.offset, m.offset + m.from_length, m.to_length))
        score += sp.score
        if sp.next:
            stack.extend((j, tuple(visits), score, softclip_left) for j in sp.next)
        else:
            out.append((tuple(visits), score, softclip_left, sp.mappings[-1].right_clip))
    return out


def interpretations(read: Read, panel: Panel) -> Tuple[List[Interp], bool]:
    """(the read's interpretations, whether none scores the best-score
    fraction of the optimum: rpvg then counts the read as noise)."""
    optimal = read.length + 2 * FULL_LENGTH_BONUS
    max_softclip_right = max(sp.mappings[-1].right_clip for sp in read.subpaths if not sp.next)
    best = math.floor(optimal * MIN_BEST_SCORE_FRACTION)
    found: Dict[Tuple[int, ...], Interp] = {}
    for visits, score, left, right in _walks(read):
        nodes = tuple(v[0] for v in visits)
        before = [0]
        for v in visits:
            before.append(before[-1] + v[3])
        candidates = [Interp(nodes, visits[0][1], visits[-1][2], score, left, right, 0, 0, False,
                             None)]
        # Partial starts: the walk from visit j on, where the visits before
        # it hold few enough bases and more paths hold visit j alone than
        # the walk so far (the full one, or the last partial start).
        k = 0
        for j in range(1, len(nodes)):
            cut = before[j] - left
            if before[j] > left + MAX_PARTIAL_OFFSET or cut > MAX_PARTIAL_OFFSET:
                break
            if panel.count(nodes[j:j + 1]) > panel.count(nodes[k:j + 1]):
                candidates.append(Interp(nodes[j:], visits[j][1], visits[-1][2], score - cut,
                                         left, right, cut, 0, True, None))
                k = j
        # Partial ends: a walk up to visit j, where the visits from j on
        # hold few enough bases and fewer paths hold it with visit j.
        for base in list(candidates):
            k = len(nodes) - len(base.nodes)
            for j in range(k + 1, len(nodes)):
                rest = read.length - before[j]
                cut = rest - right
                if rest > max_softclip_right + MAX_PARTIAL_OFFSET or cut > MAX_PARTIAL_OFFSET:
                    continue
                held = panel.count(nodes[k:j])
                if held and held > panel.count(nodes[k:j + 1]):
                    candidates.append(base._replace(
                        nodes=nodes[k:j], end=visits[j - 1][2], score=base.score - cut,
                        cut_right=cut, internal=True, blocked=nodes[j]))
        for interp in candidates:
            if not panel.count(interp.nodes):
                continue
            best = max(best, interp.score)
            kept = found.get(interp.nodes)
            if kept is None or interp.score > kept.score:
                found[interp.nodes] = interp
    kept = [i for i in found.values() if best - i.score <= MAX_SCORE_DIFF]
    poor = not any(i.score >= MIN_BEST_SCORE_FRACTION * optimal for i in kept)
    return kept, poor


def add_log(a: float, b: float) -> float:
    hi, lo = (a, b) if a > b else (b, a)
    return hi + math.log1p(math.exp(lo - hi))


def _to_int(value: float) -> int:
    return int(round(min(float(INT32_MAX), max(float(INT32_MIN), value))))


def read_noise_score(interps: List[Interp], poor: bool) -> int:
    """The log-sum of the read's whole (not partial) interpretations'
    scores less that of its empty ones (a poor read's marker, of score
    INT32_MAX), in the noise log base."""
    joint = LOWEST
    for i in interps:
        if not i.internal:
            joint = add_log(joint, i.score * SCORE_LOG_BASE)
    empty = INT32_MAX * SCORE_LOG_BASE if poor else LOWEST
    return _to_int((joint - empty) / NOISE_SCORE_LOG_BASE)


# --- one pair ------------------------------------------------------------

class PairPath(NamedTuple):
    walk: Tuple[int, ...]
    places: frozenset        # (sequence, index of the walk's last node)
    score: int
    align_length: int
    frag_length: int
    internal: bool


def place_pair(first: Read, second: Read, panel: Panel, max_frag: int):
    """(alignment paths of the pair, noise score), no alignment paths
    where the pair lies on no path."""
    second = reverse_complement(second, panel)
    interps_1, poor_1 = interpretations(first, panel)
    interps_2, poor_2 = interpretations(second, panel)
    max_softclip_2 = max((i.softclip_left for i in interps_2), default=0)
    places_2 = {i2: panel.find(i2.nodes) for i2 in interps_2}
    found: Dict[tuple, PairPath] = {}
    for i1 in interps_1:
        len1 = len(i1.nodes)
        for s, a in panel.find(i1.nodes):
            seq = panel.sequences[s]
            coord = [0]
            for node in seq:
                coord.append(coord[-1] + panel.length_of(node))
            last1 = a + len1 - 1
            for i2, places in places_2.items():
                for t, b in places:
                    if t != s or b < a:
                        continue
                    last2 = b + len(i2.nodes) - 1
                    if b <= last1:
                        # The mates overlap: the second reaches the first's end.
                        if last2 < last1:
                            continue
                        if b == a and i2.start - i2.clip_left < i1.start - i1.clip_left:
                            continue
                        if last2 == last1 and i2.end + i2.clip_right < i1.end + i1.clip_right:
                            continue
                    else:
                        if seq[last1 + 1] == i1.blocked:
                            continue
                        # rpvg stops extending the first mate where the
                        # fragment up to the node before the second mate,
                        # with the second read, would pass the maximum.
                        insert = coord[b] - coord[last1] - i1.end
                        so_far = first.length if insert == 0 else first.length + insert - i1.clip_right
                        if so_far + second.length - max_softclip_2 > max_frag:
                            continue
                    frag = coord[last2] + i2.end + i2.clip_right - (coord[a] + i1.start - i1.clip_left)
                    if frag > max_frag:
                        continue
                    walk = seq[a:max(last1, last2) + 1]
                    key = (i1.nodes, i2.nodes, walk)
                    if key not in found:
                        found[key] = PairPath(
                            walk, frozenset((u, i + len(walk) - 1) for u, i in panel.find(walk)),
                            i1.score + i2.score,
                            first.length - i1.clip_left - i1.clip_right
                            + second.length - i2.clip_left - i2.clip_right,
                            frag, i1.internal or i2.internal)
    non_noise = 1.0
    for score in (read_noise_score(interps_1, poor_1), read_noise_score(interps_2, poor_2)):
        x = score * NOISE_SCORE_LOG_BASE
        non_noise *= 1.0 - (1.0 / (1.0 + math.exp(x)) if x < 700.0 else 0.0)
    noise = min(1.0, 1.0 - non_noise)
    noise_score = INT32_MIN if noise == 0.0 else _to_int(math.log(noise) / NOISE_SCORE_LOG_BASE)
    return list(found.values()), noise_score


# --- the index -----------------------------------------------------------

class FragmentIndex:
    """Distinct alignment-path lists with their counts, and the histogram
    of unique unambiguous pairs' fragment lengths (rpvg's
    ``src/main.cpp:54-237``)."""

    def __init__(self, panel: Panel, frag_mean: float, max_frag: int):
        self.panel = panel
        self.entries: Dict[tuple, list] = {}
        self.frag_length_counts = np.zeros(max_frag + 1, dtype=np.int64)
        self.pre_loc = int(frag_mean)
        self.max_frag = max_frag
        self.unaligned = 0

    def add(self, first: Read, second: Read) -> None:
        paths, noise_score = place_pair(first, second, self.panel, self.max_frag)
        if not paths:
            self.unaligned += 1
            return
        mapq = min(first.mapq, second.mapq)
        simple = not any(p.internal for p in paths) and len({p.frag_length for p in paths}) == 1
        if len(paths) > 1:
            # Alignment paths of one search state (the same paths, to the
            # same end node) and fragment length: the longest alignment,
            # then the best score, stays.
            merged: Dict[tuple, PairPath] = {}
            for p in paths:
                key = (p.walk[-1], p.places, p.frag_length)
                if key not in merged or (p.align_length, p.score) > (merged[key].align_length,
                                                                      merged[key].score):
                    merged[key] = p
            paths = list(merged.values())
        if simple and mapq >= FRAG_LENGTH_MIN_MAPQ and paths[0].frag_length <= self.max_frag:
            self.frag_length_counts[paths[0].frag_length] += 1
        if len(paths) == 1:
            # A unique hit: its score and lengths say nothing, and its
            # fragment length is the prior mean, so that all unique hits on
            # a path count together.
            paths = [paths[0]._replace(score=1, align_length=1, frag_length=self.pre_loc)]
        compact = sorted(
            (tuple(sorted({self.panel.path_of[u] for u, _ in p.places})), False, simple, mapq,
             p.score, p.align_length, p.frag_length, p.walk[-1], tuple(sorted(p.places)))
            for p in paths)
        key = tuple(compact) + (noise_score,)
        entry = self.entries.get(key)
        if entry is None:
            self.entries[key] = [[c[:7] for c in compact] + [((), True, simple, mapq, noise_score,
                                                              0, 0)], 1]
        else:
            entry[1] += 1


_WORKER = {}


def _init_worker(graph_path: str, panel_path: str, run: dict) -> None:
    for setting, value in (("score_not_qual", True), ("library_type", "unstranded")):
        if run.get(setting, value) != value:
            raise ValueError(f"the reference runs {setting}={value!r} only")
    _WORKER.update(panel=Panel(graph_path, panel_path), run=run)


def _project_block(task):
    rpa_path, offset, length, part, parts = task
    _, _, frag_mean, frag_sd = read_header(rpa_path)
    index = FragmentIndex(_WORKER["panel"], frag_mean, max_fragment_length(frag_mean, frag_sd))
    with open(rpa_path, "rb") as handle:
        handle.seek(offset)
        payload = handle.read(length)
    for first, second in decode_pairs(payload)[part::parts]:
        index.add(first, second)
    return ([(key, paths, count) for key, (paths, count) in index.entries.items()],
            index.frag_length_counts, index.unaligned)


class Workers:
    """A pool of ``spawn`` worker processes, each holding the panel, for
    the reference's two parallel stages: the fragment pass (one task per
    block of the file) and the per-cluster inference (:meth:`map`).
    Closed, and every worker joined, on exit."""

    def __init__(self, files: Dict[str, str], run: dict, processes: int):
        self.size = processes
        self.pool = multiprocessing.get_context("spawn").Pool(
            processes, _init_worker, (files["graph"], files["panel"], run))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.close()
        self.pool.join()

    def project_async(self, rpa_path: str, parts: int = 2):
        """Start the fragment pass over ``rpa_path``, each block in
        ``parts`` tasks (every ``parts``-th pair of it) so that the tasks
        spread evenly; ``.get()`` of the result gives
        :func:`merge_blocks`'s input."""
        tasks = [(rpa_path, offset, length, part, parts)
                 for offset, length in block_spans(rpa_path) for part in range(parts)]
        return self.pool.map_async(_project_block, tasks, chunksize=1)

    def map(self, fn, items):
        return self.pool.map(fn, items, chunksize=1)


def merge_blocks(parts):
    """(entries, histogram, unaligned count) of the whole file:
    ``entries`` maps each distinct list's key to [compact paths, count],
    in order of first appearance over the blocks."""
    merged: Dict[tuple, list] = {}
    hist = None
    unaligned = 0
    for entries, counts, part_unaligned in parts:
        hist = counts.copy() if hist is None else hist + counts
        unaligned += part_unaligned
        for key, compact, count in entries:
            entry = merged.get(key)
            if entry is None:
                merged[key] = [compact, count]
            else:
                entry[1] += count
    return merged, hist, unaligned
