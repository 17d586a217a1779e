"""Plain reference of the ``haplotype-transcripts`` model at any ploidy
(collapsed haplotype groups, no Gibbs sampling): from the generated
inputs to the rows of ``<prefix>.txt`` and ``<prefix>_joint.txt``.

Layers, as the pipeline runs them (rpvg's ``src/main.cpp`` and
``src/path_estimator.cpp``, ``src/path_abundance_estimator.cpp``):

1. fragment pass: :mod:`bench_port.reference.fragment_pass`;
2. the fragment-length re-fit (:mod:`bench_port.reference.fragment_fit`)
   and the effective path lengths under it;
3. clusters: connected components of the paths one fragment's
   alignment paths touch, ordered by entry count (ties by index,
   descending), the rank being the output ClusterID;
4. read-path probabilities (:mod:`bench_port.reference.probabilities`),
   sorted and merged;
5. per cluster: haplotype groups by source set, the grouped matrix,
   the posterior of every multiset of ``ploidy`` groups (pairs under
   the relative-likelihood cutoff at ploidy 2), the subsets above the
   minimum haplotype probability, one EM per subset, and the
   posterior-weighted combination;
6. the rows: haplotype probability and read count per path, TPM under
   the global normaliser, the joint rows and both ``Unknown`` rows.

Steps 1-3 run once (:func:`cluster`); steps 4-5 run per cluster on the
worker processes, and every step from the dense probability matrix on
runs in ``dtype`` (:func:`expected`): float64 is the reference, float32
the control (the precision below the one the configuration states)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from itertools import combinations_with_replacement
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from bench_port.reference.fragment_fit import refit
from bench_port.reference.fragment_pass import Workers, merge_blocks
from bench_port.reference.panel import Panel, effective_lengths, frag_log_densities
from bench_port.reference.probabilities import PROB_PRECISION, ReadProbs, merged, read_probs

MIN_EM_ABUNDANCE = 1e-8
MIN_EM_CONV_ITS = 10


@dataclass
class Expected:
    """What the estimate files should say."""

    # path name -> (ClusterID, Length, EffectiveLength, HaplotypeProbability, ReadCount, TPM)
    paths: Dict[str, Tuple[int, int, float, float, float, float]]
    # name tuple -> (ClusterID, HaplotypingProbability, read counts, TPMs)
    joint: Dict[Tuple[str, ...], Tuple[int, float, List[float], List[float]]]
    unknown: float                   # ReadCount of the .txt's Unknown row
    unknown_joint: List[float]       # ReadCount_i of the joint Unknown row
    tpm_normaliser: float
    clusters: int
    em_tasks: int
    info: Dict[str, float] = field(default_factory=dict)


class PathInfo(NamedTuple):
    name: str
    group_id: int                # transcript index
    source_ids: frozenset        # haplotype ids
    length: int
    effective_length: float


def parse_info(path: str) -> Dict[str, Tuple[int, frozenset]]:
    """name -> (transcript index, haplotype id set), indices in order of
    first appearance (the info TSV: Name, Length, Transcript, Haplotypes)."""
    transcripts: Dict[str, int] = {}
    haplotypes: Dict[str, int] = {}
    out = {}
    with open(path) as handle:
        header = handle.readline().rstrip("\n").split("\t")
        if header[:4] != ["Name", "Length", "Transcript", "Haplotypes"]:
            raise ValueError(f"unexpected info header {header}")
        for line in handle:
            if not line.strip():
                continue
            name, _, transcript, haps = line.rstrip("\n").split("\t")
            tid = transcripts.setdefault(transcript, len(transcripts))
            ids = frozenset(haplotypes.setdefault(h, len(haplotypes)) for h in haps.rstrip().split(","))
            out[name] = (tid, ids)
    return out


def clusters_of(entries, num_paths: int):
    """(cluster of every path, member lists ordered by smallest member,
    anchor of every entry): components over one star of edges per
    entry, from the first located id of its first non-empty path."""
    edge_u, edge_v, anchors = [], [], []
    for compact, _ in entries:
        anchor = None
        for ids, empty, *_ in compact:
            if empty:
                continue
            if anchor is None:
                anchor = ids[0]
            edge_u.extend([anchor] * len(ids))
            edge_v.extend(ids)
        anchors.append(anchor)
    graph = coo_matrix((np.ones(len(edge_u), dtype=np.int8), (edge_u, edge_v)),
                       shape=(num_paths, num_paths))
    _, labels = connected_components(graph, directed=False)
    # Relabel by smallest member path id.
    first_of = {}
    for pid, label in enumerate(labels.tolist()):
        first_of.setdefault(label, pid)
    order = sorted(first_of, key=first_of.get)
    relabel = {label: i for i, label in enumerate(order)}
    path_cluster = np.array([relabel[label] for label in labels.tolist()], dtype=np.int64)
    members: List[List[int]] = [[] for _ in order]
    for pid, c in enumerate(path_cluster.tolist()):
        members[c].append(pid)
    return path_cluster, members, anchors


def source_groups(paths: Sequence[PathInfo]) -> Tuple[List[List[int]], List[int]]:
    """Paths grouped by haplotype: one group per distinct path set of a
    haplotype id, in first-seen order, with the number of haplotypes
    that share it."""
    by_source: Dict[int, List[int]] = {}
    for i, path in enumerate(paths):
        for sid in path.source_ids:
            by_source.setdefault(sid, []).append(i)
    groups: List[List[int]] = []
    counts: List[int] = []
    index: Dict[tuple, int] = {}
    for plist in by_source.values():
        key = tuple(plist)
        if key in index:
            counts[index[key]] += 1
        else:
            index[key] = len(groups)
            groups.append(plist)
            counts.append(1)
    return groups, counts


def dense_matrix(cluster_probs: Sequence[ReadProbs], num_paths: int):
    R = len(cluster_probs)
    probs = np.zeros((R, num_paths), dtype=np.float64)
    noise = np.empty(R, dtype=np.float64)
    counts = np.empty(R, dtype=np.float64)
    for i, rp in enumerate(cluster_probs):
        for prob, ids in rp.entries:
            probs[i, list(ids)] = prob
        noise[i] = rp.noise
        counts[i] = rp.count
    return probs, noise, counts


def add_noise_and_normalize(probs: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """Rows scaled to 1 - noise, the noise column appended."""
    row_sums = probs.sum(axis=1, keepdims=True)
    positive = row_sums > 0
    scale = np.where(positive, (1 - noise)[:, None] / np.where(positive, row_sums, 1), 0)
    return np.concatenate([probs * scale, noise[:, None]], axis=1).astype(probs.dtype)


def read_collapse(probs: np.ndarray, counts: np.ndarray):
    """Rows sorted, then each merged into the last kept row when every
    entry is within the probability precision of it, counts summed."""
    if probs.shape[0] == 0:
        return probs, counts
    order = np.lexsort(np.concatenate([probs, counts[:, None].astype(probs.dtype)], axis=1).T[::-1])
    probs = probs[order]
    counts = counts[order]
    kept = [0]
    merged = [counts[0]]
    for i in range(1, probs.shape[0]):
        if np.all(np.abs(probs[kept[-1]] - probs[i]) < PROB_PRECISION):
            merged[-1] = merged[-1] + counts[i]
        else:
            kept.append(i)
            merged.append(counts[i])
    return probs[kept], np.asarray(merged, dtype=counts.dtype)


def num_permutations(group: Sequence[int]) -> int:
    """rpvg's prior weight of a multiset: n! / (n - u + 1)! with u
    distinct members (src/utils.hpp:95-117)."""
    n = len(group)
    if n == 1:
        return 1
    return math.factorial(n) // math.factorial(n - len(set(group)) + 1)


def group_posteriors(probs, noise, counts, group_counts, ploidy: int, min_rel: float):
    """(multisets of groups, posteriors) of one cluster."""
    dt = probs.dtype
    G = probs.shape[1]
    freqs = np.asarray(group_counts, dtype=dt)
    log_freqs = np.log(freqs / freqs.sum())
    groups = [list(g) for g in combinations_with_replacement(range(G), ploidy)]
    idx = np.array(groups, dtype=np.int64).reshape(len(groups), ploidy)
    # (R, n_groups) probability of each read under each multiset.
    mix = noise[:, None] + probs[:, idx].sum(axis=2) / dt.type(ploidy)
    with np.errstate(divide="ignore"):
        ll = counts @ np.log(mix)
    ll = ll + log_freqs[idx].sum(axis=1)
    ll = ll + np.log(np.array([num_permutations(g) for g in groups], dtype=dt))
    if ploidy == 2:
        keep = ll - ll.max() >= math.log(min_rel)
        groups = [g for g, k in zip(groups, keep) if k]
        ll = ll[keep]
    if not np.isfinite(ll.max()):
        return groups, np.full(ll.shape, np.nan, dtype=dt)
    shifted = np.exp(ll - ll.max())
    return groups, shifted / shifted.sum()


def em_fractions(tasks: Sequence[Tuple[np.ndarray, np.ndarray]], max_its: int, max_rel: float,
                 dtype) -> List[np.ndarray]:
    """The EM fixed point of every (matrix, counts) task, each on its
    own: start at 1/C, step a_c <- a_c sum_r (counts_r P_rc / sum_c' P_rc'
    a_c') / max(total, 1), stop once every abundance of at least 1e-8
    has moved by at most ``max_rel`` relatively for 10 iterations in a
    row, or after ``max_its``.  Tasks run in stacks of one padded shape."""
    out: List[Optional[np.ndarray]] = [None] * len(tasks)
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, (m, _) in enumerate(tasks):
        R, C = m.shape
        buckets.setdefault((1 << max(R - 1, 0).bit_length(), 1 << max(C - 1, 0).bit_length()), []).append(i)
    for (R_pad, C_pad), members in buckets.items():
        B = len(members)
        P = np.zeros((B, R_pad, C_pad), dtype=dtype)
        c = np.zeros((B, R_pad), dtype=dtype)
        mask = np.zeros((B, C_pad), dtype=bool)
        for b, i in enumerate(members):
            m, counts = tasks[i]
            P[b, : m.shape[0], : m.shape[1]] = m
            c[b, : m.shape[0]] = counts
            mask[b, : m.shape[1]] = True
        total = np.maximum(c.sum(axis=1), 1).astype(dtype)[:, None]
        a = np.where(mask, 1 / mask.sum(axis=1, keepdims=True), 0).astype(dtype)
        conv = np.zeros(B, dtype=np.int64)
        live = np.arange(B)
        its = 0
        while live.size and its < max_its:
            row = np.einsum("brc,bc->br", P, a)
            q = np.where(row > 0, c / np.where(row > 0, row, 1), 0).astype(dtype)
            new = a * np.einsum("br,brc->bc", q, P) / total
            active = (new >= MIN_EM_ABUNDANCE) & mask
            rel = np.where(active, np.abs(new - a) / np.where(active, new, 1), 0)
            conv = np.where((rel <= max_rel).all(axis=1), conv + 1, 0)
            a = new
            its += 1
            done = conv >= MIN_EM_CONV_ITS
            if done.any():
                # Frozen tasks leave the stack.
                for b in np.flatnonzero(done):
                    i = members[live[b]]
                    out[i] = a[b, : tasks[i][0].shape[1]]
                keep = ~done
                live, P, c, mask, total, a, conv = (
                    live[keep], P[keep], c[keep], mask[keep], total[keep], a[keep], conv[keep])
        for b, j in enumerate(live):
            i = members[j]
            out[i] = a[b, : tasks[i][0].shape[1]]
    return out


def _postprocess(fracs: np.ndarray, total: float) -> Tuple[np.ndarray, float]:
    """Abundances under 1e-8 become noise (src/path_abundance_estimator.cpp:100-113)."""
    counts = fracs[:-1].astype(np.float64) * total
    low = fracs[:-1] < MIN_EM_ABUNDANCE
    noise = float(counts[low].sum()) + float(fracs[-1]) * total
    counts[low] = 0.0
    return counts, noise


@dataclass
class Clusters:
    """What the fragment pass, the re-fit and the clustering give, shared
    by the reference and its control."""

    ranked: List[tuple]         # per rank: (ClusterID, path infos, entries (compact, count))
    dist: tuple                 # (loc, scale, shape) of the re-fitted distribution
    frag_log_probs: np.ndarray  # its log density at 0 .. the histogram's length
    unaligned: int
    fragment_lists: int


def cluster(files: Dict[str, str], workers: Workers) -> Clusters:
    """Fragment pass of the reads on ``workers`` (whose panel is the
    one of ``files``); meanwhile the panel loads here.
    Then the re-fit, the effective lengths and the clusters in rank
    order."""
    pending = workers.project_async(files["reads"])
    panel = Panel(files["graph"], files["panel"])
    info = parse_info(files["info"])
    by_key, hist, unaligned = merge_blocks(pending.get())
    dist = refit(hist)
    lengths = panel.lengths
    eff_lengths = effective_lengths(lengths, *dist)
    entries = list(by_key.values())
    path_cluster, members, anchors = clusters_of(entries, len(panel))
    per_cluster: List[List[int]] = [[] for _ in members]
    for e, anchor in enumerate(anchors):
        if anchor is not None:
            per_cluster[path_cluster[anchor]].append(e)
    sizes = np.array([len(x) for x in per_cluster], dtype=np.int64)
    ranked = []
    for rank, ci in enumerate(np.lexsort((np.arange(sizes.size), sizes))[::-1].tolist()):
        paths = []
        for pid in members[ci]:
            name = panel.names[pid]
            tid, sids = info[name]
            paths.append(PathInfo(name, tid, sids, int(lengths[pid]), float(eff_lengths[pid])))
        local = {pid: i for i, pid in enumerate(members[ci])}
        cluster_entries = [([(tuple(local[p] for p in c[0]),) + tuple(c[1:]) for c in entries[e][0]],
                            entries[e][1]) for e in per_cluster[ci]]
        ranked.append((rank + 1, paths, cluster_entries))
    return Clusters(ranked, dist, frag_log_densities(len(hist), *dist), unaligned, len(entries))


def _infer_clusters(args):
    """Worker task: the estimates of a chunk of clusters,
    (ClusterID, path group sets, posteriors, abundances, noise count) each."""
    chunk, frag_log_probs, run, dtype_name = args
    dtype = np.dtype(dtype_name)

    def frag_log_prob(length: int) -> float:
        return float(frag_log_probs[length])

    ploidy = int(run["ploidy"])
    min_hap_prob = float(run.get("min_hap_prob", 0.001))
    states = []
    em_inputs = []
    for cid, paths, cluster_entries in chunk:
        state = {"cid": cid, "paths": paths, "tasks": [], "total": 0.0}
        states.append(state)
        eff = [p.effective_length for p in paths]
        deduped = merged([read_probs(compact, count, eff, frag_log_prob)
                          for compact, count in cluster_entries])
        if not deduped:
            continue
        dense, noise, counts = dense_matrix(deduped, len(paths))
        state["total"] = float(counts.sum())
        dense, noise, counts = dense.astype(dtype), noise.astype(dtype), counts.astype(dtype)
        groups, group_counts = source_groups(paths)
        grouped = np.stack([dense[:, g].sum(axis=1) for g in groups], axis=1)
        g_full, g_counts = read_collapse(add_noise_and_normalize(grouped, noise), counts)
        sets, posts = group_posteriors(g_full[:, :-1], g_full[:, -1], g_counts, group_counts,
                                       ploidy, min_hap_prob)
        subset_probs: Dict[tuple, float] = {}
        total_posterior = 0.0
        for group_set, post in zip(sets, posts):
            if post >= min_hap_prob:
                key = tuple(sorted(pid for g in group_set for pid in groups[g]))
                subset_probs[key] = subset_probs.get(key, 0.0) + float(post)
                total_posterior += float(post)
        for key, post in subset_probs.items():
            subset_prob = post / total_posterior
            if subset_prob < min_hap_prob:
                continue
            collapsed, multiplicity = [], {}
            for pid in key:
                if not collapsed or pid != collapsed[-1]:
                    collapsed.append(pid)
                    multiplicity[pid] = 1
                else:
                    multiplicity[pid] += 1
            em_inputs.append(read_collapse(add_noise_and_normalize(dense[:, collapsed], noise), counts))
            state["tasks"].append({"subset": key, "subset_prob": subset_prob,
                                   "collapsed": collapsed, "multiplicity": multiplicity})
    fracs = iter(em_fractions(em_inputs, int(run.get("max_em_its", 10000)),
                              float(run.get("max_rel_em_conv", 0.001)), dtype))
    sub_counts = iter(c for _, c in em_inputs)
    out = []
    for state in states:
        paths = state["paths"]
        group_estimates: Dict[tuple, list] = {}
        noise_count = 0.0
        sum_hap = 0.0
        for task in state["tasks"]:
            abundances, task_noise = _postprocess(next(fracs), float(next(sub_counts).astype(np.float64).sum()))
            p = task["subset_prob"]
            sum_hap += p
            noise_count += task_noise * p
            col_of = {pid: j for j, pid in enumerate(task["collapsed"])}
            by_group: Dict[int, List[int]] = {}
            for pid in task["subset"]:
                by_group.setdefault(paths[pid].group_id, []).append(pid)
            for group_paths in by_group.values():
                entry = group_estimates.setdefault(tuple(group_paths), [0.0, [0.0] * len(group_paths)])
                entry[0] += p
                for i, pid in enumerate(group_paths):
                    entry[1][i] += float(abundances[col_of[pid]]) * p / task["multiplicity"][pid]
        noise_count += (1.0 - sum_hap) * state["total"]
        out.append((state["cid"], [list(k) for k in group_estimates],
                    [v[0] for v in group_estimates.values()],
                    [a for v in group_estimates.values() for a in v[1]], noise_count,
                    len(state["tasks"])))
    return out


def _chunks(ranked, n: int) -> List[list]:
    """``ranked`` dealt into ``n`` chunks of about equal entry counts,
    the largest clusters first."""
    chunks = [[] for _ in range(n)]
    loads = [0] * n
    for item in sorted(ranked, key=lambda r: -len(r[2])):
        k = loads.index(min(loads))
        chunks[k].append(item)
        loads[k] += len(item[2]) + 1
    return [c for c in chunks if c]


def expected(clusters: Clusters, run: dict, workers: Workers, dtype=np.float64) -> Expected:
    """The rows of every cluster, the estimates computed in ``dtype``
    on ``workers``."""
    ploidy = int(run["ploidy"])
    parts = workers.map(_infer_clusters, [(chunk, clusters.frag_log_probs, run, np.dtype(dtype).name)
                                          for chunk in _chunks(clusters.ranked, 4 * workers.size)])
    estimates = {r[0]: r[1:] for part in parts for r in part}
    paths_of = {cid: paths for cid, paths, _ in clusters.ranked}

    normaliser = 0.0
    for cid, (sets, _, abundances, _, _) in estimates.items():
        paths = paths_of[cid]
        it = iter(abundances)
        for group_set in sets:
            for pid in group_set:
                a = next(it)
                if paths[pid].effective_length > 0:
                    normaliser += a / paths[pid].effective_length

    def tpm(count, eff):
        return count / eff / normaliser * 1e6 if eff > 0 else 0.0

    out_paths, out_joint = {}, {}
    noise_total = 0.0
    em_tasks = 0
    for cid, paths, _ in clusters.ranked:
        sets, posts, abundances, noise_count, n_tasks = estimates.get(cid, ([], [], [], 0.0, 0))
        noise_total += noise_count
        em_tasks += n_tasks
        hap = np.zeros(len(paths))
        reads = np.zeros(len(paths))
        it = iter(abundances)
        for group_set, post in zip(sets, posts):
            slot_counts = [next(it) for _ in group_set]
            for j, pid in enumerate(group_set):
                reads[pid] += slot_counts[j]
                if j == 0 or pid != group_set[j - 1]:
                    hap[pid] += post
            if post >= PROB_PRECISION:
                names = tuple(paths[pid].name for pid in group_set)
                effs = [paths[pid].effective_length for pid in group_set]
                out_joint[names] = (cid, post, slot_counts, [tpm(c, e) for c, e in zip(slot_counts, effs)])
        for i, path in enumerate(paths):
            out_paths[path.name] = (cid, path.length, path.effective_length, float(hap[i]),
                                    float(reads[i]), tpm(reads[i], path.effective_length))
    unaligned = clusters.unaligned
    return Expected(
        paths=out_paths, joint=out_joint, unknown=noise_total + unaligned,
        unknown_joint=[noise_total / ploidy + unaligned / ploidy] * ploidy,
        tpm_normaliser=normaliser, clusters=len(clusters.ranked), em_tasks=em_tasks,
        info={"fragment_lists": clusters.fragment_lists, "unaligned": unaligned,
              "frag_loc": clusters.dist[0], "frag_scale": clusters.dist[1],
              "frag_shape": clusters.dist[2]},
    )
