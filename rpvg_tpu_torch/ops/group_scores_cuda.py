"""Multiset group log-likelihoods of the full enumeration: the CUDA
kernel ``csrc/group_scores.cu`` and its plain PyTorch version.

Counterpart of the XLA device function
``rpvg_tpu/infer/posteriors.py::_group_scores_chunk`` (under
``full_posteriors_batched``).  For a cluster of R read rows over P paths
and group size k, group g (k path indices, a row of
``combinations_with_replacement(range(P), k)``) scores

    S[g] = sum_r counts[r] * log(noise[r] + (sum_j probs[r, idx[g, j]]) / k)

with -inf where the argument is <= 0.  The kernel takes the clusters
ragged (:class:`GroupClusters`); the plain version
(:func:`group_scores_plain`) is the JAX function's transcription on
padded (B, R, P) batches, and :func:`group_scores_ragged_plain` runs it
over ragged clusters in the JAX package's padded buckets.  A padded row
adds 0 * log(1) = 0, so both layouts give each cluster the same sums up
to their order.

:func:`group_scores` dispatches on the clusters' device: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from itertools import combinations_with_replacement
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu_torch.infer.posteriors import _ceil_pow2, _ceil_pow4, _log_or_neg_inf
from rpvg_tpu_torch.ops import build
from rpvg_tpu_torch.ops.em_cuda import (
    Launch,
    concat_to_device,
    launch_task_ids,
    offsets as _offsets,
    run_launches,
    to_device,
)

# Kernel launches, and clusters they covered, since the last reset.  Only
# a kernel launch adds to them.
LAUNCHES = 0
CLUSTERS = 0

KERNEL_NAME = "group_scores"
# Groups per block, one thread each.
TILE = 128
# Shared memory of one block: rows of the cluster's probabilities are
# staged a pass at a time (48 KB needs no opt-in and leaves room for
# several blocks per SM).
SMEM_BYTES = 48 * 1024
_fn = None


@functools.lru_cache(maxsize=None)
def group_table(n_paths: int, group_size: int) -> np.ndarray:
    """(G, k) int32: every multiset of ``group_size`` of ``n_paths``
    paths, sorted within and in lexicographic order (the JAX package's
    padded enumeration filtered to indices < P gives the same rows)."""
    rows = list(combinations_with_replacement(range(n_paths), group_size))
    return np.asarray(rows, dtype=np.int32).reshape(len(rows), group_size)


@dataclass
class GroupClusters:
    """Clusters concatenated without padding on one device: cluster c's
    probabilities are ``probs[mat_offsets[c]:]`` row-major
    (n_rows[c], n_cols[c]), its noise and counts at ``row_offsets[c]``,
    its groups the rows of ``table`` from ``table_offsets[c]`` (int32,
    k per group; one table per distinct P), and its n_groups[c] scores go
    to ``out_offsets[c]``.  The kernel's blocks are planned here once:
    tile t covers groups ``tile_first[t]`` onwards of cluster
    ``tile_cluster[t]``, and ``launches`` list their tiles by index
    (``tile_ids``, launch by launch).  ``host`` holds the integer arrays
    on the host, by name."""

    probs: torch.Tensor          # float64 (sum R_c P_c,)
    noise: torch.Tensor          # float64 (sum R_c,)
    counts: torch.Tensor         # float64 (sum R_c,)
    table: torch.Tensor          # int32 (sum over distinct P of G_P k,)
    mat_offsets: torch.Tensor    # int64 (n,)
    row_offsets: torch.Tensor    # int64 (n,)
    n_rows: torch.Tensor         # int64 (n,)
    n_cols: torch.Tensor         # int64 (n,)
    table_offsets: torch.Tensor  # int64 (n,)
    n_groups: torch.Tensor       # int64 (n,)
    out_offsets: torch.Tensor    # int64 (n + 1,)
    tile_cluster: torch.Tensor   # int64 (tiles,)
    tile_first: torch.Tensor     # int64 (tiles,)
    tile_ids: torch.Tensor       # int64 (tiles,)
    launches: List[Launch]
    group_size: int
    host: dict

    @property
    def n_clusters(self) -> int:
        return int(self.host["n_rows"].size)

    @property
    def device(self) -> torch.device:
        return self.probs.device


_FIELDS = ("mat_offsets", "row_offsets", "n_rows", "n_cols", "table_offsets", "n_groups",
           "out_offsets")


def make_clusters(inputs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], group_size: int,
                  device: torch.device) -> GroupClusters:
    """:class:`GroupClusters` on ``device`` of (probs (R, P), noise (R,),
    counts (R,)) per cluster."""
    n = len(inputs)
    rows = np.array([p.shape[0] for p, _, _ in inputs], dtype=np.int64)
    cols = np.array([p.shape[1] for p, _, _ in inputs], dtype=np.int64)
    tables: Dict[int, int] = {}
    pieces: List[np.ndarray] = []
    table_offsets = np.zeros(n, dtype=np.int64)
    at = 0
    for c, P in enumerate(cols.tolist()):
        if P not in tables:
            tables[P] = at
            pieces.append(group_table(P, group_size).reshape(-1))
            at += pieces[-1].size
        table_offsets[c] = tables[P]
    n_groups = np.array([math.comb(int(P) + group_size - 1, group_size) for P in cols],
                        dtype=np.int64)
    host = {
        "mat_offsets": _offsets(rows * cols)[:-1],
        "row_offsets": _offsets(rows)[:-1],
        "n_rows": rows,
        "n_cols": cols,
        "table_offsets": table_offsets,
        "n_groups": n_groups,
        "out_offsets": _offsets(n_groups),
    }
    launches, tile_cluster, tile_first = plan_tiles(cols, n_groups)
    return GroupClusters(
        probs=concat_to_device([p for p, _, _ in inputs], device),
        noise=concat_to_device([x for _, x, _ in inputs], device),
        counts=concat_to_device([x for _, _, x in inputs], device),
        table=to_device(np.concatenate(pieces) if pieces else np.zeros(0, np.int32), device),
        **{name: to_device(host[name], device) for name in _FIELDS},
        tile_cluster=to_device(tile_cluster, device),
        tile_first=to_device(tile_first, device),
        tile_ids=launch_task_ids(launches, device),
        launches=launches,
        group_size=int(group_size),
        host=host,
    )


def group_scores(clusters: GroupClusters) -> torch.Tensor:
    """Every cluster's group scores, float64, concatenated by
    ``out_offsets``, on the clusters' device.  CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if clusters.device.type == "cpu":
        return group_scores_ragged_plain(clusters)
    if clusters.device.type != "cuda":
        raise ValueError(f"group_scores: unsupported device {clusters.device}")
    return _launch(clusters)


# ------------------------------------------------------------ the kernel


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library(KERNEL_NAME).rpvg_group_scores_f64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
        _fn = fn
    return _fn


def plan_launches(cols) -> List[Launch]:
    """One launch for the clusters whose probability rows are staged in
    shared memory a pass at a time (a row of P doubles fits
    ``SMEM_BYTES``) and one for the rest, which read them from global
    memory.  ``tasks`` are cluster indices."""
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    staged = 8 * cols <= SMEM_BYTES
    launches = []
    for on_chip in (True, False):
        members = np.flatnonzero(staged == on_chip)
        if members.size:
            launches.append(Launch(TILE, on_chip, members, SMEM_BYTES if on_chip else 0))
    return launches


def plan_tiles(cols, n_groups) -> Tuple[List[Launch], np.ndarray, np.ndarray]:
    """The kernel's blocks: :func:`plan_launches` with each cluster cut
    into tiles of ``TILE`` groups.  Returns (launches whose ``tasks`` are
    tile indices, tile -> cluster, tile -> first group)."""
    n_groups = np.asarray(n_groups, dtype=np.int64).reshape(-1)
    launches, clusters, firsts = [], [], []
    at = 0
    for launch in plan_launches(cols):
        per = -(-n_groups[launch.tasks] // TILE)
        clusters.append(np.repeat(launch.tasks, per))
        firsts.append((np.arange(per.sum()) - np.repeat(_offsets(per)[:-1], per)) * TILE)
        launches.append(Launch(launch.threads, launch.staged,
                               np.arange(at, at + clusters[-1].size), launch.smem_bytes))
        at += clusters[-1].size
    if not launches:
        return [], np.zeros(0, np.int64), np.zeros(0, np.int64)
    return launches, np.concatenate(clusters), np.concatenate(firsts).astype(np.int64)


def _check(clusters: GroupClusters) -> None:
    device = clusters.device
    for name in ("probs", "noise", "counts"):
        t = getattr(clusters, name)
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"group_scores: {name} must be contiguous float64 on {device}")
    if clusters.table.dtype != torch.int32 or not clusters.table.is_contiguous():
        raise ValueError("group_scores: table must be contiguous int32")
    for name in _FIELDS + ("tile_cluster", "tile_first", "tile_ids"):
        t = getattr(clusters, name)
        if t.dtype != torch.int64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"group_scores: {name} must be contiguous int64 on {device}")
    if clusters.group_size < 1:
        raise ValueError("group_scores: group size must be at least 1")


def _launch(clusters: GroupClusters) -> torch.Tensor:
    global LAUNCHES, CLUSTERS
    _check(clusters)
    out = torch.empty(int(clusters.host["out_offsets"][-1]), dtype=torch.float64,
                      device=clusters.device)
    if not clusters.launches:
        return out

    def call(launch: Launch, ids: int, stream: int) -> int:
        return _kernel_fn()(
            clusters.probs.data_ptr(), clusters.noise.data_ptr(), clusters.counts.data_ptr(),
            clusters.table.data_ptr(), clusters.mat_offsets.data_ptr(),
            clusters.row_offsets.data_ptr(), clusters.n_rows.data_ptr(),
            clusters.n_cols.data_ptr(), clusters.table_offsets.data_ptr(),
            clusters.n_groups.data_ptr(), clusters.out_offsets.data_ptr(),
            clusters.tile_cluster.data_ptr(), clusters.tile_first.data_ptr(), ids,
            int(launch.tasks.size), clusters.group_size, launch.threads, int(launch.staged),
            launch.smem_bytes, out.data_ptr(), stream,
        )

    run_launches(KERNEL_NAME, clusters.launches, clusters.tile_ids, call)
    LAUNCHES += len(clusters.launches)
    CLUSTERS += clusters.n_clusters
    return out


# ------------------------------------------------------------ plain version


def group_scores_plain(probs: torch.Tensor, noise: torch.Tensor, counts: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """(B, G) scores of the groups ``idx`` (G, k) over padded clusters
    probs (B, R, P), noise (B, R), counts (B, R): ``_group_scores_chunk``
    written out in torch, k gathers summed in slot order, then
    noise + sum / k, its log (-inf where <= 0) and the counts-weighted
    sum over rows.  The group axis is cut into chunks of at most 2^24
    (B, R, chunk) elements, as ``full_posteriors_batched`` cuts it."""
    B, R, _ = probs.shape
    G, k = idx.shape
    g_chunk = _ceil_pow2(max(1, (1 << 24) // max(1, B * R)), floor=128)
    idx = idx.to(device=probs.device, dtype=torch.int64)
    parts = []
    for g0 in range(0, G, g_chunk):
        block = idx[g0 : g0 + g_chunk]
        acc = probs[:, :, block[:, 0]]
        for i in range(1, k):
            acc = acc + probs[:, :, block[:, i]]
        group = noise[:, :, None] + acc / k
        parts.append(torch.einsum("br,brg->bg", counts, _log_or_neg_inf(group)))
    if not parts:
        return probs.new_zeros((B, 0))
    return torch.cat(parts, dim=1)


def group_scores_ragged_plain(clusters: GroupClusters) -> torch.Tensor:
    """:func:`group_scores` by the plain version, on the clusters'
    device: clusters bucketed by padded shape (rows to powers of four,
    paths to powers of two, as the JAX package pads them), up to
    max(1, 4096 // R_pad) * 8 clusters a batch, each batch scored against
    the padded enumeration of P_pad paths; a cluster keeps the groups of
    its own P paths, in the same order as its own table."""
    device = clusters.device
    host = clusters.host
    k = clusters.group_size
    out = torch.empty(int(host["out_offsets"][-1]), dtype=torch.float64, device=device)
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for c, (R, P) in enumerate(zip(host["n_rows"].tolist(), host["n_cols"].tolist())):
        buckets.setdefault((_ceil_pow4(R), _ceil_pow2(P)), []).append(c)
    for (R_pad, P_pad), members in buckets.items():
        groups_pad = group_table(P_pad, k)
        idx = torch.from_numpy(groups_pad).to(device)
        max_batch = max(1, 4096 // R_pad) * 8
        for start in range(0, len(members), max_batch):
            chunk = members[start : start + max_batch]
            B = len(chunk)
            probs = torch.zeros((B, R_pad, P_pad), dtype=torch.float64, device=device)
            noise = torch.ones((B, R_pad), dtype=torch.float64, device=device)
            counts = torch.zeros((B, R_pad), dtype=torch.float64, device=device)
            for b, c in enumerate(chunk):
                R, P = int(host["n_rows"][c]), int(host["n_cols"][c])
                m0, r0 = int(host["mat_offsets"][c]), int(host["row_offsets"][c])
                probs[b, :R, :P] = clusters.probs[m0 : m0 + R * P].view(R, P)
                noise[b, :R] = clusters.noise[r0 : r0 + R]
                counts[b, :R] = clusters.counts[r0 : r0 + R]
            scores = group_scores_plain(probs, noise, counts, idx)
            for b, c in enumerate(chunk):
                valid = torch.from_numpy((groups_pad < host["n_cols"][c]).all(axis=1)).to(device)
                o0, o1 = int(host["out_offsets"][c]), int(host["out_offsets"][c + 1])
                out[o0:o1] = scores[b][valid]
    return out
