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
to their order.  :func:`group_scores_factored_plain` is the kernel's
factoring of the same sum in plain PyTorch (the last slot's logs once
per cluster, a log of its own only for the rows a group's other slots
touch), held against both by the tests.

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

from rpvg_tpu_torch import spans
from rpvg_tpu_torch.infer.posteriors import _ceil_pow2, _ceil_pow4, _log_or_neg_inf
from rpvg_tpu_torch.ops import build
from rpvg_tpu_torch.ops.em_cuda import concat_to_device, offsets as _offsets, to_device

KERNEL_NAME = "group_scores"
# Warps per block of the scoring grid (csrc/group_scores.cu kWarps): 256 /
# S groups a block, S warps per tile of 32 groups.
WARPS_PER_BLOCK = 8
# Rows per word of the pre-pass (one bit each in the row masks).
WORD = 32
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
    to ``out_offsets[c]``.  The kernel's pre-pass takes a block per word
    of 32 rows (cluster c's from ``word_offsets[c]``; ``word_cluster``
    names each word's cluster) and writes per word P sums at
    ``part_offsets[c]`` and P + 1 bit words at ``mask_offsets[c]``; its
    scoring grid a block per 256 / S groups of a cluster, S =
    ``row_splits[c]`` warps per tile of 32 groups (``block_cluster``,
    ``block_first``; :func:`plan_blocks`).  ``host`` holds the integer
    arrays on the host, by name."""

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
    word_offsets: torch.Tensor   # int64 (n + 1,)
    word_cluster: torch.Tensor   # int64 (words,)
    part_offsets: torch.Tensor   # int64 (n + 1,)
    mask_offsets: torch.Tensor   # int64 (n + 1,)
    row_splits: torch.Tensor     # int64 (n,)
    block_cluster: torch.Tensor  # int64 (blocks,)
    block_first: torch.Tensor    # int64 (blocks,)
    group_size: int
    host: dict

    @property
    def n_clusters(self) -> int:
        return int(self.host["n_rows"].size)

    @property
    def device(self) -> torch.device:
        return self.probs.device


_FIELDS = ("mat_offsets", "row_offsets", "n_rows", "n_cols", "table_offsets", "n_groups",
           "out_offsets", "word_offsets", "word_cluster", "part_offsets", "mask_offsets",
           "row_splits", "block_cluster", "block_first")


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
    words = -(-rows // WORD)
    block_cluster, block_first, row_splits = plan_blocks(rows, n_groups)
    host = {
        "mat_offsets": _offsets(rows * cols)[:-1],
        "row_offsets": _offsets(rows)[:-1],
        "n_rows": rows,
        "n_cols": cols,
        "table_offsets": table_offsets,
        "n_groups": n_groups,
        "out_offsets": _offsets(n_groups),
        "word_offsets": _offsets(words),
        "word_cluster": np.repeat(np.arange(n, dtype=np.int64), words),
        "part_offsets": _offsets(words * cols),
        "mask_offsets": _offsets(words * (cols + 1)),
        "row_splits": row_splits,
        "block_cluster": block_cluster,
        "block_first": block_first,
    }
    return GroupClusters(
        probs=concat_to_device([p for p, _, _ in inputs], device),
        noise=concat_to_device([x for _, x, _ in inputs], device),
        counts=concat_to_device([x for _, _, x in inputs], device),
        table=to_device(np.concatenate(pieces) if pieces else np.zeros(0, np.int32), device),
        **{name: to_device(host[name], device) for name in _FIELDS},
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
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 7
        _fn = fn
    return _fn


def blocks_per_sm(group_size: int) -> int:
    """Blocks of the scoring grid (``WARPS_PER_BLOCK`` warps) resident on
    one SM at ``group_size``, by the occupancy API."""
    fn = build.load_library(KERNEL_NAME).rpvg_group_scores_blocks_per_sm
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int64]
    return int(fn(int(group_size)))


def row_splits(rows) -> np.ndarray:
    """Warps S (1, 2, 4 or 8) that share a tile of 32 groups, each
    walking 1 / S of the row words: one up to 7 words, then 4 words or
    more a warp."""
    words = -(-np.asarray(rows, dtype=np.int64) // WORD)
    split = np.ones_like(words)
    for s in (2, 4, 8):
        split[words >= 4 * s] = s
    return split


def plan_blocks(rows, n_groups) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The scoring grid's blocks: every cluster's groups cut into blocks
    of 256 / S consecutive groups (:func:`row_splits`), the clusters whose
    warps walk the most row words first (the longest blocks start first),
    then the most rows x groups.  Returns (block -> cluster, block -> first
    group, per cluster S)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    n_groups = np.asarray(n_groups, dtype=np.int64).reshape(-1)
    split = row_splits(rows)
    words = -(-rows // WORD)
    per_warp = -(-words // split)
    order = np.lexsort((-(rows * n_groups), -per_warp))
    size = 32 * WARPS_PER_BLOCK // split[order]
    per = -(-n_groups[order] // size)
    cluster = np.repeat(order, per)
    first = (np.arange(int(per.sum()), dtype=np.int64) - np.repeat(_offsets(per)[:-1], per))
    return cluster.astype(np.int64), first * np.repeat(size, per), split


_LOG_TABLES: Dict[torch.device, torch.Tensor] = {}


def _log_table_on(device: torch.device) -> torch.Tensor:
    """:func:`log_table` on ``device``, uploaded once."""
    table = _LOG_TABLES.get(device)
    if table is None:
        table = _LOG_TABLES[device] = to_device(log_table().reshape(-1), device)
    return table


def _check(clusters: GroupClusters) -> None:
    device = clusters.device
    for name in ("probs", "noise", "counts"):
        t = getattr(clusters, name)
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"group_scores: {name} must be contiguous float64 on {device}")
    if clusters.table.dtype != torch.int32 or not clusters.table.is_contiguous():
        raise ValueError("group_scores: table must be contiguous int32")
    for name in _FIELDS:
        t = getattr(clusters, name)
        if t.dtype != torch.int64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"group_scores: {name} must be contiguous int64 on {device}")
    if clusters.group_size < 1:
        raise ValueError("group_scores: group size must be at least 1")


def _arguments(clusters: GroupClusters) -> tuple:
    """The kernel's arguments but the output and the stream, checked and
    its scratch allocated at the first launch of ``clusters`` and kept in
    ``host`` (a call's host work is then one allocation and the call)."""
    args = clusters.host.get("kernel_arguments")
    if args is None:
        _check(clusters)
        host = clusters.host
        device = clusters.device
        scratch = (
            torch.empty(max(2, 2 * clusters.probs.numel()), dtype=torch.float64, device=device),
            torch.empty(max(2, 2 * clusters.noise.numel()), dtype=torch.float64, device=device),
            torch.empty(max(1, int(host["part_offsets"][-1])), dtype=torch.float64, device=device),
            torch.empty(max(1, int(host["mask_offsets"][-1])), dtype=torch.int32, device=device),
            _log_table_on(device),
        )
        args = (
            clusters.probs.data_ptr(), clusters.noise.data_ptr(), clusters.counts.data_ptr(),
            clusters.table.data_ptr(),
            *(getattr(clusters, name).data_ptr() for name in _FIELDS),
            int(host["word_cluster"].size), int(host["block_cluster"].size),
            clusters.group_size, *(t.data_ptr() for t in scratch),
        )
        host["kernel_scratch"] = scratch
        host["kernel_arguments"] = args
    return args


def _launch(clusters: GroupClusters) -> torch.Tensor:
    """The kernel on ``clusters``; counts in the run its grids (the
    pre-pass and the scoring grid, each counted) as ``groups.launches``
    and the clusters they cover as ``groups.kernel_clusters``."""
    host = clusters.host
    device = clusters.device
    out = torch.empty(int(host["out_offsets"][-1]), dtype=torch.float64, device=device)
    if host["block_cluster"].size == 0:
        return out
    args = _arguments(clusters)
    with torch.cuda.device(device):
        rc = _kernel_fn()(*args, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_NAME} kernel launch failed: CUDA error {rc}")
    spans.count("groups.launches", 2 if host["word_cluster"].size else 1)
    spans.count("groups.kernel_clusters", clusters.n_clusters)
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


def group_scores_factored_plain(probs: torch.Tensor, noise: torch.Tensor, counts: torch.Tensor,
                                group_size: int) -> torch.Tensor:
    """(G,) scores of one cluster, probs (R, P), noise (R,), counts (R,),
    as ``csrc/group_scores.cu`` factors them: with the last slot l's logs
    L[r, l] = log(noise[r] + probs[r, l] / k) over the rows of positive
    noise and T[l] = sum_r counts[r] L[r, l], a group scores

        T[l] + sum_{r in U(g)} counts[r] (log(noise[r] + slot sum / k) - L[r, l])

    where U(g) holds the rows of non-positive noise (their own term,
    without L) and the rows of nonzero count where a path of the first
    k - 1 slots has a nonzero probability; every other row's slot sum is
    probs[r, l] exactly.  The slot sum runs in slot order and is scaled
    by 1 / k."""
    R, P = probs.shape
    k = int(group_size)
    idx = torch.from_numpy(group_table(P, k).astype(np.int64)).to(probs.device)
    inv_k = 1.0 / k
    bad = ~(noise > 0)
    live = (probs != 0) & ((counts != 0) | bad)[:, None]
    logs = torch.where(bad[:, None], 0.0, _log_or_neg_inf(noise[:, None] + probs * inv_k))
    totals = (torch.where(bad, 0.0, counts)[:, None] * logs).sum(dim=0)
    last = idx[:, -1]
    in_u = bad[:, None].expand(R, idx.shape[0])
    slot_sum = probs[:, last]
    if k > 1:
        slot_sum = probs[:, idx[:, 0]]
        in_u = in_u | live[:, idx[:, 0]]
        for j in range(1, k - 1):
            slot_sum = slot_sum + probs[:, idx[:, j]]
            in_u = in_u | live[:, idx[:, j]]
        slot_sum = slot_sum + probs[:, last]
    full = _log_or_neg_inf(noise[:, None] + slot_sum * inv_k)
    term = torch.where(bad[:, None], full, full - logs[:, last])
    return totals[last] + torch.where(in_u, counts[:, None] * term, 0.0).sum(dim=0)


# ----------------------------------------------- the kernel's log


LOG_TABLE_BIAS = 37
LOG_TABLE_SIZE = 91


@functools.lru_cache(maxsize=None)
def log_table() -> np.ndarray:
    """(91, 2) float64 table of ``csrc/log_f64.cuh``: for j = -37 .. 53,
    c = 1 / (1 + j / 128) rounded to float64 and l = -log(c) (1 and 0 at
    j = 0)."""
    j = np.arange(-LOG_TABLE_BIAS, LOG_TABLE_SIZE - LOG_TABLE_BIAS, dtype=np.float64)
    c = 1.0 / (1.0 + j / 128.0)
    return np.stack([c, -np.log(c)], axis=1)


def table_log(x: np.ndarray) -> np.ndarray:
    """``csrc/log_f64.cuh`` log_pos in numpy, step for step, for finite
    x > 0 (numpy has no fused multiply-add: :func:`_fma` forms the
    product exactly and rounds once more at most)."""
    x = np.asarray(x, dtype=np.float64)
    tiny = x < 2.2250738585072014e-308
    x = np.where(tiny, np.where(tiny, x, 0.0) * 18014398509481984.0, x)
    bits = x.view(np.uint64)
    frac = bits & np.uint64(0x000FFFFFFFFFFFFF)
    high = frac >= np.uint64(0x6A09E667F3BCD)
    e = (bits >> np.uint64(52)).astype(np.int64) - 1023 - np.where(tiny, 54, 0) + high
    m = (frac | np.where(high, np.uint64(0x3FE0000000000000),
                         np.uint64(0x3FF0000000000000))).view(np.float64)
    j = np.where(high, ((frac >> np.uint64(45)) + np.uint64(1)) >> np.uint64(1),
                 ((frac >> np.uint64(44)) + np.uint64(1)) >> np.uint64(1)).astype(np.int64)
    j = j - np.where(high, 64, 0)
    c, l = log_table()[j + LOG_TABLE_BIAS].T
    t = _fma(m, c, -1.0)
    q = np.full_like(t, -1.0 / 8.0)
    for coef in (1.0 / 7.0, -1.0 / 6.0, 1.0 / 5.0, -1.0 / 4.0, 1.0 / 3.0, -1.0 / 2.0):
        q = _fma(q, t, coef)
    log1p_t = _fma(t * t, q, t)
    ed = e.astype(np.float64)
    hi = _fma(ed, 6.93147180369123816490e-01, l)
    lo = _fma(ed, 1.90821492927058770002e-10, log1p_t)
    return hi + lo


def _fma(a, b, c):
    """a * b + c: the product exact by Dekker's splitting, then summed
    with c and the product's error (within an ulp of one rounding)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, dtype=np.float64) for v in (a, b, c)))
    split = 134217729.0  # 2^27 + 1
    p = a * b
    ah = a * split
    ah = ah - (ah - a)
    bh = b * split
    bh = bh - (bh - b)
    err = ((ah * bh - p) + ah * (b - bh) + (a - ah) * bh) + (a - ah) * (b - bh)
    s = p + c
    bb = s - p
    return s + ((p - (s - bb)) + (c - bb) + err)
