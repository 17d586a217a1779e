"""Collapsed Gibbs sampling of diploid haplotype pairs: the CUDA kernel
``csrc/gibbs_posterior.cu`` and its plain PyTorch version.

Counterpart of the XLA device function
``rpvg_tpu/infer/posteriors.py::_gibbs_chains_vmapped`` at group size 2.
A cluster is its (P, P) pair log-likelihood matrix (row stride given, so
a padded batch of score matrices is read in place), its chain, burn-in
and sample counts (``gibbs_iteration_counts``) and a 64-bit seed; it
yields chains x its sampled (slot 0, slot 1) pairs after burn-in, as
int32.

:func:`posterior_gibbs` dispatches on the device of the clusters: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs
:func:`posterior_gibbs_plain`, which repeats the kernel's arithmetic on
the same Philox counters.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from rpvg_tpu_torch.ops import build
from rpvg_tpu_torch.ops.em_cuda import (
    SMEM_LIMIT,
    Launch,
    launch_task_ids,
    run_launches,
    to_device,
)
from rpvg_tpu_torch.ops.gibbs_cuda import uniforms

# Kernel launches, and clusters they covered, since the last reset.  Only
# a kernel launch adds to them.
LAUNCHES = 0
CLUSTERS = 0

KERNEL_NAME = "gibbs_posterior"
# Threads of a block (csrc/gibbs_posterior.cu kThreads: 8 warps); the
# most chains and rows (CDF rows to build) one block takes; the shared
# memory of a block of the small launch (no opt-in, several blocks per SM).
THREADS = 256
BLOCK_CHAINS = 256
BLOCK_ROWS = 256
SMALL_SMEM = 48 * 1024
_fn = None

TAG_INIT = 0 << 24
TAG_STEP = 1 << 24


@dataclass
class PosteriorJobs:
    """Clusters on one device: cluster b's scores start at
    ``score_offsets[b]`` of ``scores`` with row stride ``strides[b]``,
    (P, P) with P = ``n_cols[b]``; it runs ``n_chains[b]`` chains of
    ``n_burn[b] + n_its[b]`` steps on the stream of ``seeds[b]`` and
    writes ``n_chains[b] * n_its[b]`` pairs at int32 offset
    ``out_offsets[b]``.  The kernel's blocks are planned here once
    (:func:`plan_launches`): ``block_clusters`` holds every launch's
    clusters block by block, ``block_starts`` each launch's block offsets
    into its own clusters (blocks + 1 a launch, launch after launch), and
    ``table_offsets[b]`` the byte offset of cluster b's tables in its
    block's shared memory or, unstaged, in the global scratch.  ``host``
    holds the integer arrays on the host, by name."""

    scores: torch.Tensor         # float64, flat
    score_offsets: torch.Tensor  # int64 (n,)
    strides: torch.Tensor        # int64 (n,)
    n_cols: torch.Tensor         # int64 (n,)
    n_chains: torch.Tensor       # int64 (n,)
    n_burn: torch.Tensor         # int64 (n,)
    n_its: torch.Tensor          # int64 (n,)
    seeds: torch.Tensor          # int64 (n,)
    out_offsets: torch.Tensor    # int64 (n + 1,)
    table_offsets: torch.Tensor  # int64 (n,)
    block_clusters: torch.Tensor  # int64 (n,)
    block_starts: torch.Tensor   # int64 (sum over launches of blocks + 1,)
    launches: List[Launch]
    host: dict

    @property
    def n_clusters(self) -> int:
        return int(self.host["n_cols"].size)

    @property
    def device(self) -> torch.device:
        return self.scores.device


_FIELDS = ("score_offsets", "strides", "n_cols", "n_chains", "n_burn", "n_its")


def make_jobs(scores, score_offsets, strides, n_cols, sizing, seeds) -> PosteriorJobs:
    """:class:`PosteriorJobs` on the scores' device; ``sizing`` is one
    (chains, burn, its) per cluster, ``seeds`` unsigned 64-bit."""
    sizing = np.asarray(sizing, dtype=np.int64).reshape(-1, 3)
    host = {
        "score_offsets": np.asarray(score_offsets, dtype=np.int64).reshape(-1),
        "strides": np.asarray(strides, dtype=np.int64).reshape(-1),
        "n_cols": np.asarray(n_cols, dtype=np.int64).reshape(-1),
        "n_chains": sizing[:, 0].copy(),
        "n_burn": sizing[:, 1].copy(),
        "n_its": sizing[:, 2].copy(),
    }
    out_offsets = np.zeros(host["n_cols"].size + 1, dtype=np.int64)
    np.cumsum(2 * host["n_chains"] * host["n_its"], out=out_offsets[1:])
    host["out_offsets"] = out_offsets
    launches, starts, host["table_offsets"] = plan_launches(host["n_cols"], host["n_chains"])
    host["block_starts"] = starts
    device = scores.device
    seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1).view(np.int64)
    return PosteriorJobs(
        scores=scores,
        **{name: to_device(host[name], device) for name in _FIELDS},
        seeds=to_device(seeds, device),
        out_offsets=to_device(out_offsets, device),
        table_offsets=to_device(host["table_offsets"], device),
        block_clusters=launch_task_ids(launches, device),
        block_starts=to_device(np.concatenate(starts) if starts else np.zeros(0, np.int64), device),
        launches=launches,
        host=host,
    )


def posterior_gibbs(jobs: PosteriorJobs) -> torch.Tensor:
    """Every cluster's sampled pairs, int32, concatenated by
    ``out_offsets``, on the clusters' device.  CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if jobs.device.type == "cpu":
        return posterior_gibbs_plain(jobs)
    if jobs.device.type != "cuda":
        raise ValueError(f"posterior_gibbs: unsupported device {jobs.device}")
    return _launch(jobs)


# ------------------------------------------------------------ the kernel


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library(KERNEL_NAME).rpvg_gibbs_posterior_f64
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 3
        )
        _fn = fn
    return _fn


def table_bytes(n_cols) -> np.ndarray:
    """Bytes of a cluster's CDFs (8 P^2), in units of 16."""
    cols = np.asarray(n_cols, dtype=np.int64)
    return -(-8 * cols * cols // 16) * 16


def plan_launches(n_cols, n_chains) -> Tuple[List[Launch], List[np.ndarray], np.ndarray]:
    """The kernel's launches: the clusters whose tables
    (:func:`table_bytes`) fit ``SMALL_SMEM``, packed into blocks in order
    of tables, largest first, a block taking clusters while their tables
    fit ``SMALL_SMEM``, their chains ``BLOCK_CHAINS`` and their rows
    ``BLOCK_ROWS``; those that fit one block's shared memory
    (``SMEM_LIMIT``), a block each (they are few, and each is its launch's
    longest block); and the rest (tables in the global scratch), packed as
    the first kind but for shared memory.
    Returns (launches, whose ``tasks`` are their clusters block by block
    and ``smem_bytes`` the most one of their blocks stages; per launch its
    blocks' offsets into its ``tasks``, blocks + 1; per cluster the byte
    offset of its tables in its block's shared memory or, unstaged, in the
    scratch)."""
    cols = np.asarray(n_cols, dtype=np.int64).reshape(-1)
    chains = np.asarray(n_chains, dtype=np.int64).reshape(-1)
    need = table_bytes(cols)
    kind = np.where(need <= SMALL_SMEM, 0, np.where(need <= SMEM_LIMIT, 1, 2))
    offsets = np.zeros(cols.size, dtype=np.int64)
    launches, starts = [], []
    for k, budget in ((0, SMALL_SMEM), (1, SMEM_LIMIT), (2, None)):
        members = np.flatnonzero(kind == k)
        if not members.size:
            continue
        members = members[np.argsort(-need[members], kind="stable")]
        bounds, used, n_chain, n_row, most, at = [0], 0, 0, 0, 0, 0
        for i, c in enumerate(members.tolist()):
            b, ch, P = int(need[c]), int(chains[c]), int(cols[c])
            if i and (k == 1 or (budget is not None and used + b > budget)
                      or n_chain + ch > BLOCK_CHAINS or n_row + P > BLOCK_ROWS):
                bounds.append(i)
                used = n_chain = n_row = 0
            offsets[c] = at if budget is None else used
            at += b
            used += b
            n_chain += ch
            n_row += P
            most = max(most, used)
        bounds.append(members.size)
        staged = budget is not None
        launches.append(Launch(THREADS, staged, members, most if staged else 0))
        starts.append(np.asarray(bounds, dtype=np.int64))
    return launches, starts, offsets


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of the kernel resident on one SM at ``smem_bytes`` of
    dynamic shared memory, by the occupancy API."""
    fn = build.load_library(KERNEL_NAME).rpvg_gibbs_posterior_blocks_per_sm
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int64]
    return int(fn(int(smem_bytes)))


def _arguments(jobs: PosteriorJobs) -> List[tuple]:
    """Per launch, the kernel's arguments before and after its cluster
    list, checked (and the scratch allocated) at the first launch of
    ``jobs``, then kept in ``host``."""
    args = jobs.host.get("kernel_arguments")
    if args is None:
        host = jobs.host
        if jobs.scores.dtype != torch.float64 or not jobs.scores.is_contiguous():
            raise ValueError("posterior_gibbs: scores must be contiguous float64")
        if (host["n_burn"] + host["n_its"] >= 2**31).any() or (host["n_chains"] >= 2**31).any():
            raise ValueError("posterior_gibbs: more steps or chains than a 32-bit counter holds")
        need = table_bytes(host["n_cols"])
        scratch = torch.empty(
            max(1, sum(int(need[lc.tasks].sum()) for lc in jobs.launches if not lc.staged)),
            dtype=torch.uint8, device=jobs.device)
        head = (jobs.scores.data_ptr(), jobs.score_offsets.data_ptr(), jobs.strides.data_ptr(),
                jobs.n_cols.data_ptr(), jobs.n_chains.data_ptr(), jobs.n_burn.data_ptr(),
                jobs.n_its.data_ptr(), jobs.seeds.data_ptr(), jobs.table_offsets.data_ptr(),
                jobs.out_offsets.data_ptr())
        first = np.cumsum([0] + [a.size for a in host["block_starts"]])
        args = [
            (head, (jobs.block_starts[int(first[i]):].data_ptr(), host["block_starts"][i].size - 1,
                    int(launch.staged), launch.smem_bytes, scratch.data_ptr()))
            for i, launch in enumerate(jobs.launches)
        ]
        host["kernel_scratch"] = scratch
        host["kernel_arguments"] = args
    return args


def _launch(jobs: PosteriorJobs) -> torch.Tensor:
    global LAUNCHES, CLUSTERS
    out = torch.empty(int(jobs.host["out_offsets"][-1]), dtype=torch.int32, device=jobs.device)
    if jobs.n_clusters == 0:
        return out
    per_launch = dict(zip(map(id, jobs.launches), _arguments(jobs)))

    def call(launch: Launch, clusters: int, stream: int) -> int:
        head, tail = per_launch[id(launch)]
        return _kernel_fn()(*head, clusters, *tail, out.data_ptr(), stream)

    run_launches(KERNEL_NAME, jobs.launches, jobs.block_clusters, call)
    LAUNCHES += len(jobs.launches)
    CLUSTERS += jobs.n_clusters
    return out


# ------------------------------------------------------------ plain version


def warp_scan_cdfs(terms: torch.Tensor) -> torch.Tensor:
    """(n, P) normalised CDFs of rows of nonnegative terms, as a warp of
    the kernel builds them: inclusive prefix sums by 32 columns at a time
    (Hillis-Steele: column i adds column i - d for d = 1, 2, 4, 8, 16,
    the columns past P adding zeros), then a running maximum by the same
    32 columns (sums of the same terms in other orders may round 1 ulp
    apart; the maximum is exact and keeps every row nondecreasing, as a
    lower bound needs), each chunk plus the previous chunks' total, then
    every entry times one reciprocal of the last chunk's column 31 (the
    row's total)."""
    n, P = terms.shape
    chunks = -(-P // 32)
    x = terms.new_zeros((n, chunks, 32))
    x.view(n, -1)[:, :P] = terms
    for d in (1, 2, 4, 8, 16):
        x = torch.cat([x[..., :d], x[..., d:] + x[..., :-d]], dim=-1)
    carry = terms.new_zeros(n)
    x = torch.cummax(x, dim=-1).values
    for c in range(chunks):
        x[:, c] = x[:, c] + carry[:, None]
        carry = x[:, c, 31]
    return x.view(n, -1)[:, :P] * (1.0 / carry)[:, None]


def row_cdfs(jobs: PosteriorJobs) -> torch.Tensor:
    """(sum P, P_max) normalised CDF of every cluster's every row, as
    step 1 of the kernel builds them (:func:`warp_scan_cdfs` of
    exp(score - row maximum), 1 for a row with no finite maximum);
    columns past a cluster's P are +inf."""
    device = jobs.device
    host = jobs.host
    cols = host["n_cols"]
    Pm = int(cols.max()) if cols.size else 0
    row_cluster = np.repeat(np.arange(cols.size), cols)
    row_idx = np.concatenate([np.arange(P) for P in cols]) if cols.size else np.zeros(0, np.int64)
    col = np.arange(Pm)
    ok = col[None, :] < cols[row_cluster, None]
    pos = np.where(
        ok,
        host["score_offsets"][row_cluster, None]
        + row_idx[:, None] * host["strides"][row_cluster, None] + col[None, :],
        0,
    )
    ok_t = torch.from_numpy(ok).to(device)
    scores = torch.where(ok_t, jobs.scores[torch.from_numpy(pos).to(device)], -torch.inf)
    m = scores.max(dim=1).values
    finite = torch.isfinite(m)
    terms = torch.where(
        ok_t, torch.where(finite[:, None], torch.exp(scores - m[:, None]), 1.0), 0.0
    )
    return torch.where(ok_t, warp_scan_cdfs(terms), torch.inf)


def halving_search(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per row of (n, P) CDFs, the kernel's draw for uniform u (n,): the
    first column whose entry is not below u, or P - 1, by halving without
    branches (base moves up by half of the n columns left while the entry
    at base + half is below u; then one last comparison)."""
    n, P = cdf.shape
    rows = torch.arange(n, device=cdf.device)
    base = torch.zeros(n, dtype=torch.int64, device=cdf.device)
    left = P
    while left > 1:
        half = left >> 1
        base = torch.where(cdf[rows, base + half] < u, base + half, base)
        left -= half
    base = base + (cdf[rows, base] < u).to(torch.int64)
    return base.clamp(max=P - 1)


def posterior_gibbs_plain(jobs: PosteriorJobs) -> torch.Tensor:
    """The kernel's contract in plain PyTorch on the clusters' device:
    every chain of every cluster advances together, one step at a time,
    drawing at the kernel's counters; ``torch.searchsorted`` (left) is
    the kernel's lower bound."""
    device = jobs.device
    host = jobs.host
    out = torch.zeros(int(host["out_offsets"][-1]), dtype=torch.int32, device=device)
    n = jobs.n_clusters
    if n == 0:
        return out
    cdf = row_cdfs(jobs)
    cols = host["n_cols"]
    first_row = np.zeros(n, dtype=np.int64)
    first_row[1:] = np.cumsum(cols)[:-1]
    chains = host["n_chains"]
    chain_cluster = np.repeat(np.arange(n), chains)
    chain_idx = np.concatenate([np.arange(c) for c in chains])
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    from rpvg_tpu_torch import prng

    k0, k1 = prng.seed_words(jobs.seeds.cpu().numpy().view(np.uint64))
    key = (to_dev(k0[chain_cluster]), to_dev(k1[chain_cluster]))
    ch = to_dev(chain_idx)
    P = to_dev(cols[chain_cluster])
    base = to_dev(first_row[chain_cluster])
    burn = host["n_burn"][chain_cluster]
    its = host["n_its"][chain_cluster]
    out_at = to_dev(host["out_offsets"][:-1][chain_cluster] + 2 * chain_idx * its)
    its_t, burn_t = to_dev(its), to_dev(burn)

    u0, u1 = uniforms(ch, 0, 0, TAG_INIT, *key)
    Pd = P.to(torch.float64)
    g0 = torch.minimum(torch.floor(u0 * Pd).to(torch.int64), P - 1)
    g1 = torch.minimum(torch.floor(u1 * Pd).to(torch.int64), P - 1)

    def draw(other, u):
        hit = torch.searchsorted(cdf[base + other], u[:, None]).squeeze(1)
        return torch.minimum(hit, P - 1)

    steps = int((burn + its).max())
    for it in range(steps):
        live = it < burn_t + its_t
        u0, u1 = uniforms(ch, it, 0, TAG_STEP, *key)
        g0 = torch.where(live, draw(g1, u0), g0)
        g1 = torch.where(live, draw(g0, u1), g1)
        rec = it - burn_t
        keep = live & (rec >= 0)
        at = (out_at + 2 * rec)[keep]
        out[at] = g0[keep].to(torch.int32)
        out[at + 1] = g1[keep].to(torch.int32)
    return out
