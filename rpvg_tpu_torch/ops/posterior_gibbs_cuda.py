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
from typing import List, Sequence

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
_TEAMS = (32, 64, 128, 256)
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
    ``out_offsets[b]``.  ``host`` holds the same integer arrays on the
    host, by name, for the planner."""

    scores: torch.Tensor         # float64, flat
    score_offsets: torch.Tensor  # int64 (n,)
    strides: torch.Tensor        # int64 (n,)
    n_cols: torch.Tensor         # int64 (n,)
    n_chains: torch.Tensor       # int64 (n,)
    n_burn: torch.Tensor         # int64 (n,)
    n_its: torch.Tensor          # int64 (n,)
    seeds: torch.Tensor          # int64 (n,)
    out_offsets: torch.Tensor    # int64 (n + 1,)
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
    device = scores.device
    seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1).view(np.int64)
    return PosteriorJobs(
        scores=scores,
        **{name: to_device(host[name], device) for name in _FIELDS},
        seeds=to_device(seeds, device),
        out_offsets=to_device(out_offsets, device),
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
            [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 4 + [ctypes.c_void_p] * 3
        )
        _fn = fn
    return _fn


def plan_launches(n_cols, n_chains) -> List[Launch]:
    """One launch per (team size, staged): a cluster's team is the least
    of 32, 64, 128 and 256 threads that covers max(P, chains); its CDFs
    are staged in shared memory when P * P doubles fit."""
    cols = np.asarray(n_cols, dtype=np.int64).reshape(-1)
    width = np.maximum(cols, np.asarray(n_chains, dtype=np.int64).reshape(-1))
    threads = np.full(width.shape, _TEAMS[-1], dtype=np.int64)
    for team in reversed(_TEAMS):
        threads[width <= team] = team
    need = 8 * cols * cols
    staged = need <= SMEM_LIMIT
    launches = []
    for team in reversed(_TEAMS):
        for on_chip in (True, False):
            members = np.flatnonzero((threads == team) & (staged == on_chip))
            if members.size:
                smem = int(need[members].max()) if on_chip else 0
                launches.append(Launch(team, on_chip, members, smem))
    return launches


def _launch(jobs: PosteriorJobs) -> torch.Tensor:
    global LAUNCHES, CLUSTERS
    if jobs.scores.dtype != torch.float64 or not jobs.scores.is_contiguous():
        raise ValueError("posterior_gibbs: scores must be contiguous float64")
    device = jobs.device
    host = jobs.host
    out = torch.empty(int(host["out_offsets"][-1]), dtype=torch.int32, device=device)
    n = jobs.n_clusters
    if n == 0:
        return out
    if (host["n_burn"] + host["n_its"] >= 2**32).any() or (host["n_chains"] >= 2**32).any():
        raise ValueError("posterior_gibbs: more steps or chains than a 32-bit counter holds")
    launches = plan_launches(host["n_cols"], host["n_chains"])
    unstaged = np.concatenate([lc.tasks for lc in launches if not lc.staged] or [np.zeros(0, np.int64)])
    cdf_offsets = np.zeros(n, dtype=np.int64)
    if unstaged.size:
        sizes = host["n_cols"][unstaged] ** 2
        cdf_offsets[unstaged] = np.cumsum(sizes) - sizes
    scratch = torch.empty(
        max(1, int((host["n_cols"][unstaged] ** 2).sum())), dtype=torch.float64, device=device
    )
    cdf_offsets_dev = to_device(cdf_offsets, device)

    def call(launch: Launch, ids: int, stream: int) -> int:
        return _kernel_fn()(
            jobs.scores.data_ptr(), jobs.score_offsets.data_ptr(), jobs.strides.data_ptr(),
            jobs.n_cols.data_ptr(), jobs.n_chains.data_ptr(), jobs.n_burn.data_ptr(),
            jobs.n_its.data_ptr(), jobs.seeds.data_ptr(), cdf_offsets_dev.data_ptr(),
            jobs.out_offsets.data_ptr(), ids, int(launch.tasks.size), launch.threads,
            int(launch.staged), launch.smem_bytes, scratch.data_ptr(), out.data_ptr(), stream,
        )

    run_launches(KERNEL_NAME, launches, launch_task_ids(launches, device), call)
    LAUNCHES += len(launches)
    CLUSTERS += n
    return out


# ------------------------------------------------------------ plain version


def row_cdfs(jobs: PosteriorJobs) -> torch.Tensor:
    """(sum P, P_max) normalised CDF of every cluster's every row, as
    step 1 of the kernel builds them (columns past a cluster's P repeat
    its last entry, 1)."""
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
    cdf = torch.empty_like(terms)
    acc = torch.zeros(terms.shape[0], dtype=torch.float64, device=device)
    for p in range(Pm):
        acc = acc + terms[:, p]
        cdf[:, p] = acc
    return cdf / acc[:, None]


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
