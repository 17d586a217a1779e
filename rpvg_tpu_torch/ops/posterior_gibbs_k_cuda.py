"""Collapsed Gibbs sampling of haplotype groups over k slots: the CUDA
kernel ``csrc/gibbs_posterior_k.cu`` and its plain PyTorch version.

Counterpart of the XLA device function
``rpvg_tpu/infer/posteriors.py::_gibbs_chains_vmapped`` (core
``_gibbs_chains_core``) at every group size k != 2; group size 2 keeps
the pair-score sampler of ``ops/posterior_gibbs_cuda.py``, whose cached
conditionals cannot exist for k >= 3 (one slot's conditional depends on
the sum of the other k - 1).

A cluster is its probabilities (R, P), noise and counts (R,), log path
frequencies (P,), its chain, burn-in and sample counts
(``gibbs_iteration_counts``) and a 64-bit seed.  Every chain starts from
k paths uniform in [0, P) and runs burn + its iterations; an iteration
redraws slot j = 0 .. k-1 in turn from

    logits[p] = sum_r counts[r] * log(noise[r] + occupied[r] + probs[r, p] / k) + lf[p],
    occupied[r] = (sum_{i != j} probs[r, g_i]) / k

(the sum in slot order, recomputed at every step), by inverting one
uniform through the running sum of exp(logits - max) in path order.  The
output is every iteration's group, burn-in included: (chains,
burn + its, k) int32 per cluster, concatenated by ``out_offsets``.

Random bits: Philox4x32-10 keyed by the cluster's seed, the init draw of
slot j at counter (chain, 0, j, TAG_INIT), the step draw at (chain,
iteration, j, TAG_STEP); the kernel and the plain version draw the same
numbers, and a chain does not depend on its neighbours or on how many
iterations run after it.  The JAX package's sampler draws from threefry
with Gumbel noise, so the two agree in distribution only.

:func:`posterior_gibbs_k` dispatches on the clusters' device: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs
:func:`posterior_gibbs_k_plain`.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu_torch.infer.posteriors import _ceil_pow2
from rpvg_tpu_torch.ops import build
from rpvg_tpu_torch.ops.em_cuda import (
    SMEM_LIMIT,
    Launch,
    concat_to_device,
    launch_task_ids,
    offsets as _offsets,
    run_launches,
    to_device,
)
from rpvg_tpu_torch.ops.gibbs_cuda import uniforms

# Kernel launches, and clusters they covered, since the last reset.  Only
# a kernel launch adds to them.
LAUNCHES = 0
CLUSTERS = 0

KERNEL_NAME = "gibbs_posterior_k"
# Threads of a chain's block by its cluster's R * P: (most elements,
# threads), then 256.
_TEAMS = ((256, 32), (4096, 128))
_MAX_TEAM = 256
_fn = None

TAG_INIT = 0 << 24
TAG_STEP = 1 << 24

# Element bound of one padded (chains, R, P) batch of the plain version.
_PLAIN_ELEMENT_LIMIT = 1 << 24


@dataclass
class KSlotJobs:
    """Clusters concatenated without padding on one device: cluster b's
    probabilities are ``probs[mat_offsets[b]:]`` row-major (n_rows[b],
    n_cols[b]), its noise and counts at ``row_offsets[b]``, its log path
    frequencies at ``col_offsets[b]``; it runs ``n_chains[b]`` chains of
    ``n_burn[b] + n_its[b]`` iterations on the stream of ``seeds[b]`` and
    writes chains x iterations x k int32 at ``out_offsets[b]``.  The
    kernel's blocks, one per (cluster, chain), are planned here once:
    block i runs chain ``block_chain[i]`` of cluster ``block_cluster[i]``
    (an unstaged one with its workspace at ``block_scratch[i]`` of a
    scratch of ``scratch_doubles``), and ``launches`` list their blocks by
    index (``block_ids``).  ``host`` holds the integer arrays on the host,
    by name."""

    probs: torch.Tensor        # float64 (sum R P,)
    noise: torch.Tensor        # float64 (sum R,)
    counts: torch.Tensor       # float64 (sum R,)
    log_freqs: torch.Tensor    # float64 (sum P,)
    mat_offsets: torch.Tensor  # int64 (n,)
    row_offsets: torch.Tensor  # int64 (n,)
    col_offsets: torch.Tensor  # int64 (n,)
    n_rows: torch.Tensor       # int64 (n,)
    n_cols: torch.Tensor       # int64 (n,)
    n_chains: torch.Tensor     # int64 (n,)
    n_burn: torch.Tensor       # int64 (n,)
    n_its: torch.Tensor        # int64 (n,)
    seeds: torch.Tensor        # int64 (n,)
    out_offsets: torch.Tensor  # int64 (n + 1,)
    block_cluster: torch.Tensor  # int64 (blocks,)
    block_chain: torch.Tensor    # int64 (blocks,)
    block_scratch: torch.Tensor  # int64 (blocks,)
    block_ids: torch.Tensor      # int64 (blocks,)
    launches: List[Launch]
    scratch_doubles: int
    group_size: int
    host: dict

    @property
    def n_clusters(self) -> int:
        return int(self.host["n_rows"].size)

    @property
    def device(self) -> torch.device:
        return self.probs.device


_FIELDS = ("mat_offsets", "row_offsets", "col_offsets", "n_rows", "n_cols", "n_chains",
           "n_burn", "n_its", "out_offsets")


def make_jobs(
    inputs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    group_size: int,
    sizing,
    seeds,
    device: torch.device,
) -> KSlotJobs:
    """:class:`KSlotJobs` on ``device`` of (probs (R, P), noise (R,),
    counts (R,), log path frequencies (P,)) per cluster; ``sizing`` is
    one (chains, burn, its) per cluster, ``seeds`` unsigned 64-bit."""
    sizing = np.asarray(sizing, dtype=np.int64).reshape(-1, 3)
    rows = np.array([item[0].shape[0] for item in inputs], dtype=np.int64)
    cols = np.array([item[0].shape[1] for item in inputs], dtype=np.int64)
    host = {
        "mat_offsets": _offsets(rows * cols)[:-1],
        "row_offsets": _offsets(rows)[:-1],
        "col_offsets": _offsets(cols)[:-1],
        "n_rows": rows,
        "n_cols": cols,
        "n_chains": sizing[:, 0].copy(),
        "n_burn": sizing[:, 1].copy(),
        "n_its": sizing[:, 2].copy(),
    }
    host["out_offsets"] = _offsets(
        host["n_chains"] * (host["n_burn"] + host["n_its"]) * int(group_size)
    )
    launches, blocks, scratch_doubles = plan_blocks(rows, cols, host["n_chains"], group_size)
    seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1).view(np.int64)
    return KSlotJobs(
        probs=concat_to_device([item[0] for item in inputs], device),
        noise=concat_to_device([item[1] for item in inputs], device),
        counts=concat_to_device([item[2] for item in inputs], device),
        log_freqs=concat_to_device([item[3] for item in inputs], device),
        **{name: to_device(host[name], device) for name in _FIELDS},
        seeds=to_device(seeds, device),
        **{f"block_{name}": to_device(blocks[name], device)
           for name in ("cluster", "chain", "scratch")},
        block_ids=launch_task_ids(launches, device),
        launches=launches,
        scratch_doubles=scratch_doubles,
        group_size=int(group_size),
        host=host,
    )


def posterior_gibbs_k(jobs: KSlotJobs) -> torch.Tensor:
    """Every cluster's sampled groups, int32, concatenated by
    ``out_offsets``, on the clusters' device.  CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if jobs.device.type == "cpu":
        return posterior_gibbs_k_plain(jobs)
    if jobs.device.type != "cuda":
        raise ValueError(f"posterior_gibbs_k: unsupported device {jobs.device}")
    return _launch(jobs)


# ------------------------------------------------------------ the kernel


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library(KERNEL_NAME).rpvg_gibbs_posterior_k_f64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
        _fn = fn
    return _fn


def team_threads(rows, cols) -> np.ndarray:
    """Threads of a chain's block, from its cluster's R * P alone."""
    work = np.asarray(rows, dtype=np.int64) * np.asarray(cols, dtype=np.int64)
    threads = np.full(work.shape, _MAX_TEAM, dtype=np.int64)
    for most, team in reversed(_TEAMS):
        threads[work <= most] = team
    return threads


def workspace_doubles(rows, cols, threads) -> np.ndarray:
    """Doubles of a chain's workspace: R for noise + occupied, then S * P
    partial logits, S = threads // min(P, threads) row slices
    (csrc/gibbs_posterior_k.cu)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    threads = np.asarray(threads, dtype=np.int64)
    slices = threads // np.maximum(1, np.minimum(cols, threads))
    return rows + slices * cols


def shared_bytes(rows, cols, threads, group_size: int, staged) -> np.ndarray:
    """Dynamic shared memory of a chain's block: its k slots (int32,
    padded to 8 bytes), the maximum, and when staged its workspace and
    its (R, P) probabilities."""
    head = 8 * (1 + (int(group_size) + 1) // 2)
    body = 8 * (workspace_doubles(rows, cols, threads) + np.asarray(rows) * np.asarray(cols))
    return head + np.where(staged, body, 0)


def plan_launches(rows, cols, group_size: int) -> List[Launch]:
    """One launch per (team size, staged): every chain of a cluster is a
    block of its team; a cluster is staged when its probabilities and
    workspace fit one block's shared memory, else they are read from
    global memory and the workspace is a global scratch.  ``tasks`` are
    cluster indices; the kernel's blocks are their chains."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    threads = team_threads(rows, cols)
    staged = shared_bytes(rows, cols, threads, group_size, True) <= SMEM_LIMIT
    launches = []
    for team in sorted({t for _, t in _TEAMS} | {_MAX_TEAM}, reverse=True):
        for on_chip in (True, False):
            members = np.flatnonzero((threads == team) & (staged == on_chip))
            if members.size:
                smem = shared_bytes(rows[members], cols[members], team, group_size, on_chip)
                launches.append(Launch(team, on_chip, members, int(smem.max())))
    return launches


def plan_blocks(rows, cols, n_chains, group_size: int):
    """The kernel's blocks: :func:`plan_launches` with each cluster cut
    into its chains.  Returns (launches whose ``tasks`` are block
    indices, the blocks' ``cluster``, ``chain`` and ``scratch`` offsets by
    name, the scratch's doubles)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    n_chains = np.asarray(n_chains, dtype=np.int64).reshape(-1)
    launches, parts = [], {"cluster": [], "chain": [], "scratch": []}
    at = scratch = 0
    for launch in plan_launches(rows, cols, group_size):
        per = n_chains[launch.tasks]
        cluster = np.repeat(launch.tasks, per)
        parts["cluster"].append(cluster)
        parts["chain"].append(np.arange(cluster.size) - np.repeat(_offsets(per)[:-1], per))
        if launch.staged:
            parts["scratch"].append(np.zeros(cluster.size, dtype=np.int64))
        else:
            sizes = workspace_doubles(rows[cluster], cols[cluster], launch.threads)
            parts["scratch"].append(scratch + _offsets(sizes)[:-1])
            scratch += int(sizes.sum())
        launches.append(Launch(launch.threads, launch.staged, np.arange(at, at + cluster.size),
                               launch.smem_bytes))
        at += cluster.size
    blocks = {
        name: np.concatenate(arrays).astype(np.int64) if arrays else np.zeros(0, np.int64)
        for name, arrays in parts.items()
    }
    return launches, blocks, scratch


def _check(jobs: KSlotJobs) -> None:
    device = jobs.device
    for name in ("probs", "noise", "counts", "log_freqs"):
        t = getattr(jobs, name)
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"posterior_gibbs_k: {name} must be contiguous float64 on {device}")
    for name in _FIELDS + ("seeds", "block_cluster", "block_chain", "block_scratch", "block_ids"):
        t = getattr(jobs, name)
        if t.dtype != torch.int64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"posterior_gibbs_k: {name} must be contiguous int64 on {device}")
    host = jobs.host
    if jobs.group_size < 1:
        raise ValueError("posterior_gibbs_k: group size must be at least 1")
    if (host["n_cols"] < 1).any():
        raise ValueError("posterior_gibbs_k: every cluster needs a path")
    if (host["n_burn"] + host["n_its"] >= 2**32).any() or (host["n_chains"] >= 2**32).any():
        raise ValueError("posterior_gibbs_k: more steps or chains than a 32-bit counter holds")


def _launch(jobs: KSlotJobs) -> torch.Tensor:
    global LAUNCHES, CLUSTERS
    _check(jobs)
    device = jobs.device
    out = torch.empty(int(jobs.host["out_offsets"][-1]), dtype=torch.int32, device=device)
    if not jobs.launches:
        return out
    scratch = torch.empty(max(1, jobs.scratch_doubles), dtype=torch.float64, device=device)

    def call(launch: Launch, ids: int, stream: int) -> int:
        return _kernel_fn()(
            jobs.probs.data_ptr(), jobs.noise.data_ptr(), jobs.counts.data_ptr(),
            jobs.log_freqs.data_ptr(), jobs.mat_offsets.data_ptr(), jobs.row_offsets.data_ptr(),
            jobs.col_offsets.data_ptr(), jobs.n_rows.data_ptr(), jobs.n_cols.data_ptr(),
            jobs.n_chains.data_ptr(), jobs.n_burn.data_ptr(), jobs.n_its.data_ptr(),
            jobs.seeds.data_ptr(), jobs.out_offsets.data_ptr(), jobs.block_cluster.data_ptr(),
            jobs.block_chain.data_ptr(), jobs.block_scratch.data_ptr(), ids, scratch.data_ptr(),
            int(launch.tasks.size), jobs.group_size, launch.threads, int(launch.staged),
            launch.smem_bytes, out.data_ptr(), stream,
        )

    run_launches(KERNEL_NAME, jobs.launches, jobs.block_ids, call)
    LAUNCHES += len(jobs.launches)
    CLUSTERS += jobs.n_clusters
    return out


# ------------------------------------------------------------ plain version


def posterior_gibbs_k_plain(jobs: KSlotJobs) -> torch.Tensor:
    """The kernel's contract in plain PyTorch on the clusters' device:
    clusters are padded in buckets of (rows, paths) to powers of two
    (padded rows: unit noise, zero counts, zero probabilities, adding
    exactly 0 to every sum; padded paths never drawn), up to 2^24 padded
    (chains, R, P) elements a batch, and every chain of a batch advances
    together, slot step by slot step, on the kernel's Philox counters."""
    device = jobs.device
    host = jobs.host
    out = torch.zeros(int(host["out_offsets"][-1]), dtype=torch.int32, device=device)
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for b, (R, P) in enumerate(zip(host["n_rows"].tolist(), host["n_cols"].tolist())):
        buckets.setdefault((_ceil_pow2(R, floor=1), _ceil_pow2(P, floor=1)), []).append(b)
    for (R_pad, P_pad), members in buckets.items():
        batch, chains_in = [], 0
        for b in members:
            chains = int(host["n_chains"][b])
            if batch and (chains_in + chains) * R_pad * P_pad > _PLAIN_ELEMENT_LIMIT:
                _plain_batch(jobs, batch, R_pad, P_pad, out)
                batch, chains_in = [], 0
            batch.append(b)
            chains_in += chains
        _plain_batch(jobs, batch, R_pad, P_pad, out)
    return out


def _plain_batch(jobs: KSlotJobs, members: List[int], R_pad: int, P_pad: int,
                 out: torch.Tensor) -> None:
    from rpvg_tpu_torch import prng

    device = jobs.device
    host = jobs.host
    k = jobs.group_size
    n = len(members)
    probs = torch.zeros((n, R_pad, P_pad), dtype=torch.float64, device=device)
    noise = torch.ones((n, R_pad), dtype=torch.float64, device=device)
    counts = torch.zeros((n, R_pad), dtype=torch.float64, device=device)
    lf = torch.full((n, P_pad), -math.inf, dtype=torch.float64, device=device)
    for i, b in enumerate(members):
        R, P = int(host["n_rows"][b]), int(host["n_cols"][b])
        m0, r0, c0 = (int(host[name][b]) for name in ("mat_offsets", "row_offsets", "col_offsets"))
        probs[i, :R, :P] = jobs.probs[m0 : m0 + R * P].view(R, P)
        noise[i, :R] = jobs.noise[r0 : r0 + R]
        counts[i, :R] = jobs.counts[r0 : r0 + R]
        lf[i, :P] = jobs.log_freqs[c0 : c0 + P]

    members = np.asarray(members, dtype=np.int64)
    per = host["n_chains"][members]
    of = np.repeat(np.arange(n), per)             # chain -> batch slot
    cluster = members[of]
    chain = np.concatenate([np.arange(c) for c in per])
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    of_t = to_dev(of)
    probs, noise, counts, lf = probs[of_t], noise[of_t], counts[of_t], lf[of_t]
    probs_k = probs / k
    k0, k1 = prng.seed_words(jobs.seeds.cpu().numpy().view(np.uint64)[cluster])
    key = (to_dev(k0), to_dev(k1))
    ch = to_dev(chain)
    P = to_dev(host["n_cols"][cluster])
    steps = host["n_burn"][cluster] + host["n_its"][cluster]
    steps_t = to_dev(steps)
    out_at = to_dev(host["out_offsets"][cluster] + chain * steps * k)
    col_ok = torch.arange(P_pad, device=device)[None, :] < P[:, None]

    Pd = P.to(torch.float64)
    group = torch.empty((chain.size, k), dtype=torch.int64, device=device)
    for j in range(k):
        u, _ = uniforms(ch, 0, j, TAG_INIT, *key)
        group[:, j] = torch.minimum(torch.floor(u * Pd).to(torch.int64), P - 1)

    # Every step's uniform at once, (chains, steps, k): Philox on tensors
    # is some hundred small operations per call, too many to repeat at
    # every slot step.
    its = torch.arange(int(steps.max()), device=device)[None, :]
    u_steps = torch.stack(
        [uniforms(ch[:, None], its, j, TAG_STEP, key[0][:, None], key[1][:, None])[0]
         for j in range(k)],
        dim=2,
    )
    for it in range(int(steps.max())):
        live = it < steps_t
        for j in range(k):
            # Occupied mass of the other slots, summed in slot order.
            sel = torch.gather(probs, 2, group[:, None, :].expand(-1, R_pad, -1))  # (C, R, k)
            acc = sel[:, :, 0] * float(j != 0)
            for i in range(1, k):
                acc = acc + sel[:, :, i] * float(i != j)
            base = noise + acc / k
            # log, -inf where the argument is <= 0, in place.
            logs = torch.add(base[:, :, None], probs_k).clamp_min_(0.0).log_()
            logits = torch.einsum("cr,crp->cp", counts, logs) + lf
            logits = torch.where(torch.isnan(logits), -math.inf, logits)
            m = logits.max(dim=1).values
            weights = torch.where(
                col_ok,
                torch.where(torch.isfinite(m)[:, None], torch.exp(logits - m[:, None]), 1.0),
                0.0,
            )
            cum = torch.cumsum(weights, dim=1)
            target = u_steps[:, it, j] * cum[:, -1]
            pick = torch.minimum((cum < target[:, None]).sum(dim=1), P - 1)
            group[:, j] = torch.where(live, pick, group[:, j])
        at = (out_at + it * k)[live]
        for j in range(k):
            out[at + j] = group[live, j].to(torch.int32)
