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
from rpvg_tpu_torch import spans
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

KERNEL_NAME = "gibbs_posterior_k"
# A chain's team by its cluster's logs per slot step, R + nonzeros: the
# least power of two of threads, 32 to 1,024, that takes at most
# _ENTRIES_PER_THREAD each; past 1,024 threads a cluster of up to
# _MAX_CTAS CTAs of 1,024 splits the rows.
_ENTRIES_PER_THREAD = 8
_MAX_THREADS = 1024
_MAX_CTAS = 8
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
    writes chains x iterations x k int32 at ``out_offsets[b]``.  Its
    nonzero lists (:func:`nonzero_lists`, cut into ``n_ctas[b]`` row
    slices) start at ``nz_offsets[b]`` of ``nz_rows`` / ``nz_q`` and
    ``ptr_offsets[b]`` of ``nz_ptr``.  The kernel's chains are planned
    here once: chain entry i runs chain ``chain_index[i]`` of cluster
    ``chain_cluster[i]`` (an unstaged one with its workspace at
    ``chain_scratch[i]`` of a scratch of ``scratch_doubles``), and
    ``launches`` list their entries by index (``chain_ids``).  ``host``
    holds the integer arrays on the host, by name."""

    probs: torch.Tensor        # float64 (sum R P,)
    noise: torch.Tensor        # float64 (sum R,)
    counts: torch.Tensor       # float64 (sum R,)
    log_freqs: torch.Tensor    # float64 (sum P,)
    nz_rows: torch.Tensor      # int32 (nonzeros,)
    nz_q: torch.Tensor         # float64 (nonzeros,)
    nz_ptr: torch.Tensor       # int32 (sum C P + 1,)
    mat_offsets: torch.Tensor  # int64 (n,)
    row_offsets: torch.Tensor  # int64 (n,)
    col_offsets: torch.Tensor  # int64 (n,)
    nz_offsets: torch.Tensor   # int64 (n,)
    ptr_offsets: torch.Tensor  # int64 (n,)
    n_rows: torch.Tensor       # int64 (n,)
    n_cols: torch.Tensor       # int64 (n,)
    n_chains: torch.Tensor     # int64 (n,)
    n_burn: torch.Tensor       # int64 (n,)
    n_its: torch.Tensor        # int64 (n,)
    seeds: torch.Tensor        # int64 (n,)
    out_offsets: torch.Tensor  # int64 (n + 1,)
    chain_cluster: torch.Tensor  # int64 (chains,)
    chain_index: torch.Tensor    # int64 (chains,)
    chain_scratch: torch.Tensor  # int64 (chains,)
    chain_ids: torch.Tensor      # int64 (chains,)
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


_FIELDS = ("mat_offsets", "row_offsets", "col_offsets", "nz_offsets", "ptr_offsets", "n_rows",
           "n_cols", "n_chains", "n_burn", "n_its", "out_offsets")


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
    nonzeros = np.array([np.count_nonzero(item[0]) for item in inputs], dtype=np.int64)
    _, ctas = chain_team(rows, nonzeros)
    lists = [nonzero_lists(item[0], group_size, int(c)) for item, c in zip(inputs, ctas)]
    slice_nonzeros = np.array(
        [int(np.diff(ptr[::cols[b]]).max(initial=0)) for b, (_, _, ptr) in enumerate(lists)],
        dtype=np.int64,
    )
    host = {
        "mat_offsets": _offsets(rows * cols)[:-1],
        "row_offsets": _offsets(rows)[:-1],
        "col_offsets": _offsets(cols)[:-1],
        "nz_offsets": _offsets(nonzeros)[:-1],
        "ptr_offsets": _offsets(ctas * cols + 1)[:-1],
        "n_rows": rows,
        "n_cols": cols,
        "n_nonzeros": nonzeros,
        "n_ctas": ctas,
        "n_chains": sizing[:, 0].copy(),
        "n_burn": sizing[:, 1].copy(),
        "n_its": sizing[:, 2].copy(),
    }
    host["out_offsets"] = _offsets(
        host["n_chains"] * (host["n_burn"] + host["n_its"]) * int(group_size)
    )
    launches, chains, scratch_doubles = plan_chains(
        rows, cols, nonzeros, host["n_chains"], host["n_burn"] + host["n_its"], group_size,
        slice_nonzeros,
    )
    seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1).view(np.int64)
    return KSlotJobs(
        probs=concat_to_device([item[0] for item in inputs], device),
        noise=concat_to_device([item[1] for item in inputs], device),
        counts=concat_to_device([item[2] for item in inputs], device),
        log_freqs=concat_to_device([item[3] for item in inputs], device),
        nz_rows=_concat_int32([rows_ for rows_, _, _ in lists], device),
        nz_q=concat_to_device([q for _, q, _ in lists], device),
        nz_ptr=_concat_int32([ptr for _, _, ptr in lists], device),
        **{name: to_device(host[name], device) for name in _FIELDS},
        seeds=to_device(seeds, device),
        **{f"chain_{name}": to_device(chains[name], device)
           for name in ("cluster", "index", "scratch")},
        chain_ids=launch_task_ids(launches, device),
        launches=launches,
        scratch_doubles=scratch_doubles,
        group_size=int(group_size),
        host=host,
    )


def _concat_int32(arrays, device: torch.device) -> torch.Tensor:
    flat = np.concatenate(arrays) if arrays else np.zeros(0)
    return torch.from_numpy(np.ascontiguousarray(flat, dtype=np.int32)).to(device)


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
        fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int64] * 6 + [ctypes.c_void_p] * 2
        _fn = fn
    return _fn


def nonzero_lists(probs: np.ndarray, group_size: int, ctas: int):
    """A cluster's nonzero lists for the kernel: its rows cut into
    ``ctas`` slices of ceil(R / ctas), and in each slice every path's
    nonzero rows in row order.  Returns (rows local to their slice, int32;
    probs / k of each entry, float64; the first entry of (slice, path),
    int32 (ctas * P + 1,))."""
    probs = np.asarray(probs, dtype=np.float64)
    R, P = probs.shape
    rows_per = -(-R // ctas) if R else 1
    r, p = np.nonzero(probs)
    part = r // rows_per
    order = np.lexsort((r, p, part))
    r, p, part = r[order], p[order], part[order]
    ptr = np.zeros(ctas * P + 1, dtype=np.int64)
    np.cumsum(np.bincount(part * P + p, minlength=ctas * P), out=ptr[1:])
    return (r - part * rows_per).astype(np.int32), probs[r, p] / group_size, ptr.astype(np.int32)


def _ceil_pow2_array(values) -> np.ndarray:
    values = np.maximum(np.asarray(values, dtype=np.int64), 1)
    return (1 << np.ceil(np.log2(values)).astype(np.int64)).astype(np.int64)


def chain_team(rows, nonzeros):
    """(threads per CTA, CTAs per chain) of each cluster, from its logs
    per slot step (R + nonzeros) alone."""
    work = np.asarray(rows, dtype=np.int64) + np.asarray(nonzeros, dtype=np.int64)
    per = -(-work // _ENTRIES_PER_THREAD)
    threads = np.clip(_ceil_pow2_array(per), 32, _MAX_THREADS)
    ctas = np.where(threads == _MAX_THREADS,
                    np.clip(_ceil_pow2_array(-(-per // _MAX_THREADS)), 1, _MAX_CTAS), 1)
    return threads, ctas.astype(np.int64)


def shared_bytes(rows, cols, slice_nonzeros, group_size: int, ctas, staged) -> np.ndarray:
    """Dynamic shared memory of a chain's CTA: its k slots (int32, padded
    to 8 bytes), the weights, the double-buffered partials and bad-row
    hits, the warps' partials, the log frequencies; when staged also its rows' noise, counts,
    base and log, and its slice of the lists (entries and path starts).
    The dense probabilities stay in global memory: staging them too cost
    more in blocks per SM than it saved (34-35 ms against 45-46 ms on a
    1,263-cluster run, tools/torch_gibbs_profile.py)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    nonzeros = np.asarray(slice_nonzeros, dtype=np.int64)
    head = 8 * ((int(group_size) + 1) // 2 + 5 * cols + 68)
    rows_per = -(-rows // np.asarray(ctas, dtype=np.int64))
    body = 8 * (4 * rows_per + nonzeros) + 8 * (-(-(nonzeros + cols + 1) // 2))
    return head + np.where(staged, body, 0)


def plan_launches(rows, cols, nonzeros, group_size: int, slice_nonzeros=None) -> List[Launch]:
    """One launch per (threads, CTAs, staged), largest teams first:
    every chain of a cluster is a cluster of its CTAs; a cluster is staged
    when each CTA's rows and list slice (at most ``slice_nonzeros``
    entries; all ``nonzeros`` when not given) fit its shared memory, else
    they are read from global memory and the workspace is a global
    scratch.  ``tasks`` are cluster indices; the kernel's chains are
    their chains.  Raises ValueError for a cluster whose partials alone
    do not fit."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    nonzeros = np.asarray(nonzeros, dtype=np.int64).reshape(-1)
    slice_nonzeros = nonzeros if slice_nonzeros is None else np.asarray(
        slice_nonzeros, dtype=np.int64).reshape(-1)
    threads, ctas = chain_team(rows, nonzeros)
    head = shared_bytes(rows, cols, slice_nonzeros, group_size, ctas, False)
    if (head > SMEM_LIMIT).any():
        i = int(np.flatnonzero(head > SMEM_LIMIT)[0])
        raise ValueError(f"{KERNEL_NAME}: a cluster of {cols[i]} paths does not fit shared memory")
    staged = shared_bytes(rows, cols, slice_nonzeros, group_size, ctas, True) <= SMEM_LIMIT
    launches = []
    for team in sorted(set(zip(ctas.tolist(), threads.tolist())), reverse=True):
        for on_chip in (True, False):
            members = np.flatnonzero((ctas == team[0]) & (threads == team[1]) & (staged == on_chip))
            if members.size:
                smem = shared_bytes(rows[members], cols[members], slice_nonzeros[members],
                                    group_size, team[0], on_chip)
                launches.append(Launch(team[1], on_chip, members, int(smem.max()), team[0]))
    return launches


def plan_chains(rows, cols, nonzeros, n_chains, steps, group_size: int, slice_nonzeros=None):
    """The kernel's chain entries: :func:`plan_launches` with each cluster
    cut into its chains, the longest first in every launch (k x steps
    slot steps, each its logs per thread plus a barrier's worth), and the
    launches in order of their longest chain.  Returns (launches whose
    ``tasks`` are entry indices, the entries' ``cluster``, ``index`` and
    ``scratch`` offsets by name, the scratch's doubles)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    nonzeros = np.asarray(nonzeros, dtype=np.int64).reshape(-1)
    n_chains = np.asarray(n_chains, dtype=np.int64).reshape(-1)
    steps = np.asarray(steps, dtype=np.int64).reshape(-1)
    planned = []
    for launch in plan_launches(rows, cols, nonzeros, group_size, slice_nonzeros):
        members = launch.tasks
        per_thread = -(-(rows[members] + nonzeros[members]) // (launch.threads * launch.ctas))
        cost = int(group_size) * steps[members] * (per_thread + 8)
        order = np.argsort(-cost, kind="stable")
        planned.append((int(cost.max()), launch, members[order]))
    planned.sort(key=lambda item: -item[0])
    launches, parts = [], {"cluster": [], "index": [], "scratch": []}
    at = scratch = 0
    for _, launch, members in planned:
        per = n_chains[members]
        cluster = np.repeat(members, per)
        parts["cluster"].append(cluster)
        parts["index"].append(np.arange(cluster.size) - np.repeat(_offsets(per)[:-1], per))
        if launch.staged:
            parts["scratch"].append(np.zeros(cluster.size, dtype=np.int64))
        else:
            sizes = 2 * launch.ctas * -(-rows[cluster] // launch.ctas)
            parts["scratch"].append(scratch + _offsets(sizes)[:-1])
            scratch += int(sizes.sum())
        launches.append(Launch(launch.threads, launch.staged, np.arange(at, at + cluster.size),
                               launch.smem_bytes, launch.ctas))
        at += cluster.size
    chains = {
        name: np.concatenate(arrays).astype(np.int64) if arrays else np.zeros(0, np.int64)
        for name, arrays in parts.items()
    }
    return launches, chains, scratch


def _check(jobs: KSlotJobs) -> None:
    device = jobs.device
    for name in ("probs", "noise", "counts", "log_freqs", "nz_q"):
        t = getattr(jobs, name)
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"posterior_gibbs_k: {name} must be contiguous float64 on {device}")
    for name in ("nz_rows", "nz_ptr"):
        t = getattr(jobs, name)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"posterior_gibbs_k: {name} must be contiguous int32 on {device}")
    for name in _FIELDS + ("seeds", "chain_cluster", "chain_index", "chain_scratch", "chain_ids"):
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
    if (host["n_nonzeros"] >= 2**31).any():
        raise ValueError("posterior_gibbs_k: more nonzeros than a 32-bit list index holds")


def _launch(jobs: KSlotJobs) -> torch.Tensor:
    """The kernel on ``jobs``; counts its launches and clusters in the
    run's ``gibbs.kslot.launches`` / ``.clusters``."""
    _check(jobs)
    device = jobs.device
    out = torch.empty(int(jobs.host["out_offsets"][-1]), dtype=torch.int32, device=device)
    if not jobs.launches:
        return out
    scratch = torch.empty(max(1, jobs.scratch_doubles), dtype=torch.float64, device=device)

    def call(launch: Launch, ids: int, stream: int) -> int:
        return _kernel_fn()(
            jobs.probs.data_ptr(), jobs.noise.data_ptr(), jobs.counts.data_ptr(),
            jobs.log_freqs.data_ptr(), jobs.nz_rows.data_ptr(), jobs.nz_q.data_ptr(),
            jobs.nz_ptr.data_ptr(), jobs.mat_offsets.data_ptr(), jobs.row_offsets.data_ptr(),
            jobs.col_offsets.data_ptr(), jobs.nz_offsets.data_ptr(), jobs.ptr_offsets.data_ptr(),
            jobs.n_rows.data_ptr(), jobs.n_cols.data_ptr(), jobs.n_burn.data_ptr(),
            jobs.n_its.data_ptr(), jobs.seeds.data_ptr(), jobs.out_offsets.data_ptr(),
            jobs.chain_cluster.data_ptr(), jobs.chain_index.data_ptr(),
            jobs.chain_scratch.data_ptr(), ids, scratch.data_ptr(),
            int(launch.tasks.size), jobs.group_size, launch.threads, launch.ctas,
            int(launch.staged), launch.smem_bytes, out.data_ptr(), stream,
        )

    run_launches(KERNEL_NAME, jobs.launches, jobs.chain_ids, call)
    spans.count("gibbs.kslot.launches", len(jobs.launches))
    spans.count("gibbs.kslot.clusters", jobs.n_clusters)
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
