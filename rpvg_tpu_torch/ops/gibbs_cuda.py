"""Read-count Gibbs sampling over ragged jobs: the CUDA kernel
``csrc/gibbs_readcount.cu`` and its plain PyTorch version.

Counterpart of the XLA device function
``rpvg_tpu/infer/readcount_gibbs.py::_gibbs_read_counts_vmapped``.  A
job samples one EM task of a :class:`~rpvg_tpu_torch.ops.em_cuda.
RaggedTasks` set (the set phase D packed, so its matrices are not
uploaded again) from the EM fractions, with its own sample count and its
own Philox stream (see the kernel's notes for the iteration and the
counters).

:func:`gibbs_read_counts` dispatches on the device of the jobs: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs
:func:`gibbs_read_counts_plain`.  The plain version repeats the kernel's
arithmetic step by step (the same products, sums in the same order, the
same Philox counters), so on the card the two draw the same chain and
their fractions differ in the last bits (the kernel fuses multiply-adds,
and the math libraries round apart), unless such a difference flips one
draw.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from rpvg_tpu_torch import prng, spans
from rpvg_tpu_torch.ops import build
from rpvg_tpu_torch.ops.em_cuda import (
    SMEM_LIMIT,
    Launch,
    RaggedTasks,
    launch_task_ids,
    run_launches,
    to_device,
)

KERNEL_NAME = "gibbs_readcount"
_TEAMS = (32, 64, 128, 256, 512)
# The most CTAs (a thread-block cluster) a job's rows split over.
_MAX_CTAS = 8
_fn = None

# Counter word 3 tags (gibbs_readcount.cu kTag*).
TAG_CATEGORICAL = 0 << 24
TAG_BINOMIAL = 1 << 24
TAG_EXPONENTIAL = 2 << 24
TAG_NORMAL = 3 << 24
TAG_ACCEPT = 4 << 24
TAG_BOOST = 5 << 24
MAX_ATTEMPTS = 1 << 20
# Rows of at most this many reads draw one categorical trial per read;
# larger rows split by binomials (gibbs_readcount.cu kMaxTrials).
MAX_TRIALS = 16384
# Trials per binary-search batch of the plain version ((trials, C) CDF rows).
_PLAIN_TRIAL_CHUNK = 1 << 16


@dataclass
class GibbsJobs:
    """Jobs over a ragged task set, on the tasks' device: job j samples
    task ``task_ids[j]`` from ``init_fracs[frac_offsets[j]:...]`` (its C
    fractions, noise last) with the Philox stream keyed by ``seeds[j]``
    (a 64-bit seed as int64) and keeps ``n_samples[j]`` samples, laid out
    (n_samples[j], C) at ``out_offsets[j]``.  ``host_task_ids`` and
    ``host_samples`` are the host copies the planner reads."""

    tasks: RaggedTasks
    task_ids: torch.Tensor      # int64 (J,)
    init_fracs: torch.Tensor    # float64 (sum C_j,)
    frac_offsets: torch.Tensor  # int64 (J + 1,)
    seeds: torch.Tensor         # int64 (J,)
    n_samples: torch.Tensor     # int64 (J,)
    out_offsets: torch.Tensor   # int64 (J + 1,)
    host_task_ids: np.ndarray
    host_samples: np.ndarray

    @property
    def n_jobs(self) -> int:
        return int(self.host_task_ids.size)

    @property
    def device(self) -> torch.device:
        return self.tasks.device

    @property
    def shapes(self) -> np.ndarray:
        """(J, 2) host (R, C) of every job's task."""
        return self.tasks.shapes[self.host_task_ids]


def make_jobs(
    tasks: RaggedTasks,
    task_ids: Sequence[int],
    init_fracs: Sequence[np.ndarray],
    seeds: Sequence[int],
    n_samples: Sequence[int],
) -> GibbsJobs:
    """:class:`GibbsJobs` on the tasks' device from host lists (seeds as
    unsigned 64-bit integers)."""
    device = tasks.device
    task_ids = np.asarray(task_ids, dtype=np.int64).reshape(-1)
    samples = np.asarray(n_samples, dtype=np.int64).reshape(-1)
    n = task_ids.size
    cols = tasks.shapes[task_ids, 1] if n else np.zeros(0, dtype=np.int64)
    frac_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cols, out=frac_offsets[1:])
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cols * samples, out=out_offsets[1:])
    fracs = (
        np.concatenate([np.asarray(f, dtype=np.float64).reshape(-1) for f in init_fracs])
        if n else np.zeros(0, dtype=np.float64)
    )
    if fracs.size != frac_offsets[-1]:
        raise ValueError("gibbs jobs: initial fractions do not match the tasks' columns")
    seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1).view(np.int64)
    return GibbsJobs(
        tasks=tasks,
        task_ids=to_device(task_ids, device),
        init_fracs=to_device(fracs, device),
        frac_offsets=to_device(frac_offsets, device),
        seeds=to_device(seeds, device),
        n_samples=to_device(samples, device),
        out_offsets=to_device(out_offsets, device),
        host_task_ids=task_ids,
        host_samples=samples,
    )


def gibbs_read_counts(jobs: GibbsJobs, thin_its: int, gamma: float) -> torch.Tensor:
    """Every job's kept fractions, concatenated by ``out_offsets``, on
    the jobs' device.  CUDA tensors go to the kernel, CPU tensors to the
    plain version."""
    if jobs.device.type == "cpu":
        return gibbs_read_counts_plain(jobs, thin_its, gamma)
    if jobs.device.type != "cuda":
        raise ValueError(f"gibbs_read_counts: unsupported device {jobs.device}")
    return _launch(jobs, thin_its, gamma)


# ------------------------------------------------------------ the kernel


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library(KERNEL_NAME).rpvg_gibbs_readcount_f64
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 15
            + [ctypes.c_int64] * 2 + [ctypes.c_double] + [ctypes.c_int64] * 4
            + [ctypes.c_void_p] * 2
        )
        _fn = fn
    return _fn


def _aligned(nbytes):
    return (np.asarray(nbytes, dtype=np.int64) + 7) // 8 * 8


def shared_bytes(rows, cols, staged) -> np.ndarray:
    """Dynamic shared memory of a CTA of ``rows`` rows: its weights, path
    counts (two int32 buffers) and blocks' sums; when staged also its
    rows' CDFs and P, and its row tables (int32: R + 2 trial starts and
    counts, R rows over MAX_TRIALS reads) (gibbs_readcount.cu)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    head = 8 * (2 * cols + -(-cols // 32))
    tables = _aligned(4 * (2 * rows + 2))
    return head + np.where(staged, 16 * rows * cols + tables, 0)


def scratch_doubles(rows, cols, staged) -> np.ndarray:
    """Doubles of a job's global scratch: none when staged, else its
    CDFs, its row tables and P transposed."""
    rows = np.asarray(rows, dtype=np.int64)
    cells = rows * np.asarray(cols, dtype=np.int64)
    return np.where(staged, 0, 2 * cells + rows + 1)


def team_threads(rows, cols, trials) -> np.ndarray:
    """Threads of a job's CTA, from its CTA's work per iteration: the
    least of _TEAMS that covers its rows (a lane per row CDF), its columns
    (a thread per Gamma draw) and half its categorical trials (two rounds
    of trials a warp)."""
    width = np.maximum(np.maximum(rows, cols), -(-np.asarray(trials, dtype=np.int64) // 2))
    threads = np.full(width.shape, _TEAMS[-1], dtype=np.int64)
    for team in reversed(_TEAMS):
        threads[width <= team] = team
    return threads


def plan_launches(rows, cols, trials) -> List[Launch]:
    """One launch per (CTAs, team size, staged), largest first.  A job
    runs staged on the fewest CTAs of a thread-block cluster, up to
    _MAX_CTAS, whose row slices' CDFs and P fit shared memory; a job too
    large for that runs unstaged on one CTA.  Its team is
    :func:`team_threads` of one CTA's share.  Raises ValueError for a job
    whose weights and counts alone do not fit."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    trials = np.asarray(trials, dtype=np.int64).reshape(-1)
    ctas = np.ones(rows.shape, dtype=np.int64)
    staged = np.zeros(rows.shape, dtype=bool)
    n = 1
    while n <= _MAX_CTAS:
        fits = ~staged & (shared_bytes(-(-rows // n), cols, True) <= SMEM_LIMIT)
        ctas[fits] = n
        staged |= fits
        n *= 2
    share = -(-rows // ctas)
    threads = team_threads(share, cols, -(-trials // ctas))
    need = shared_bytes(share, cols, staged)
    if (need > SMEM_LIMIT).any():
        i = int(np.flatnonzero(need > SMEM_LIMIT)[0])
        raise ValueError(f"{KERNEL_NAME}: a job of {cols[i]} columns does not fit shared memory")
    launches = []
    for n in sorted(set(ctas.tolist()), reverse=True):
        for team in reversed(_TEAMS):
            for on_chip in (True, False):
                members = np.flatnonzero((ctas == n) & (threads == team) & (staged == on_chip))
                if members.size:
                    launches.append(Launch(team, on_chip, members, int(need[members].max()), n))
    return launches


def job_trials(jobs: GibbsJobs) -> np.ndarray:
    """Per job, the categorical trials of one iteration: the reads of its
    rows of at most MAX_TRIALS reads (one device read-back)."""
    tasks = jobs.tasks
    counts = tasks.counts
    kept = torch.where(counts <= MAX_TRIALS, torch.floor(counts), torch.zeros_like(counts))
    running = torch.cat([torch.zeros(1, dtype=counts.dtype, device=counts.device),
                         torch.cumsum(kept, 0)])
    per_task = (running[tasks.row_offsets[1:]] - running[tasks.row_offsets[:-1]]).cpu().numpy()
    return per_task.astype(np.int64)[jobs.host_task_ids]


def _check_jobs(jobs: GibbsJobs) -> None:
    device = jobs.device
    for name, dtype in (
        ("init_fracs", torch.float64), ("task_ids", torch.int64), ("frac_offsets", torch.int64),
        ("seeds", torch.int64), ("n_samples", torch.int64), ("out_offsets", torch.int64),
    ):
        t = getattr(jobs, name)
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError(f"gibbs_read_counts: {name} must be contiguous {dtype} on {device}")
    tasks = jobs.tasks
    if tasks.probs.dtype != torch.float64 or tasks.counts.dtype != torch.float64:
        raise ValueError("gibbs_read_counts: task probabilities and counts must be float64")


def _launch(jobs: GibbsJobs, thin_its: int, gamma: float) -> torch.Tensor:
    """The kernel on ``jobs``; counts its launches (one per (team size,
    CTAs, staged)) and jobs in the run's ``gibbs.readcount.launches`` /
    ``.jobs``."""
    _check_jobs(jobs)
    if int(jobs.host_samples.max(initial=0)) * int(thin_its) >= 2**32:
        raise ValueError("gibbs_read_counts: more iterations than a 32-bit counter holds")
    device = jobs.device
    out_len = int(jobs.out_offsets[-1]) if jobs.n_jobs else 0
    out = torch.empty(out_len, dtype=torch.float64, device=device)
    active = np.flatnonzero(jobs.host_samples > 0)
    if not active.size:
        return out
    shapes = jobs.shapes[active]
    trials = job_trials(jobs)[active]
    if int(trials.max(initial=0)) >= 2**31:
        raise ValueError("gibbs_read_counts: more trials in a job than a 32-bit index holds")
    # The longest jobs first: in each launch by samples x (R C + trials),
    # the launches by their longest job.
    cost = jobs.host_samples[active] * (shapes[:, 0] * shapes[:, 1] + trials)
    planned = sorted(
        ((int(cost[lc.tasks].max()), lc) for lc in plan_launches(shapes[:, 0], shapes[:, 1], trials)),
        key=lambda item: -item[0],
    )
    launches = [
        Launch(lc.threads, lc.staged,
               active[lc.tasks[np.argsort(-cost[lc.tasks], kind="stable")]], lc.smem_bytes, lc.ctas)
        for _, lc in planned
    ]
    # Each unstaged job's global scratch.
    at = np.zeros(jobs.n_jobs, dtype=np.int64)
    members = np.concatenate([lc.tasks for lc in launches])
    staged = np.concatenate([np.full(lc.tasks.size, lc.staged) for lc in launches])
    sizes = scratch_doubles(jobs.shapes[members, 0], jobs.shapes[members, 1], staged)
    at[members] = np.cumsum(sizes) - sizes
    scratch = torch.empty(max(1, int(sizes.sum())), dtype=torch.float64, device=device)
    job_scratch = to_device(at, device)
    tasks = jobs.tasks

    def call(launch: Launch, ids: int, stream: int) -> int:
        return _kernel_fn()(
            tasks.probs.data_ptr(), tasks.counts.data_ptr(), jobs.init_fracs.data_ptr(),
            jobs.seeds.data_ptr(), tasks.mat_offsets.data_ptr(), tasks.row_offsets.data_ptr(),
            tasks.n_rows.data_ptr(), tasks.n_cols.data_ptr(), jobs.task_ids.data_ptr(),
            jobs.frac_offsets.data_ptr(), jobs.out_offsets.data_ptr(),
            jobs.n_samples.data_ptr(), ids, job_scratch.data_ptr(), scratch.data_ptr(),
            int(launch.tasks.size), int(thin_its), float(gamma), launch.threads,
            int(launch.staged), launch.ctas, launch.smem_bytes, out.data_ptr(), stream,
        )

    run_launches(KERNEL_NAME, launches, launch_task_ids(launches, device), call)
    spans.count("gibbs.readcount.launches", len(launches))
    spans.count("gibbs.readcount.jobs", int(active.size))
    return out

# ------------------------------------------------------------ plain version


def uniforms(c0, c1, c2, c3, k0, k1):
    """(u0, u1) float64 tensors of Philox4x32-10 at the counters, keyed
    by (k0, k1) (prng.philox4x32 and prng.uniform_pair; broadcast).  On
    the CPU the integer rounds run in numpy, which is exact and cheaper
    per small operation; elsewhere in torch on the tensors' device."""
    args = (c0, c1, c2, c3, k0, k1)
    device = next(a.device for a in args if torch.is_tensor(a))
    if device.type == "cpu":
        words = prng.philox4x32(*(a.numpy() if torch.is_tensor(a) else a for a in args))
        u0, u1 = prng.uniform_pair(
            [np.asarray(w, dtype=np.int64) for w in words], lambda a: a.astype(np.float64)
        )
        return torch.from_numpy(np.ascontiguousarray(u0)), torch.from_numpy(np.ascontiguousarray(u1))
    return prng.uniform_pair(prng.philox4x32(*args), lambda a: a.to(torch.float64))


def _sub(value, idx):
    """``value[idx]`` for a tensor, ``value`` for a Python int."""
    return value[idx] if torch.is_tensor(value) else value


def _binomial_inversion(n, p, key, t, r, c, u):
    """gibbs_readcount.cu binomial_inversion over 1-D tensors (n int64,
    p float64 with n p < 10 and 0 < p <= 0.5); ``u`` is attempt 0's
    uniform."""
    k0, k1 = key
    nd = n.to(torch.float64)
    q = 1.0 - p
    qn = torch.exp(nd * torch.log(q))
    np_ = nd * p
    bound = torch.minimum(nd, np_ + 10.0 * torch.sqrt(np_ * q + 1.0))
    x = torch.zeros_like(nd)
    px = qn
    attempt = torch.zeros_like(n)
    capped = torch.zeros_like(n, dtype=torch.bool)
    pending = u > px
    while bool(pending.any()):
        x1 = x + 1.0
        over = pending & (x1 > bound)
        step = pending & ~over
        u = torch.where(step, u - px, u)
        px = torch.where(step, ((nd - x1 + 1.0) * p * px) / (x1 * q), px)
        x = torch.where(step, x1, x)
        if bool(over.any()):
            # Past the bound: attempt + 1 restarts from x = 0 on a fresh uniform.
            idx = torch.nonzero(over).squeeze(1)
            attempt[idx] += 1
            capped[idx] = attempt[idx] >= MAX_ATTEMPTS
            x[idx] = 0.0
            px = torch.where(over, qn, px)
            u_new, _ = uniforms(
                t, _sub(r, idx), _sub(c, idx), TAG_BINOMIAL + attempt[idx], k0[idx], k1[idx]
            )
            u[idx] = u_new
        pending = pending & ~capped & (u > px)
    return torch.where(capped, torch.floor(np_), x).to(torch.int64)


def _binomial_btrs(n, p, key, t, r, c, first):
    """gibbs_readcount.cu binomial_btrs over 1-D tensors (n p >= 10,
    0 < p <= 0.5); ``first`` is attempt 0's pair of uniforms."""
    k0, k1 = key
    nd = n.to(torch.float64)
    q = 1.0 - p
    spq = torch.sqrt(nd * p * q)
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p
    cc = nd * p + 0.5
    vr = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    lpq = torch.log(p / q)
    m = torch.floor((nd + 1.0) * p)
    h = torch.lgamma(m + 1.0) + torch.lgamma(nd - m + 1.0)
    result = m.to(torch.int64)
    pending = torch.ones_like(n, dtype=torch.bool)
    idx = torch.arange(n.numel(), device=n.device)
    u0, u1 = first
    for attempt in range(MAX_ATTEMPTS):
        if attempt:
            idx = torch.nonzero(pending).squeeze(1)
            if not idx.numel():
                break
            u0, u1 = uniforms(
                t, _sub(r, idx), _sub(c, idx), TAG_BINOMIAL + attempt, k0[idx], k1[idx]
            )
        u = u0 - 0.5
        us = 0.5 - torch.abs(u)
        k = torch.floor((2.0 * a[idx] / us + b[idx]) * u + cc[idx])
        inside = (k >= 0.0) & (k <= nd[idx])
        quick = inside & (us >= 0.07) & (u1 <= vr[idx])
        v = torch.log(u1 * alpha[idx] / (a[idx] / (us * us) + b[idx]))
        kk = torch.where(inside, k, 0.0)
        bound = (
            h[idx] - torch.lgamma(kk + 1.0) - torch.lgamma(nd[idx] - kk + 1.0)
            + (kk - m[idx]) * lpq[idx]
        )
        accept = quick | (inside & (v <= bound))
        result[idx[accept]] = k[accept].to(torch.int64)
        pending[idx[accept]] = False
    return result


def binomial_plain(n, p, key, t, r, c, first=None):
    """gibbs_readcount.cu binomial over 1-D tensors: n >= 1 (int64),
    0 < p < 1; key (k0, k1) int64 tensors, counter (t, r, c) with r and c
    ints or tensors; ``first``: attempt 0's pair of uniforms when the
    caller drew them already."""
    if first is None:
        first = uniforms(t, r, c, TAG_BINOMIAL, key[0], key[1])
    flip = p > 0.5
    pp = torch.where(flip, 1.0 - p, p)
    inv = n.to(torch.float64) * pp < 10.0
    x = torch.zeros_like(n)
    for mask, method in ((inv, "inversion"), (~inv, "btrs")):
        idx = torch.nonzero(mask).squeeze(1)
        if not idx.numel():
            continue
        args = (n[idx], pp[idx], (key[0][idx], key[1][idx]), t, _sub(r, idx), _sub(c, idx))
        if method == "inversion":
            x[idx] = _binomial_inversion(*args, first[0][idx])
        else:
            x[idx] = _binomial_btrs(*args, (first[0][idx], first[1][idx]))
    return torch.where(flip, n - x, x)


def _gamma_mt(shape, key, t, c):
    """gibbs_readcount.cu gamma_mt over 1-D tensors (shape >= 1)."""
    k0, k1 = key
    d = shape - 1.0 / 3.0
    cm = 1.0 / torch.sqrt(9.0 * d)
    result = d.clone()
    pending = torch.ones_like(shape, dtype=torch.bool)
    tags = torch.tensor([[TAG_NORMAL, TAG_ACCEPT]], dtype=torch.int64, device=shape.device)
    for attempt in range(MAX_ATTEMPTS):
        idx = torch.nonzero(pending).squeeze(1)
        if not idx.numel():
            break
        # Both counters of the attempt in one call: the normal's pair and
        # the acceptance uniform.
        g0, g1 = uniforms(t, c[idx, None], attempt, tags, k0[idx, None], k1[idx, None])
        u = g0[:, 1]
        x = torch.sqrt(-2.0 * torch.log(g0[:, 0])) * torch.cos(math.pi * (2.0 * g1[:, 0]))
        v = 1.0 + cm[idx] * x
        positive = v > 0.0
        v = v * v * v
        x2 = x * x
        di = d[idx]
        safe_v = torch.where(positive, v, 1.0)
        accept = positive & (
            (u < 1.0 - 0.0331 * (x2 * x2))
            | (torch.log(u) < 0.5 * x2 + di * (1.0 - v + torch.log(safe_v)))
        )
        result[idx[accept]] = (di * v)[accept]
        pending[idx[accept]] = False
    return result


def gamma_plain(counts, gamma: float, key, t, c):
    """gibbs_readcount.cu gamma_draw over 1-D tensors: Gamma(count +
    gamma) at column c (tensor) of iteration t."""
    k0, k1 = key
    draws = torch.zeros_like(counts)
    if gamma == 1.0:
        small = counts <= 3.0
    else:
        small = torch.zeros_like(counts, dtype=torch.bool)
    idx = torch.nonzero(small).squeeze(1)
    if idx.numel():
        k = counts[idx].to(torch.int64) + 1
        halves = torch.arange(2, device=counts.device)[None, :]
        u0, u1 = uniforms(t, c[idx, None], halves, TAG_EXPONENTIAL, k0[idx, None], k1[idx, None])
        prod = torch.ones_like(counts[idx])
        for i, u in enumerate((u0[:, 0], u1[:, 0], u0[:, 1], u1[:, 1])):
            prod = torch.where(k > i, prod * u, prod)
        draws[idx] = -torch.log(prod)
    idx = torch.nonzero(~small).squeeze(1)
    if idx.numel():
        shape = counts[idx] + gamma
        boost = shape < 1.0
        key_i = (k0[idx], k1[idx])
        g = _gamma_mt(torch.where(boost, shape + 1.0, shape), key_i, t, c[idx])
        if bool(boost.any()):
            u, _ = uniforms(t, c[idx], 0, TAG_BOOST, key_i[0], key_i[1])
            g = torch.where(boost, g * torch.exp(torch.log(u) / shape), g)
        draws[idx] = g
    return draws


def gibbs_read_counts_plain(jobs: GibbsJobs, thin_its: int, gamma: float) -> torch.Tensor:
    """The kernel's contract in plain PyTorch on the jobs' device: all
    jobs advance together, one iteration at a time, each row and column
    drawing at the kernel's counters from the last iteration's Gamma
    draws (the starting fractions at first); a job stops keeping samples
    at its own count."""
    device = jobs.device
    tasks = jobs.tasks
    J = jobs.n_jobs
    out_len = int(jobs.out_offsets[-1]) if J else 0
    out = torch.zeros(out_len, dtype=torch.float64, device=device)
    if not J or int(jobs.host_samples.max()) == 0:
        return out
    shapes = jobs.shapes
    R_j, C_j = shapes[:, 0], shapes[:, 1]
    Cm = int(C_j.max())
    mat_off = tasks.mat_offsets.cpu().numpy()[jobs.host_task_ids]
    row_off = tasks.row_offsets.cpu().numpy()[jobs.host_task_ids]
    frac_off = jobs.frac_offsets.cpu().numpy()
    out_off = jobs.out_offsets.cpu().numpy()

    # Rows of every job, padded to Cm columns with zeros.
    row_job = np.repeat(np.arange(J), R_j)
    row_idx = np.concatenate([np.arange(R) for R in R_j]) if R_j.sum() else np.zeros(0, np.int64)
    row_cols = C_j[row_job]
    col = np.arange(Cm)
    cell_ok = col[None, :] < row_cols[:, None]
    cell_pos = np.where(
        cell_ok, mat_off[row_job, None] + row_idx[:, None] * row_cols[:, None] + col[None, :], 0
    )
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    probs = torch.where(to_dev(cell_ok), tasks.probs[to_dev(cell_pos)], 0.0)
    row_counts = tasks.counts[to_dev(row_off[row_job] + row_idx)]
    n_row = row_counts.to(torch.int64)
    job_ok = col[None, :] < C_j[:, None]
    weights = torch.where(
        to_dev(job_ok),
        jobs.init_fracs[to_dev(np.where(job_ok, frac_off[:-1, None] + col[None, :], 0))],
        0.0,
    )
    k0_all, k1_all = prng.seed_words(jobs.seeds.cpu().numpy().view(np.uint64))
    row_key = (to_dev(k0_all[row_job]), to_dev(k1_all[row_job]))
    job_col = np.repeat(np.arange(J), Cm)
    col_of = np.tile(col, J)
    col_live = job_ok.reshape(-1)
    gamma_idx = to_dev(np.flatnonzero(col_live))
    col_key = (to_dev(k0_all[job_col[col_live]]), to_dev(k1_all[job_col[col_live]]))
    col_t = to_dev(col_of[col_live])
    row_job_t = to_dev(row_job)
    row_t = to_dev(row_idx)
    row_last = to_dev(row_cols - 1)
    flat_row = row_job_t * Cm
    lanes = -(-Cm // 32) * 32
    butterfly = [torch.arange(32, device=device) ^ off for off in (16, 8, 4, 2, 1)]
    samples = to_dev(jobs.host_samples)
    out_cols = to_dev(np.where(job_ok, col[None, :], 0))
    out_base = to_dev(out_off[:-1])
    cols_t = to_dev(C_j)
    job_ok_t = to_dev(job_ok)

    iterations = int(jobs.host_samples.max()) * int(thin_its)
    for it in range(iterations):
        post = probs * weights[row_job_t]
        acc = torch.empty_like(post)
        running = torch.zeros(post.shape[0], dtype=torch.float64, device=device)
        for c in range(Cm):
            running = running + post[:, c]
            acc[:, c] = running
        live = (running > 0.0) & (n_row > 0)
        path_counts = torch.zeros(J * Cm, dtype=torch.float64, device=device)

        # n <= MAX_TRIALS: one categorical draw per trial (trial k of row r
        # at counter (it, r, k)), a binary search of the row's CDF: the
        # first column whose prefix sum exceeds the uniform times the mass.
        cat = torch.nonzero(live & (n_row <= MAX_TRIALS)).squeeze(1)
        if cat.numel():
            n_cat = n_row[cat]
            trial_row = torch.repeat_interleave(torch.arange(cat.numel(), device=device), n_cat)
            trial_k = torch.arange(trial_row.numel(), device=device) - (
                torch.cumsum(n_cat, 0) - n_cat
            )[trial_row]
            rows = cat[trial_row]
            u, _ = uniforms(
                it, row_t[rows], trial_k, TAG_CATEGORICAL, row_key[0][rows], row_key[1][rows]
            )
            x = u * running[rows]
            for lo in range(0, rows.numel(), _PLAIN_TRIAL_CHUNK):
                part = slice(lo, lo + _PLAIN_TRIAL_CHUNK)
                hit = torch.searchsorted(acc[rows[part]], x[part, None], right=True)[:, 0]
                hit = torch.minimum(hit, row_last[rows[part]])
                path_counts.index_add_(0, flat_row[rows[part]] + hit, torch.ones_like(x[part]))

        # n > MAX_TRIALS: binomial splits, column by column.
        big = torch.nonzero(live & (n_row > MAX_TRIALS)).squeeze(1)
        if big.numel():
            key_big = (row_key[0][big], row_key[1][big])
            r_big, last_col, base = row_t[big], row_last[big], flat_row[big]
            first0, first1 = uniforms(
                it, r_big[:, None], torch.arange(Cm, device=device)[None, :], TAG_BINOMIAL,
                key_big[0][:, None], key_big[1][:, None],
            )
            post_big = post[big]
            remaining = n_row[big]
            remaining_p = running[big]
            for c in range(Cm):
                active = (remaining > 0) & (last_col >= c)
                if not bool(active.any()):
                    break
                post_c = post_big[:, c]
                positive = remaining_p > 0.0
                ratio = torch.where(positive, post_c / torch.where(positive, remaining_p, 1.0), 0.0)
                ratio = torch.clamp(ratio, 0.0, 1.0)
                last = (last_col == c) | (ratio >= 1.0)
                draw = torch.where(active & last, remaining, 0)
                need = torch.nonzero(active & ~last & (ratio > 0.0)).squeeze(1)
                if need.numel():
                    draw[need] = binomial_plain(
                        remaining[need], ratio[need], (key_big[0][need], key_big[1][need]),
                        it, r_big[need], c, (first0[need, c], first1[need, c]),
                    )
                path_counts.index_add_(0, (base + c)[active], draw[active].to(torch.float64))
                remaining = remaining - draw
                remaining_p = torch.where(active, remaining_p - post_c, remaining_p)

        draws = torch.zeros(J * Cm, dtype=torch.float64, device=device)
        draws[gamma_idx] = gamma_plain(path_counts[gamma_idx], gamma, col_key, it, col_t)
        draws = draws.view(J, Cm)

        # The sum: each block of 32 columns by the butterfly (lane 0's
        # value), then the blocks in order.
        padded = torch.zeros(J, lanes, dtype=torch.float64, device=device)
        padded[:, :Cm] = draws
        lane = padded.view(J, lanes // 32, 32)
        for perm in butterfly:
            lane = lane + lane[:, :, perm]
        total = torch.zeros(J, dtype=torch.float64, device=device)
        for block in range(lanes // 32):
            total = total + lane[:, block, 0]
        weights = draws
        fracs = torch.where(job_ok_t, draws / total[:, None], 0.0)

        if (it + 1) % thin_its == 0:
            s = (it + 1) // thin_its - 1
            keep = job_ok_t & (samples[:, None] > s)
            pos = out_base[:, None] + s * cols_t[:, None] + out_cols
            out[pos[keep]] = fracs[keep]
    return out
