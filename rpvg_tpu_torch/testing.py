"""Seeded EM task sets shaped like the main path's phase D, read-count
Gibbs jobs on them, clusters for the posterior samplers and for the full
group enumeration, for holding the kernels against their plain versions
(tests and ``chip_smoke.py``); :func:`counted`, the counters of a block,
and :func:`shard_counts`, what each data shard took in a run.

Each task is a noise-normalised matrix (R, C) whose last column is the
noise probability, with integral read counts (R,), as phase C emits
them.  Sizes follow the main path's distribution at bench scale (rows:
median 3, at most 348; columns: median 9, at most 61).
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import Iterator, List, Tuple

import numpy as np

from rpvg_tpu_torch import spans

Task = Tuple[np.ndarray, np.ndarray]

MAX_ROWS = 348
MAX_COLS = 61


def random_task(rng: np.random.Generator, R: int, C: int) -> Task:
    probs = np.zeros((R, C), dtype=np.float64)
    for r in range(R):
        noise = rng.uniform(1e-4, 0.05)
        probs[r, -1] = noise
        if C > 1:
            k = 1 + rng.binomial(C - 2, 0.3) if C > 2 else 1
            cols = rng.choice(C - 1, size=k, replace=False)
            weights = rng.exponential(1.0, size=k)
            probs[r, cols] = (1.0 - noise) * weights / weights.sum()
    counts = rng.geometric(0.3, size=R).astype(np.float64)
    return probs, counts


def edge_case_tasks(rng: np.random.Generator) -> List[Task]:
    """R = 1; C = 1 (noise only); a task with an all-zero row and a
    zero-count row.  (Tasks that hit max_em_its come from running the
    random set with a small iteration cap.)"""
    tasks = [random_task(rng, 1, 5)]
    noise_only = rng.uniform(0.01, 1.0, size=(4, 1))
    tasks.append((noise_only, np.array([1.0, 3.0, 2.0, 5.0])))
    probs, counts = random_task(rng, 6, 4)
    probs[2] = 0.0
    counts[4] = 0.0
    tasks.append((probs, counts))
    return tasks


def em_task_set(n_tasks: int, seed: int) -> List[Task]:
    """``n_tasks`` random tasks (one of them at the largest main-path
    size) followed by :func:`edge_case_tasks`."""
    rng = np.random.default_rng(seed)
    tasks = [random_task(rng, MAX_ROWS, MAX_COLS)] if n_tasks else []
    while len(tasks) < n_tasks:
        R = int(np.clip(round(np.exp(rng.normal(np.log(3.0), 1.1))), 1, MAX_ROWS))
        C = int(np.clip(round(np.exp(rng.normal(np.log(9.0), 0.6))), 2, MAX_COLS))
        tasks.append(random_task(rng, R, C))
    return tasks + edge_case_tasks(rng)


Block = Tuple[np.ndarray, np.ndarray, np.ndarray]


def padded_block_set(seed: int) -> List[Block]:
    """Four differently shaped float64 ``(probs (B, R, C), counts (B, R),
    col_masks (B, C))`` blocks of random tasks padded with zeros, ragged
    in rows and columns inside each block; the first block's last slot
    is an all-zero dummy."""
    rng = np.random.default_rng(seed)
    blocks = []
    for k, (B, R, C) in enumerate(((3, 8, 8), (5, 32, 16), (2, 128, 8), (4, 8, 32))):
        probs = np.zeros((B, R, C))
        counts = np.zeros((B, R))
        masks = np.zeros((B, C))
        for b in range(B - 1 if k == 0 else B):
            n_rows = int(rng.integers(1, R + 1))
            n_cols = int(rng.integers(1, C + 1))
            probs[b, :n_rows, :n_cols], counts[b, :n_rows] = random_task(rng, n_rows, n_cols)
            masks[b, :n_cols] = 1.0
        blocks.append((probs, counts, masks))
    return blocks


GibbsJob = Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]


def gibbs_job(rng: np.random.Generator, probs: np.ndarray, counts: np.ndarray) -> GibbsJob:
    """A read-count Gibbs job (probs, counts, abundances, noise count,
    total) on a task, from random EM fractions."""
    total = float(counts.sum())
    fracs = rng.dirichlet(np.ones(probs.shape[1]))
    return probs, counts, fracs[:-1] * total, float(fracs[-1] * total), total


def gibbs_job_set(n_jobs: int, seed: int) -> List[GibbsJob]:
    """``n_jobs`` read-count Gibbs jobs on :func:`em_task_set` tasks, with
    counts scaled by 1-3 so that rows carry up to a few dozen reads,
    followed by :func:`gibbs_edge_jobs`."""
    rng = np.random.default_rng(seed)
    jobs = []
    for probs, counts in em_task_set(n_jobs, seed)[:n_jobs]:
        jobs.append(gibbs_job(rng, probs, counts * rng.integers(1, 4, size=counts.size)))
    return jobs + gibbs_edge_jobs(rng)


def gibbs_edge_jobs(rng: np.random.Generator) -> List[GibbsJob]:
    """C = 1 (noise only); rows whose sum is zero; counts of 5-40; one
    row with a count of 10^4; counts of 300-900 over 12 columns (all
    categorical trials, under the read-count sampler's MAX_TRIALS; rows
    over it split by binomials)."""
    noise_only = (rng.uniform(0.1, 1.0, size=(3, 1)), np.array([2.0, 7.0, 1.0]))
    zero_rows = rng.dirichlet(np.ones(4), size=6)
    zero_rows[[1, 4]] = 0.0
    big = rng.dirichlet(np.ones(5), size=8)
    huge = np.array([[0.35, 0.25, 0.3, 0.1]])
    jobs = [
        gibbs_job(rng, *noise_only),
        gibbs_job(rng, zero_rows, np.array([1.0, 3.0, 2.0, 1.0, 5.0, 2.0])),
        gibbs_job(rng, big, rng.integers(5, 40, size=8).astype(np.float64)),
        gibbs_job(rng, huge, np.array([1e4])),
    ]
    split = rng.dirichlet(np.full(12, 0.3), size=5)
    jobs.append(gibbs_job(rng, split, rng.integers(300, 900, size=5).astype(np.float64)))
    return jobs


PosteriorCluster = Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]


def posterior_cluster_set(n_clusters: int, seed: int, max_paths: int = 28) -> List[PosteriorCluster]:
    """``n_clusters`` diploid clusters (probs (R, P), noise (R,), counts
    (R,), path source counts) with P up to ``max_paths``, one of them
    with a single path.  The default is one gene's 7 isoforms x 4
    haplotypes; clusters that join genes are wider (up to 120 paths in
    chip_smoke.py's 100k-pair run)."""
    rng = np.random.default_rng(seed)
    clusters = []
    for i in range(n_clusters):
        P = 1 if i == 0 else int(rng.integers(2, max_paths + 1))
        R = int(np.clip(round(np.exp(rng.normal(np.log(20.0), 1.0))), 1, 400))
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.5)
        probs[np.arange(R), rng.integers(0, P, size=R)] += rng.random(R)
        clusters.append(
            (probs, rng.uniform(1e-4, 0.05, R), rng.geometric(0.4, size=R).astype(np.float64),
             rng.integers(1, 4, size=P).tolist())
        )
    return clusters


def posterior_wide_cluster(n_paths: int, seed: int, n_rows: int = 30) -> PosteriorCluster:
    """One cluster of ``n_rows`` reads (30 by default) over ``n_paths``
    paths, 30 % of its probabilities nonzero: at 200 paths its (P, P)
    CDFs do not fit one block's shared memory, and at 200 paths and 150
    rows neither do its probabilities for the k-slot sampler."""
    rng = np.random.default_rng(seed)
    probs = rng.random((n_rows, n_paths)) * (rng.random((n_rows, n_paths)) < 0.3)
    return probs, np.full(n_rows, 0.01), np.ones(n_rows), [1] * n_paths


def enumeration_max_paths(group_size: int, max_paths: int = 32) -> int:
    """The most paths, up to ``max_paths``, whose padded enumeration
    (paths to a power of two) ``full_posteriors_batched`` scores on the
    device rather than on the host."""
    from rpvg_tpu_torch.infer.posteriors import _FULL_ENUM_GROUP_LIMIT, _ceil_pow2

    P = max_paths
    while P > 1 and math.comb(_ceil_pow2(P) + group_size - 1, group_size) > _FULL_ENUM_GROUP_LIMIT:
        P -= 1
    return P


def enumeration_cluster_set(n_clusters: int, seed: int, group_size: int,
                            max_paths: int = 32, max_rows: int = 512) -> List[PosteriorCluster]:
    """``n_clusters`` clusters for the full enumeration at ``group_size``,
    with P up to :func:`enumeration_max_paths` (32 at group sizes 1-4, 16
    at 5): the first of one path, the second of the most paths and
    ``max_rows`` rows (its probabilities take several passes of one
    block's shared memory), the third with a row of zero noise and zero
    probabilities on most paths (groups scored -inf), the rest as
    :func:`posterior_cluster_set` draws them."""
    rng = np.random.default_rng(seed)
    top = enumeration_max_paths(group_size, max_paths)
    clusters = []
    for i in range(n_clusters):
        P = 1 if i == 0 else top if i == 1 else int(rng.integers(2, top + 1))
        R = max_rows if i == 1 else int(np.clip(round(np.exp(rng.normal(np.log(20.0), 1.0))), 1, max_rows))
        probs = rng.random((R, P)) * (rng.random((R, P)) < 0.5)
        probs[np.arange(R), rng.integers(0, P, size=R)] += rng.random(R)
        noise = rng.uniform(1e-4, 0.05, R)
        if i == 2:
            noise[0] = 0.0
            probs[0] = 0.0
            probs[0, 0] = 0.5
        clusters.append(
            (probs, noise, rng.geometric(0.4, size=R).astype(np.float64),
             rng.integers(1, 4, size=P).tolist())
        )
    return clusters


def gibbs_jobs_on(inputs: List[GibbsJob], device, samples, seed: int):
    """:class:`rpvg_tpu_torch.ops.gibbs_cuda.GibbsJobs` of ``inputs`` on
    ``device`` (freshly packed), job i keyed by the i-th key of a split
    of ``seed``'s key, keeping ``samples[i]`` samples."""
    from rpvg_tpu_torch import prng
    from rpvg_tpu_torch.infer.batching import pack_ragged
    from rpvg_tpu_torch.infer.readcount_gibbs import initial_fractions
    from rpvg_tpu_torch.ops import gibbs_cuda

    keys = prng.split(prng.prng_key(seed), len(inputs))
    tasks = pack_ragged([(item[0], item[1]) for item in inputs], device)
    return gibbs_cuda.make_jobs(
        tasks, np.arange(len(inputs)), [initial_fractions(item) for item in inputs],
        [prng.key_seed(key) for key in keys], samples,
    )


@contextlib.contextmanager
def counted() -> Iterator[collections.Counter]:
    """The counters of a run opened around the block
    (:mod:`rpvg_tpu_torch.spans`), filled in when it ends; a counter the
    run never added to reads 0.  Inside a run already open on the thread
    the block would count into that run, so that raises RuntimeError."""
    if spans.current_run() is not None:
        raise RuntimeError("counted() inside an open run: the block's counters are that run's")
    counters = collections.Counter()
    with spans.RunSpan("rpvg.counted") as run:
        yield counters
    counters.update(run.run.counters)


def shard_counts(counters, items: str = "") -> List[int]:
    """Per data shard, its counters ``shard.<s>.<items>`` of a run's
    ``counters`` (``parallel/autoshard.count_shards``), every kind of item
    summed when ``items`` is empty."""
    per_shard = collections.Counter()
    for name, n in counters.items():
        parts = name.split(".")
        if parts[0] == "shard" and (not items or parts[2] == items):
            per_shard[int(parts[1])] += n
    return [per_shard[s] for s in range(max(per_shard, default=-1) + 1)]
