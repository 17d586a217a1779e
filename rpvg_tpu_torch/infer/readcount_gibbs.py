"""Read-count Gibbs sampling over many jobs (counterpart of
``rpvg_tpu/infer/readcount_gibbs.py``; reference gibbsReadCountSampler,
src/path_abundance_estimator.cpp:116-212).

A job is one EM result: a noise-normalised matrix (R, P + 1), its read
counts (R,), the EM abundances (P,), the noise count and the total.  It
yields (noise samples (S,), path samples (S, P)) with sub-threshold
paths folded into the noise sample (:func:`_fold_low_abundance`).

:func:`run_batched_gibbs` picks the sampler from the device:

* ``cpu``: the native mt19937_64 sampler (:func:`run_native_gibbs`, a
  verbatim copy of the JAX package's), so a CPU run writes the JAX
  package's bytes; without the native library, the plain version;
* ``cuda``: the CUDA kernel ``csrc/gibbs_readcount.cu``
  (:mod:`rpvg_tpu_torch.ops.gibbs_cuda`), on the jobs' own sample
  counts: the counter-based stream makes a shorter run the exact prefix
  of a longer one, so no job is padded.  It never falls back.

Both draw from a 64-bit seed per job, the two words of its threefry key
(:func:`rpvg_tpu_torch.prng.key_seed`); the streams differ (mt19937_64
and Philox), so the devices agree in distribution, not draw for draw.
"""

from __future__ import annotations


import numpy as np
import torch

from rpvg_tpu_torch import prng
from rpvg_tpu_torch.constants import MIN_GIBBS_ABUNDANCE
from rpvg_tpu_torch.ops import gibbs_cuda
from rpvg_tpu_torch.ops.em_cuda import RaggedTasks


def _fold_low_abundance(fracs, total):
    """Shared tail: scale sampled fractions to counts and fold
    sub-threshold paths into the noise sample (reference :192-210)."""
    sampled = fracs * total
    path_samples = sampled[:, :-1].copy()
    noise_samples = sampled[:, -1].copy()
    low = fracs[:, :-1] < MIN_GIBBS_ABUNDANCE
    noise_samples += np.where(low, path_samples, 0.0).sum(axis=1)
    path_samples[low] = 0.0
    return noise_samples, path_samples


def run_native_gibbs(cluster_inputs, rng_keys, num_samples, thin_its, gamma=1.0):
    """CPU speed path: the C++ sampler runs each job's chain with an
    mt19937_64 stream seeded from its JAX key (distribution-preserving
    — the JAX and reference samplers draw different bits too; batching
    and prefix-slicing padded chains are bitwise stable because jobs
    are independent sequential streams).  Same input/output contract as
    the jitted sweep."""
    import ctypes
    import os

    from rpvg_tpu_torch.native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    if n == 0:
        return []
    n_rows = np.array([item[0].shape[0] for item in cluster_inputs], dtype=np.int64)
    n_cols = np.array([item[0].shape[1] for item in cluster_inputs], dtype=np.int64)
    # num_samples: one count per job, or a scalar for all — sequential
    # mt19937 streams make a shorter run the exact prefix of a longer
    # one, so per-job exact counts save the padded draws.
    if np.ndim(num_samples) == 0:
        samples_arr = np.full(n, int(num_samples), dtype=np.int64)
    else:
        samples_arr = np.asarray(num_samples, dtype=np.int64)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(samples_arr * n_cols, out=out_offsets[1:])

    probs_concat = np.concatenate(
        [np.ascontiguousarray(item[0], dtype=np.float64).ravel() for item in cluster_inputs]
    )
    counts_concat = np.concatenate(
        [np.asarray(item[1], dtype=np.float64) for item in cluster_inputs]
    )
    fracs_concat = np.concatenate(
        [
            np.concatenate(
                [np.asarray(item[2], dtype=np.float64) / item[4], [item[3] / item[4]]]
            )
            for item in cluster_inputs
        ]
    )
    seeds = np.array(
        [
            (np.uint64(np.asarray(key).astype(np.uint64)[0]) << np.uint64(32))
            | np.uint64(np.asarray(key).astype(np.uint64)[1])
            for key in rng_keys
        ],
        dtype=np.uint64,
    )
    out = np.empty(int(out_offsets[-1]), dtype=np.float64)

    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    lib.rpvg_gibbs_ragged(
        as_f64(probs_concat), as_f64(counts_concat), as_f64(fracs_concat),
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        as_i64(mat_offsets), as_i64(row_offsets), as_i64(col_offsets),
        as_i64(out_offsets), as_i64(n_rows), as_i64(n_cols), as_i64(samples_arr),
        n, int(thin_its), float(gamma), int(min(16, os.cpu_count() or 1)),
        as_f64(out),
    )

    results = []
    for i, item in enumerate(cluster_inputs):
        C = int(n_cols[i])
        fracs = out[out_offsets[i] : out_offsets[i + 1]].reshape(int(samples_arr[i]), C)
        results.append(_fold_low_abundance(fracs, item[4]))
    return results


def initial_fractions(item) -> np.ndarray:
    """A job's starting fractions: abundances / total, then noise /
    total (the order and arithmetic of ``run_native_gibbs``)."""
    return np.concatenate(
        [np.asarray(item[2], dtype=np.float64) / item[4], [item[3] / item[4]]]
    )


def run_batched_gibbs(
    cluster_inputs,
    rng_keys,
    num_samples,
    thin_its: int = 25,
    gamma: float = 1.0,
    device: torch.device = torch.device("cpu"),
    packed=None,
):
    """Sample read-count posteriors over many jobs on ``device``.

    cluster_inputs: per job (noise-normalised probs (R, P+1), counts
    (R,), abundances (P,), noise_count, total_count); rng_keys: one
    threefry key per job; num_samples: one count for all jobs or one per
    job.  ``packed``: the task sets phase D already holds on the devices
    (a :class:`~rpvg_tpu_torch.infer.batching.PackedShards`, or one
    :class:`RaggedTasks`) and each job's task index in the caller's task
    list, so the matrices are not uploaded again.  The jobs run on the
    data shards of ``device``: each job on the shard that holds its task
    (with ``packed``) or in contiguous ranges balanced by R * C, one
    sampler launch set per shard, task ids local to the shard; a job's
    seed stays its own, so its draws do not depend on the split.  Returns
    per job (noise_samples (S,), path_samples (S, P))."""
    from rpvg_tpu_torch.infer.batching import PackedShards, native_em_available, pack_ragged
    from rpvg_tpu_torch.parallel import autoshard

    if not cluster_inputs:
        return []
    if device.type == "cpu" and native_em_available():
        return run_native_gibbs(cluster_inputs, rng_keys, num_samples, thin_its, gamma)
    n = len(cluster_inputs)
    samples = (
        np.full(n, int(num_samples), dtype=np.int64)
        if np.ndim(num_samples) == 0
        else np.asarray(num_samples, dtype=np.int64)
    )
    shards = []  # (shard index, job indices, task set, task ids local to it)
    if packed is None:
        devices = autoshard.data_devices(device)
        shapes = [item[0].shape for item in cluster_inputs]
        ranges = autoshard.shard_tasks(shapes, len(devices))
        for shard, ((lo, hi), shard_device) in enumerate(zip(ranges, devices)):
            if hi > lo:
                tasks = pack_ragged([(item[0], item[1]) for item in cluster_inputs[lo:hi]],
                                    shard_device)
                shards.append((shard, np.arange(lo, hi), tasks, np.arange(hi - lo)))
    else:
        sets, task_ids = packed
        if isinstance(sets, RaggedTasks):
            sets = PackedShards([sets], [0], [0])
        task_ids = np.asarray(task_ids, dtype=np.int64)
        part_of = np.searchsorted(np.asarray(sets.starts), task_ids, side="right") - 1
        for k, (start, tasks, shard) in enumerate(zip(sets.starts, sets.parts, sets.shards)):
            members = np.flatnonzero(part_of == k)
            if members.size:
                shards.append((shard, members, tasks, task_ids[members] - start))
    launched = []
    per_shard = [0] * (1 + max(shard for shard, _, _, _ in shards))
    for shard, members, tasks, local_ids in shards:
        jobs = gibbs_cuda.make_jobs(
            tasks, local_ids, [initial_fractions(cluster_inputs[j]) for j in members],
            [prng.key_seed(rng_keys[j]) for j in members], samples[members],
        )
        launched.append((members, jobs, gibbs_cuda.gibbs_read_counts(jobs, thin_its, gamma)))
        per_shard[shard] = members.size
    autoshard.count_shards("gibbs_jobs", per_shard)
    results = [None] * n
    for members, jobs, out in launched:
        out = out.cpu().numpy()
        offsets = jobs.out_offsets.cpu().numpy()
        for b, j in enumerate(members):
            item = cluster_inputs[j]
            C = item[0].shape[1]
            fracs = out[offsets[b] : offsets[b + 1]].reshape(int(samples[j]), C)
            results[j] = _fold_low_abundance(fracs, item[4])
    return results
