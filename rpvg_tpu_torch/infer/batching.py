"""EM task batches (counterpart of ``rpvg_tpu/infer/batching.py``).

The JAX package hands the EM phase a list of per-task numpy inputs
``(probs (R, C), counts (R,))``.  Two routes carry them into the port's
device state:

* :func:`pack_ragged` concatenates them without padding in exactly the
  layout of ``run_native_em`` for the ragged kernel
  (``ops/em_cuda.py``), the default route of :func:`run_batched_em`;
* under the JAX package's own ``RPVG_TPU_FUSE_EM=1``,
  :func:`dispatch_em_device` pads them into the JAX package's shape
  buckets (:func:`plan_chunks`, :func:`build_block`), groups buckets
  into launches (:func:`plan_em_groups`) and solves each group with one
  launch of the multi-bucket kernel (``ops/em_fused_cuda.py``);
  :func:`gather_em_device` folds the results.

Both split the tasks over the data shards of the device
(``parallel/autoshard.py``): the ragged route in contiguous ranges, one
task set and one kernel call per shard, the multi-bucket route each
padded chunk whose batch divides the shard count.  Either way CUDA
tensors go to a kernel and CPU tensors to its plain version, and
sub-threshold mass is folded on the host, returning the
``(path read counts, noise count)`` contract of ``gather_em_device``.
On the CPU, :func:`run_batched_em` and :func:`dispatch_em_device` take
the JAX package's own CPU route when the native library is loaded:
:func:`run_native_em` (a verbatim copy), whose results are bitwise the
JAX package's, so that Gibbs chains started from them draw the same
samples.

The JAX package's device solve takes ``stage_floor`` for the fused
nested route's escalated tasks: it caps a solve at 128 and 1,024
iterations, re-runs only the clusters that have not converged at the
next cap, skips the caps at or below ``stage_floor`` and pads every
column axis of a small escalated set alike to limit recompiles
(``rpvg_tpu/infer/em.py:174-232``, ``batching.py:307-315``).  The
port's kernels run every task to its own convergence or ``max_em_its``
and compile once for every shape, so neither would change a result
here and the port takes no ``stage_floor``: an escalated task re-runs
from scratch on the device, up to ``max_em_its``, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu_torch import spans
from rpvg_tpu_torch.constants import MIN_EM_ABUNDANCE
from rpvg_tpu_torch.ops import em_cuda, em_fused_cuda
from rpvg_tpu_torch.ops.em_cuda import RaggedTasks
from rpvg_tpu_torch.ops.em_fused_cuda import Block
from rpvg_tpu_torch.parallel import autoshard

# Bytes of padded state (probabilities, counts, masks in float64) one
# launch of the multi-bucket kernel stages at most when buckets share it
# (the JAX package's 8 MiB VMEM group budget, em_pallas.py:103).  It
# sets which buckets share a launch, not the results.
_FUSED_LAUNCH_BYTES = 8 * 2**20


def _ceil_pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _ceil_pow4(n: int, floor: int = 8) -> int:
    """Coarser (4x-step) bucketing for the row axis: fewer compiled
    shapes at the cost of more padded compute."""
    size = floor
    while size < n:
        size *= 4
    return size


def em_postprocess(fracs: np.ndarray, total: float) -> Tuple[np.ndarray, float]:
    """The reference's sub-threshold folding (path_abundance_estimator.
    cpp:100-113): abundances below 1e-8 zero out, their mass plus the
    noise fraction becomes the noise count.  The masked sum runs
    SEQUENTIALLY in index order (cumsum), bitwise-matching the C++
    em_postprocess_one the native kernels use."""
    path_counts = fracs[:-1] * total
    low = fracs[:-1] < MIN_EM_ABUNDANCE
    low_counts = path_counts[low]
    noise_count = (
        float(low_counts.cumsum()[-1]) if low_counts.size else 0.0
    ) + float(fracs[-1] * total)
    path_counts = path_counts.copy()
    path_counts[low] = 0.0
    return path_counts, noise_count


def run_native_em(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_em_its: int,
    max_rel_em_conv: float,
    n_threads: int = 0,
    resume_state=None,
    concat=None,
) -> List[Tuple[np.ndarray, float]]:
    """Ragged batched EM through the C++ kernel (CPU speed path): no
    padding, no shape buckets, per-cluster loops on worker threads —
    bitwise identical to calling the kernel per cluster.  Returns the
    same (path read counts, noise count) contract as run_batched_em.

    `resume_state`: optional (init_fracs list (C_i+... = width per
    cluster), conv_its array) — continues a bounded run from its exit
    state bitwise-identically (escalated tasks skip re-running the
    budget).

    `concat`: optional (probs_flat, counts_flat) when the caller's
    cluster_inputs are already in-order views over contiguous streams
    (the fused kernel's escalated-task emission) — skips the Python
    per-cluster concatenation, which dominates this wrapper's cost."""
    import ctypes
    import os

    from ..native import load_library

    lib = load_library()
    n = len(cluster_inputs)
    n_rows = np.array([p.shape[0] for p, _ in cluster_inputs], dtype=np.int64)
    n_cols = np.array([p.shape[1] for p, _ in cluster_inputs], dtype=np.int64)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])

    if concat is not None:
        probs_concat = np.ascontiguousarray(concat[0], dtype=np.float64).ravel()
        counts_concat = np.ascontiguousarray(concat[1], dtype=np.float64)
        if probs_concat.size != int(mat_offsets[-1]) or counts_concat.size != int(
            row_offsets[-1]
        ):
            raise ValueError(
                "concat streams do not cover cluster_inputs exactly: "
                f"{probs_concat.size}/{int(mat_offsets[-1])} matrix elems, "
                f"{counts_concat.size}/{int(row_offsets[-1])} rows"
            )
    else:
        probs_concat = (
            np.concatenate(
                [np.ascontiguousarray(p, dtype=np.float64).ravel() for p, _ in cluster_inputs]
            )
            if n
            else np.empty(0, dtype=np.float64)
        )
        counts_concat = (
            np.concatenate([np.asarray(c, dtype=np.float64) for _, c in cluster_inputs])
            if n
            else np.empty(0, dtype=np.float64)
        )
    out_counts = np.empty(max(0, int(col_offsets[-1]) - n), dtype=np.float64)
    out_noise = np.empty(n, dtype=np.float64)

    if n_threads <= 0:
        from ..native import thread_budget

        n_threads = thread_budget()
    as_f64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    if not getattr(lib, "_em_counts_configured", False):
        lib.rpvg_em_ragged_counts_resume.restype = None
        lib.rpvg_em_ragged_counts_resume.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib._em_counts_configured = True
    init_fracs_ptr = ctypes.POINTER(ctypes.c_double)()
    init_conv_ptr = ctypes.POINTER(ctypes.c_int64)()
    if resume_state is not None:
        init_fracs, init_conv = resume_state
        init_fracs = np.ascontiguousarray(init_fracs, dtype=np.float64)
        init_conv = np.ascontiguousarray(init_conv, dtype=np.int64)
        assert init_fracs.size == int(col_offsets[-1])
        assert init_conv.size == n
        init_fracs_ptr = as_f64(init_fracs)
        init_conv_ptr = as_i64(init_conv)
    lib.rpvg_em_ragged_counts_resume(
        as_f64(probs_concat), as_f64(counts_concat),
        as_i64(mat_offsets), as_i64(row_offsets), as_i64(col_offsets),
        as_i64(n_rows), as_i64(n_cols), n,
        int(max_em_its), float(max_rel_em_conv), int(n_threads),
        init_fracs_ptr, init_conv_ptr,
        as_f64(out_counts), as_f64(out_noise),
    )

    results: List[Tuple[np.ndarray, float]] = []
    for i in range(n):
        path_counts = out_counts[col_offsets[i] - i : col_offsets[i + 1] - (i + 1)]
        results.append((path_counts, float(out_noise[i])))
    return results


def native_em_available() -> bool:
    import os

    if os.environ.get("RPVG_TPU_NATIVE_EM", "1") == "0":
        return False
    try:
        from rpvg_tpu_torch.native import load_library

        return load_library() is not None
    except Exception:
        return False


def pack_ragged(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    device: torch.device,
) -> RaggedTasks:
    """Concatenate per-task ``(probs (R, C), counts (R,))`` numpy inputs
    into one :class:`RaggedTasks` on ``device`` (offsets as in
    ``run_native_em``, ``rpvg_tpu/infer/batching.py:83-90``)."""
    n = len(cluster_inputs)
    n_rows = np.array([p.shape[0] for p, _ in cluster_inputs], dtype=np.int64)
    n_cols = np.array([p.shape[1] for p, _ in cluster_inputs], dtype=np.int64)
    mat_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows * n_cols, out=mat_offsets[1:])
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_rows, out=row_offsets[1:])
    col_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cols, out=col_offsets[1:])
    probs = (
        np.concatenate(
            [np.ascontiguousarray(p, dtype=np.float64).ravel() for p, _ in cluster_inputs]
        )
        if n
        else np.empty(0, dtype=np.float64)
    )
    counts = (
        np.concatenate([np.asarray(c, dtype=np.float64) for _, c in cluster_inputs])
        if n
        else np.empty(0, dtype=np.float64)
    )
    to_dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return RaggedTasks(
        probs=to_dev(probs),
        counts=to_dev(counts),
        mat_offsets=to_dev(mat_offsets),
        row_offsets=to_dev(row_offsets),
        col_offsets=to_dev(col_offsets),
        n_rows=to_dev(n_rows),
        n_cols=to_dev(n_cols),
        shapes=np.stack([n_rows, n_cols], axis=1),
    )


def run_batched_em(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_em_its: int,
    max_rel_em_conv: float,
    device: torch.device,
) -> List[Tuple[np.ndarray, float]]:
    """EM over every task on ``device``: the ragged kernel, or the
    multi-bucket kernel when :func:`fuse_em_enabled`.  Returns per task
    (path read counts, noise count) with the reference's sub-threshold
    folding, done in float64 on the host exactly like the native
    kernel's tail."""
    return run_batched_em_packed(cluster_inputs, max_em_its, max_rel_em_conv, device)[0]


@dataclass
class PackedShards:
    """The ragged task sets :func:`run_batched_em_packed` left on the
    devices, one per data shard that took tasks: ``parts[k]`` holds the
    caller's tasks ``starts[k]`` to ``starts[k] + parts[k].n_tasks``, on
    data shard ``shards[k]``."""

    parts: List[RaggedTasks]
    starts: List[int]
    shards: List[int]


def run_batched_em_packed(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_em_its: int,
    max_rel_em_conv: float,
    device: torch.device,
) -> Tuple[List[Tuple[np.ndarray, float]], Optional[PackedShards]]:
    """:func:`run_batched_em`, and the ragged task sets it packed on the
    devices for the ragged kernel (None on the native or multi-bucket
    route or with no tasks), so that a later phase reads the same
    matrices in place.  The tasks split over the data shards of
    ``device`` in contiguous ranges balanced by R * C
    (:func:`~rpvg_tpu_torch.parallel.autoshard.shard_tasks`), one kernel
    call per shard, every shard launched before any is read; the results
    come back in task order.  On the CPU the native kernel runs
    (:func:`run_native_em`, as in the JAX package, so a CPU run is
    bitwise the JAX package's) unless ``RPVG_TPU_NATIVE_EM=0`` or the
    multi-bucket route is asked for; then the kernels' plain versions.

    Spans, once a call: ``rpvg.em.launch``, the kernel calls and the one
    wait for their results (on the native and multi-bucket routes, the
    whole call); on the ragged route also ``rpvg.em.pack``, each shard's
    tasks packed and copied to its device (inside the launch span, once
    per shard that takes tasks), and ``rpvg.em.fold``, the results back
    in task order with the sub-threshold mass folded."""
    if not cluster_inputs:
        return [], None
    if device.type == "cpu" and not fuse_em_enabled() and native_em_available():
        with spans.Span("rpvg.em.launch"):
            return run_native_em(cluster_inputs, max_em_its, max_rel_em_conv), None
    if fuse_em_enabled():
        results: List[Tuple[np.ndarray, float]] = [None] * len(cluster_inputs)
        with spans.Span("rpvg.em.launch"):
            pending = dispatch_em_device(
                cluster_inputs, range(len(cluster_inputs)), max_em_its, max_rel_em_conv, device
            )
            gather_em_device(pending, cluster_inputs, results)
        return results, None
    devices = autoshard.data_devices(device)
    ranges = autoshard.shard_tasks([probs.shape for probs, _ in cluster_inputs], len(devices))
    packed = PackedShards([], [], [])
    launched = []
    # A shard's kernels start before the next shard packs, so each
    # shard's packing is a child of the launch span.
    with spans.Span("rpvg.em.launch"):
        for shard, ((lo, hi), shard_device) in enumerate(zip(ranges, devices)):
            if hi > lo:
                with spans.Span("rpvg.em.pack"):
                    tasks = pack_ragged(cluster_inputs[lo:hi], shard_device)
                packed.parts.append(tasks)
                packed.starts.append(lo)
                packed.shards.append(shard)
                launched.append(em_cuda.em_fixed_point(tasks, max_em_its, max_rel_em_conv)[0])
        # The call's one wait for the card.
        launched = [fracs.cpu() for fracs in launched]
    autoshard.count_shards("em_tasks", [hi - lo for lo, hi in ranges])
    results = []
    with spans.Span("rpvg.em.fold"):
        for start, tasks, fracs in zip(packed.starts, packed.parts, launched):
            results.extend(
                fold_fractions(fracs, tasks, cluster_inputs[start : start + tasks.n_tasks])
            )
    return results, packed


def fold_fractions(
    fracs: torch.Tensor,
    tasks: RaggedTasks,
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> List[Tuple[np.ndarray, float]]:
    """Per task (path read counts, noise count) from the fractions of
    :func:`em_cuda.em_fixed_point`, each task's total being the sum of
    its counts (as ``gather_em_device`` folds)."""
    fracs = fracs.cpu().numpy()
    col_offsets = tasks.col_offsets.cpu().numpy()
    return [
        em_postprocess(fracs[col_offsets[i] : col_offsets[i + 1]], float(counts.sum()))
        for i, (_, counts) in enumerate(cluster_inputs)
    ]


def fuse_em_enabled() -> bool:
    """Whether the multi-bucket fused EM launch is enabled.

    Fusion defaults OFF: the first end-to-end A/B (FUSE_AB_r05.json)
    measured the fused launch 2.6x slower than separate launches with
    the round-4 shared-loop kernel (convergence coupling) and still
    ~1.9x slower after per-block loops were decoupled — the single
    launch keeps every block VMEM-resident for the whole group while
    the (K-1) saved dispatches are only ~25-35ms each, an order of
    magnitude smaller.  The round-4 ">1ms dispatch => fuse" link gate
    was an inference from kernel-time neutrality under forced
    iterations, which is structurally blind to real power-law
    convergence.  RPVG_TPU_FUSE_EM=1 remains an explicit opt-in."""
    import os

    return os.environ.get("RPVG_TPU_FUSE_EM", "0") == "1"


def plan_chunks(
    shapes: Sequence[Tuple[int, int]], indices: Sequence[int], max_bucket_rows: int = 4096
) -> List[Tuple[List[int], int, int]]:
    """The JAX package's bucket plan (``rpvg_tpu/infer/batching.py:
    315-334``): the indexed tasks (``shapes[i]`` is task i's (R, C)) in
    buckets of rows padded to powers of four and columns to powers of
    two, each bucket cut into chunks of ``max(1, max_bucket_rows //
    R_pad) * 8`` tasks.  Returns (chunk indices, R_pad, C_pad) per
    chunk.  The batch axis is not padded."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for idx in indices:
        R, C = shapes[idx]
        buckets.setdefault((_ceil_pow4(R), _ceil_pow2(C)), []).append(idx)
    plans = []
    for (R_pad, C_pad), members in buckets.items():
        max_batch = max(1, max_bucket_rows // R_pad) * 8
        for start in range(0, len(members), max_batch):
            plans.append((members[start : start + max_batch], R_pad, C_pad))
    return plans


def plan_em_groups(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    indices: Sequence[int],
    max_bucket_rows: int = 4096,
) -> List[List[Tuple[List[int], int, int]]]:
    """The chunks of :func:`plan_chunks`, grouped into launches as
    ``dispatch_em_device`` groups them (``rpvg_tpu/infer/batching.py:
    389-421``): one chunk per launch, or under :func:`fuse_em_enabled`
    consecutive chunks whose padded bytes fit ``_FUSED_LAUNCH_BYTES``
    together; a chunk larger than that has a launch of its own."""
    shapes = [probs.shape for probs, _ in cluster_inputs]
    fuse = fuse_em_enabled()
    groups: List[List[Tuple[List[int], int, int]]] = []
    group_bytes = 0
    for chunk, R_pad, C_pad in plan_chunks(shapes, indices, max_bucket_rows):
        cost = len(chunk) * (R_pad * C_pad + R_pad + C_pad) * 8
        if not fuse or cost > _FUSED_LAUNCH_BYTES or not groups or (
            group_bytes + cost > _FUSED_LAUNCH_BYTES
        ):
            groups.append([])
            group_bytes = 0
        groups[-1].append((chunk, R_pad, C_pad))
        group_bytes += cost
    return groups


def _block_arrays(cluster_inputs, chunk, R_pad: int, C_pad: int):
    B = len(chunk)
    probs_pad = np.zeros((B, R_pad, C_pad), dtype=np.float64)
    counts_pad = np.zeros((B, R_pad), dtype=np.float64)
    col_masks = np.zeros((B, C_pad), dtype=np.float64)
    for b, idx in enumerate(chunk):
        probs, counts = cluster_inputs[idx]
        R, C = probs.shape
        probs_pad[b, :R, :C] = probs
        counts_pad[b, :R] = counts
        col_masks[b, :C] = 1.0
    return probs_pad, counts_pad, col_masks


def build_block(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    chunk: Sequence[int],
    R_pad: int,
    C_pad: int,
    device: torch.device,
) -> Block:
    """The chunk's tasks padded into one float64 ``(probs (B, R_pad,
    C_pad), counts (B, R_pad), col_masks (B, C_pad))`` block on
    ``device`` (``build_block`` of ``rpvg_tpu/infer/batching.py:336-346``):
    padded rows get zero counts, padded columns a zero mask."""
    return tuple(
        torch.from_numpy(a).to(device) for a in _block_arrays(cluster_inputs, chunk, R_pad, C_pad)
    )


def dispatch_em_device(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    indices: Sequence[int],
    max_em_its: int,
    max_rel_em_conv: float,
    device: torch.device,
    max_bucket_rows: int = 4096,
) -> List[Tuple[List[int], object]]:
    """Launch the indexed tasks' EM on the data shards of ``device``
    without waiting: per group of :func:`plan_em_groups`, each chunk's
    block split over the shards when its batch divides their count, else
    whole on the first (:func:`~rpvg_tpu_torch.parallel.autoshard.
    shard_batched`), then one :func:`em_fused_cuda.em_fixed_point_padded`
    call per shard on that shard's blocks.  Returns (chunk indices, (B, C)
    fractions) per shard's part of a chunk for :func:`gather_em_device`.

    On CUDA the call returns while its kernels run: the blocks go up from
    page-locked copies without waiting for the stream, and each cluster's
    extent is read from the host block, not back from the card, so the
    caller's host work overlaps the device's (the fused nested route's
    second native pass).  On the CPU the native kernel runs instead, as
    in :func:`run_batched_em_packed`, unless ``RPVG_TPU_NATIVE_EM=0`` or
    :func:`fuse_em_enabled`; its entries hold the folded results."""
    indices = list(indices)
    if device.type == "cpu" and not fuse_em_enabled() and native_em_available():
        if not indices:
            return []
        return [(indices, run_native_em(
            [cluster_inputs[idx] for idx in indices], max_em_its, max_rel_em_conv
        ))]
    devices = autoshard.data_devices(device)
    pending = []
    per_shard = [0] * len(devices)
    for group in plan_em_groups(cluster_inputs, indices, max_bucket_rows):
        shard_blocks = [[] for _ in devices]
        for chunk, R_pad, C_pad in group:
            arrays = _block_arrays(cluster_inputs, chunk, R_pad, C_pad)
            extents = em_fused_cuda.cluster_extents([arrays])
            parts = autoshard.shard_batched(devices, *arrays)
            size = len(chunk) // len(parts)
            for s, block in enumerate(parts):
                part = slice(s * size, (s + 1) * size)
                shard_blocks[s].append((list(chunk[part]), block, extents[part]))
        for s, items in enumerate(shard_blocks):
            if items:
                fracs, _ = em_fused_cuda.em_fixed_point_padded(
                    [block for _, block, _ in items], max_em_its, max_rel_em_conv,
                    np.concatenate([extents for _, _, extents in items]),
                )
                pending.extend(
                    (members, block_fracs) for (members, _, _), block_fracs in zip(items, fracs)
                )
                per_shard[s] += sum(len(members) for members, _, _ in items)
    autoshard.count_shards("em_tasks", per_shard)
    return pending


def gather_em_device(pending, cluster_inputs, results) -> None:
    """Wait for the pending chunks and fill ``results`` with the (path
    read counts, noise count) contract (sub-threshold folding in f64 on
    the host, exactly like the native kernel's tail; the native CPU
    route's entries are already folded)."""
    for chunk, fracs in pending:
        if isinstance(fracs, list):
            for idx, result in zip(chunk, fracs):
                results[idx] = result
            continue
        fracs = fracs.cpu().numpy()
        for b, idx in enumerate(chunk):
            probs, counts = cluster_inputs[idx]
            R, C = probs.shape
            total = float(counts.sum())
            results[idx] = em_postprocess(fracs[b, :C], total)
