"""Ragged EM task batches (counterpart of ``rpvg_tpu/infer/batching.py``).

The JAX package hands the EM phase a list of per-task numpy inputs
``(probs (R, C), counts (R,))``.  :func:`pack_ragged` carries them into
the port's device state, concatenated without padding in exactly the
layout of ``run_native_em``; :func:`run_batched_em` solves every task
(the CUDA kernel for CUDA tensors, the padded plain version for CPU
tensors) and folds sub-threshold mass on the host, returning the
``(path read counts, noise count)`` contract of ``gather_em_device``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu.constants import MIN_EM_ABUNDANCE
from rpvg_tpu_torch.ops import em_cuda
from rpvg_tpu_torch.ops.em_cuda import RaggedTasks


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


def native_em_available() -> bool:
    import os

    if os.environ.get("RPVG_TPU_NATIVE_EM", "1") == "0":
        return False
    try:
        from rpvg_tpu.native import load_library

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
        max_rows=int(n_rows.max()) if n else 0,
        max_cols=int(n_cols.max()) if n else 0,
    )


def run_batched_em(
    cluster_inputs: Sequence[Tuple[np.ndarray, np.ndarray]],
    max_em_its: int,
    max_rel_em_conv: float,
    device: torch.device,
) -> List[Tuple[np.ndarray, float]]:
    """EM over every task on ``device``.  Returns per task (path read
    counts, noise count) with the reference's sub-threshold folding,
    done in float64 on the host exactly like the native kernel's tail."""
    if not cluster_inputs:
        return []
    tasks = pack_ragged(cluster_inputs, device)
    fracs, _ = em_cuda.em_fixed_point(tasks, max_em_its, max_rel_em_conv)
    return fold_fractions(fracs, tasks, cluster_inputs)


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
