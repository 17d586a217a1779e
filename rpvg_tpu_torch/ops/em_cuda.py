"""EM fixed point over ragged tasks: the CUDA kernel
``csrc/em_fixed_point.cu`` and its plain PyTorch version.

Counterpart of ``rpvg_tpu/ops/em_pallas.py`` (``_em_kernel``).  The TPU
kernel took padded (B, R, C) float32 buckets; the CUDA kernel takes the
ragged float64 layout of :class:`RaggedTasks` directly, one thread block
per task (see the source for its design and bound).

:func:`em_fixed_point` dispatches on the device of the tensors it is
given: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
:func:`em_fixed_point_plain`.  The plain version itself accepts tensors
on any device, so the kernel can be held against it on the card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from rpvg_tpu_torch.infer.em import _em_solve_batched
from rpvg_tpu_torch.ops import build

# Kernel launches, and tasks they covered, since the last reset (a run
# can show that the main path went through the kernel).  Only a kernel
# launch adds to them.
LAUNCHES = 0
TASKS = 0

KERNEL_NAME = "em_fixed_point"
_THREADS = 128
# Tasks with at most this many rows keep q in shared memory.
_Q_SMEM_ROWS = 2048
_MAX_SMEM_BYTES = 227 * 1024
_fn = None


@dataclass
class RaggedTasks:
    """EM tasks concatenated without padding, as ``run_native_em`` lays
    them out: task i's matrix is ``probs[mat_offsets[i]:mat_offsets[i+1]]``
    row-major (n_rows[i], n_cols[i]), its counts
    ``counts[row_offsets[i]:row_offsets[i+1]]``, its output columns
    ``col_offsets[i]:col_offsets[i+1]``.  Tensors are on one device;
    ``max_rows``/``max_cols`` are host ints for launch sizing."""

    probs: torch.Tensor        # float64 (sum R_i * C_i,)
    counts: torch.Tensor       # float64 (sum R_i,)
    mat_offsets: torch.Tensor  # int64 (n + 1,)
    row_offsets: torch.Tensor  # int64 (n + 1,)
    col_offsets: torch.Tensor  # int64 (n + 1,)
    n_rows: torch.Tensor       # int64 (n,)
    n_cols: torch.Tensor       # int64 (n,)
    max_rows: int
    max_cols: int

    @property
    def n_tasks(self) -> int:
        return int(self.n_rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.probs.device


def em_fixed_point(
    tasks: RaggedTasks, max_em_its: int, max_rel_em_conv: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fractions laid out by col_offsets, iterations per task), on the
    tasks' device.  CUDA tensors go to the kernel, CPU tensors to the
    plain version."""
    if tasks.device.type == "cpu":
        return em_fixed_point_plain(tasks, max_em_its, max_rel_em_conv)
    if tasks.device.type != "cuda":
        raise ValueError(f"em_fixed_point: unsupported device {tasks.device}")
    return _launch(tasks, max_em_its, max_rel_em_conv)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library(KERNEL_NAME).rpvg_em_fixed_point_f64
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64]
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        )
        _fn = fn
    return _fn


def _check_inputs(tasks: RaggedTasks) -> None:
    device = tasks.device
    for name in ("probs", "counts"):
        t = getattr(tasks, name)
        if t.dtype != torch.float64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"em_fixed_point: {name} must be contiguous float64 on {device}")
    for name in ("mat_offsets", "row_offsets", "col_offsets", "n_rows", "n_cols"):
        t = getattr(tasks, name)
        if t.dtype != torch.int64 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"em_fixed_point: {name} must be contiguous int64 on {device}")
    if tasks.n_tasks >= 2**31:
        raise ValueError("em_fixed_point: more tasks than one grid can hold")


def _launch(tasks: RaggedTasks, max_em_its: int, max_rel_em_conv: float):
    global LAUNCHES, TASKS
    _check_inputs(tasks)
    device = tasks.device
    n = tasks.n_tasks
    n_out = int(tasks.col_offsets[-1]) if n else 0
    fracs = torch.empty(n_out, dtype=torch.float64, device=device)
    iters = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return fracs, iters
    q_rows = min(tasks.max_rows, _Q_SMEM_ROWS)
    smem_bytes = 8 * (2 * tasks.max_cols + _THREADS + q_rows)
    if smem_bytes > _MAX_SMEM_BYTES:
        raise ValueError(
            f"em_fixed_point: a task with {tasks.max_cols} columns needs "
            f"{smem_bytes} bytes of shared memory (limit {_MAX_SMEM_BYTES})"
        )
    total_rows = int(tasks.row_offsets[-1])
    q_scratch = torch.empty(
        total_rows if tasks.max_rows > q_rows else 1, dtype=torch.float64, device=device
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel_fn()(
            tasks.probs.data_ptr(), tasks.counts.data_ptr(),
            tasks.mat_offsets.data_ptr(), tasks.row_offsets.data_ptr(),
            tasks.col_offsets.data_ptr(), tasks.n_rows.data_ptr(),
            tasks.n_cols.data_ptr(), n, int(max_em_its), float(max_rel_em_conv),
            q_rows, q_scratch.data_ptr(), fracs.data_ptr(), iters.data_ptr(),
            _THREADS, smem_bytes, stream,
        )
    if rc != 0:
        raise RuntimeError(f"em_fixed_point kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    TASKS += n
    return fracs, iters


# ------------------------------------------------------------ plain version


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


def em_fixed_point_plain(
    tasks: RaggedTasks,
    max_em_its: int,
    max_rel_em_conv: float,
    max_bucket_rows: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch, on the tasks' device.

    Tasks are padded into the JAX package's buckets (rows to powers of
    four, columns to powers of two, ``infer/batching.py:303-334``),
    chunked to bound memory, and solved by the batched fixed point of
    :mod:`rpvg_tpu_torch.infer.em`.  Padded rows carry zero counts,
    padded columns a zero mask; each cluster freezes on its own, so the
    result does not depend on how tasks are batched."""
    device = tasks.device
    n_rows = tasks.n_rows.cpu().numpy()
    n_cols = tasks.n_cols.cpu().numpy()
    mat_off = tasks.mat_offsets.cpu().numpy()
    row_off = tasks.row_offsets.cpu().numpy()
    col_off = tasks.col_offsets.cpu().numpy()
    n = n_rows.size
    fracs = torch.zeros(int(col_off[-1]) if n else 0, dtype=torch.float64, device=device)
    iters = torch.zeros(n, dtype=torch.int64, device=device)

    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i in range(n):
        key = (_ceil_pow4(int(n_rows[i])), _ceil_pow2(int(n_cols[i])))
        buckets.setdefault(key, []).append(i)

    for (R_pad, C_pad), members in buckets.items():
        max_batch = max(1, max_bucket_rows // R_pad) * 8
        for start in range(0, len(members), max_batch):
            idx = np.asarray(members[start : start + max_batch], dtype=np.int64)
            rows, cols = n_rows[idx], n_cols[idx]
            r = np.arange(R_pad, dtype=np.int64)
            c = np.arange(C_pad, dtype=np.int64)
            row_ok = r[None, :] < rows[:, None]                       # (B, R_pad)
            col_ok = c[None, :] < cols[:, None]                       # (B, C_pad)
            cell_ok = row_ok[:, :, None] & col_ok[:, None, :]
            cell_pos = np.where(
                cell_ok,
                mat_off[idx, None, None] + r[None, :, None] * cols[:, None, None]
                + c[None, None, :],
                0,
            )
            row_pos = np.where(row_ok, row_off[idx, None] + r[None, :], 0)

            cell_ok_t = torch.from_numpy(cell_ok).to(device)
            row_ok_t = torch.from_numpy(row_ok).to(device)
            col_ok_t = torch.from_numpy(col_ok).to(device)
            probs = torch.where(
                cell_ok_t, tasks.probs[torch.from_numpy(cell_pos).to(device)], 0.0
            )
            counts = torch.where(
                row_ok_t, tasks.counts[torch.from_numpy(row_pos).to(device)], 0.0
            )
            col_masks = col_ok_t.to(torch.float64)
            block_fracs, _, block_iters = _em_solve_batched(
                probs, counts, col_masks, max_em_its, max_rel_em_conv
            )
            out_pos = torch.from_numpy(col_off[idx, None] + c[None, :]).to(device)
            fracs[out_pos[col_ok_t]] = block_fracs[col_ok_t]
            iters[torch.from_numpy(idx).to(device)] = block_iters
    return fracs, iters
