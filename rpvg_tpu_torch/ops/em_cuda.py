"""EM fixed point over ragged tasks: the CUDA kernel
``csrc/em_fixed_point.cu`` and its plain PyTorch version.

Counterpart of ``rpvg_tpu/ops/em_pallas.py`` (``_em_kernel``).  The TPU
kernel took padded (B, R, C) float32 buckets; the CUDA kernel takes the
ragged float64 layout of :class:`RaggedTasks` directly.  Each task runs
as a team sized to it (a warp, or a block of 128 to 1,024 threads) with
its P staged in shared memory where it fits; :func:`plan_launches`
groups the tasks into one launch per team size, and the multi-bucket
kernel (``em_fused_cuda``) uses the same plan (see ``csrc/em_task.cuh``
for the loop's design and bound).

:func:`em_fixed_point` dispatches on the device of the tensors it is
given: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
:func:`em_fixed_point_plain`.  The plain version itself accepts tensors
on any device, so the kernel can be held against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu_torch import spans
from rpvg_tpu_torch.infer.em import _em_solve_batched
from rpvg_tpu_torch.ops import build

KERNEL_NAME = "em_fixed_point"
# Shared memory one block may have on an H100 (227 KB).
SMEM_LIMIT = 232_448
# Tasks of at most this many elements run as one warp each, this many
# warps (tasks) per block (em_task.cuh kWarpsPerBlock).
WARP_TEAM_ELEMENTS = 256
WARPS_PER_BLOCK = 4
# Block teams: (most elements, threads), then 1,024 threads.  Chosen from
# per-iteration times on an H100 at shapes from 20 x 11 to 348 x 61: a
# task's time per iteration falls with more threads up to about 8 to 16
# elements per thread, then rises with the cost of the block's barriers.
_BLOCK_TEAMS = ((1024, 128), (2048, 256), (12288, 512))
_RED_DOUBLES = 32  # em_task.cuh kRedDoubles
_fn = None


@dataclass
class RaggedTasks:
    """EM tasks concatenated without padding, as ``run_native_em`` lays
    them out: task i's matrix is ``probs[mat_offsets[i]:mat_offsets[i+1]]``
    row-major (n_rows[i], n_cols[i]), its counts
    ``counts[row_offsets[i]:row_offsets[i+1]]``, its output columns
    ``col_offsets[i]:col_offsets[i+1]``.  Tensors are on one device;
    ``shapes`` is the (n, 2) host array of (n_rows, n_cols) that the
    launch planner reads."""

    probs: torch.Tensor        # float64 (sum R_i * C_i,)
    counts: torch.Tensor       # float64 (sum R_i,)
    mat_offsets: torch.Tensor  # int64 (n + 1,)
    row_offsets: torch.Tensor  # int64 (n + 1,)
    col_offsets: torch.Tensor  # int64 (n + 1,)
    n_rows: torch.Tensor       # int64 (n,)
    n_cols: torch.Tensor       # int64 (n,)
    shapes: np.ndarray         # int64 (n, 2), on the host

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
            [ctypes.c_void_p] * 9
            + [ctypes.c_int64] * 5 + [ctypes.c_double]
            + [ctypes.c_void_p] * 4
        )
        _fn = fn
    return _fn


# ------------------------------------------------------------ launch plan


@dataclass(frozen=True)
class Launch:
    """One kernel launch: the tasks (indices into the caller's task list)
    that run as teams of ``threads`` threads (32: one warp per task,
    ``WARPS_PER_BLOCK`` per block), staged in shared memory or not, the
    dynamic shared memory of one block, and the CTAs of the thread-block
    cluster that runs one task (the Gibbs samplers split a large one)."""

    threads: int
    staged: bool
    tasks: np.ndarray  # int64
    smem_bytes: int
    ctas: int = 1


def team_threads(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Threads per task, from its (R, C) alone: one warp up to
    ``WARP_TEAM_ELEMENTS`` elements, then a block of 128 to 1,024
    (``_BLOCK_TEAMS``)."""
    elements = np.asarray(rows, dtype=np.int64) * np.asarray(cols, dtype=np.int64)
    threads = np.full(elements.shape, 1024, dtype=np.int64)
    for most, team in reversed(_BLOCK_TEAMS):
        threads[elements <= most] = team
    threads[elements <= WARP_TEAM_ELEMENTS] = 32
    return threads


_WIDTHS = (1, 2, 4, 8, 16, 32)
# The cost, in cycles, of one more term in a lane's serial sum and of one
# level of the shuffle butterfly, in the model that picks lanes per sum:
# fit on an H100 to the fastest layouts of main-path shapes from 14 x 16
# to 348 x 61 (a term costs about a shared-memory load's latency, a level
# a double shuffle, an add and the issue slots of the warps around it).
_TERM_CYCLES = 33
_LEVEL_CYCLES = 152


def _bank_free_stride(C: int, row_lanes: int, col_lanes: int) -> Optional[int]:
    """The least row stride >= C at which, within each half-warp (16
    doubles, one per bank pair), the E step's groups of ``row_lanes``
    lanes (one row each, consecutive columns) and the M step's groups of
    ``col_lanes`` lanes (one column each, consecutive rows) all read
    distinct banks; None where no stride serves both."""
    for S in range(max(C, 1), max(C, 1) + 32):
        if row_lanes <= 8 and S % (2 * row_lanes) != row_lanes:
            continue
        if 2 <= col_lanes <= 16 and S % (32 // col_lanes) != 16 // col_lanes:
            continue
        if col_lanes == 32 and S % 2 != 1:
            continue
        return S
    return None


def _chain_cycles(outputs: int, terms: int, lanes: int, threads: int) -> int:
    passes = -(-outputs // (threads // lanes))
    return passes * (-(-terms // lanes) * _TERM_CYCLES + (lanes.bit_length() - 1) * _LEVEL_CYCLES)


@functools.lru_cache(maxsize=None)
def _layout(R: int, C: int, threads: int) -> Tuple[int, int, int]:
    best = None
    for w in _WIDTHS:
        for h in _WIDTHS:
            S = _bank_free_stride(C, w, h)
            if S is None:
                continue
            key = (_chain_cycles(R, C, w, threads) + _chain_cycles(C, R, h, threads), w, h)
            if best is None or key < best[0]:
                best = (key, (w, h, S))
    return best[1]


def sum_layouts(rows, cols) -> np.ndarray:
    """(n, 3) int32 em_task.cuh Layout per task, from its (R, C) alone:
    lanes per row in the E step, lanes per column in the M step (the
    pair of powers of two with the shortest chain by the model among
    those with a bank-conflict-free stride), and that row stride of P in
    shared memory."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    keys, inverse = np.unique(rows * 2**32 + cols, return_inverse=True)
    R, C = keys // 2**32, keys % 2**32
    unique = np.array(
        [_layout(*key) for key in zip(R.tolist(), C.tolist(), team_threads(R, C).tolist())],
        dtype=np.int32,
    ).reshape(-1, 3)
    return unique[inverse.reshape(-1)]


def staged_doubles(rows, cols):
    """Shared memory of a task with P staged (em_task.cuh): the team's
    scratch, a, a', counts, q and P at the layout's row stride."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    stride = sum_layouts(rows, cols)[:, 2].astype(np.int64)
    return _RED_DOUBLES + 2 * cols + 2 * rows + rows * stride


def global_doubles(cols):
    """Shared memory of a task whose P, counts and q stay in global
    memory: the team's scratch, a and a'."""
    return _RED_DOUBLES + 2 * np.asarray(cols, dtype=np.int64)


def plan_launches(rows, cols, kernel: str = KERNEL_NAME, strides=None) -> List[Launch]:
    """The launches that cover every task once: one per (team size,
    staged) in order of team size, largest first.  A task's team and
    whether its P is staged depend on its (R, C) alone; a warp team is
    always staged.  Raises ValueError for a task whose a and a' do not
    fit one block's shared memory, or whose P (at its row stride in
    memory, ``strides``, by default C) has 2^31 or more elements."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    strides = cols if strides is None else np.asarray(strides, dtype=np.int64).reshape(-1)
    threads = team_threads(rows, cols)
    staged_need = staged_doubles(rows, cols)
    staged = (threads == 32) | (8 * staged_need <= SMEM_LIMIT)
    need = np.where(staged, staged_need, global_doubles(cols))
    too_big = 8 * need > SMEM_LIMIT
    if too_big.any():
        i = int(np.flatnonzero(too_big)[0])
        raise ValueError(
            f"{kernel}: a task of {rows[i]} x {cols[i]} needs {8 * int(need[i])} bytes of "
            f"shared memory (limit {SMEM_LIMIT})"
        )
    # The loop indexes its task in 32 bits.
    if (rows * np.maximum(strides, 1) >= 2**31).any():
        raise ValueError(f"{kernel}: a task spans 2^31 or more elements")
    launches = []
    for team in (1024, 512, 256, 128, 32):
        for on_chip in (True, False):
            members = np.flatnonzero((threads == team) & (staged == on_chip))
            if not members.size:
                continue
            slot = int(need[members].max())
            smem = 8 * slot * (WARPS_PER_BLOCK if team == 32 else 1)
            launches.append(Launch(team, on_chip, members, smem))
    return launches


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


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the stream: copied
    from pinned memory (the caching host allocator keeps the pinned copy
    until the transfer is done)."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)


def concat_to_device(arrays: Sequence[np.ndarray], device: torch.device) -> torch.Tensor:
    """The arrays flattened and concatenated as one float64 tensor on
    ``device`` (:func:`to_device`)."""
    flat = [np.asarray(a, dtype=np.float64).reshape(-1) for a in arrays]
    return to_device(np.concatenate(flat) if flat else np.zeros(0), device)


def offsets(sizes) -> np.ndarray:
    """(n + 1,) int64 running offsets of ``sizes``, from 0."""
    return np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).astype(np.int64)


def launch_task_ids(launches: Sequence[Launch], device: torch.device) -> torch.Tensor:
    """Every launch's task indices, concatenated in launch order, on
    ``device`` (one copy for all launches)."""
    ids = np.concatenate([launch.tasks for launch in launches]) if launches else np.empty(0)
    return to_device(ids.astype(np.int64), device)


_SIDE_STREAMS: Dict[torch.device, List[torch.cuda.Stream]] = {}


def run_launches(
    kernel: str,
    launches: Sequence[Launch],
    task_ids: torch.Tensor,
    call: Callable[[Launch, int, int], int],
) -> None:
    """Launch every planned launch with ``call(launch, task_ids pointer,
    stream)`` (which returns the C function's CUDA error code).  With
    several launches each gets a stream of its own, ordered after the work
    queued so far on the current stream, and the current stream waits for
    all of them: launches of different team sizes overlap on the card.
    Raises on the first failed launch."""
    device = task_ids.device
    current = torch.cuda.current_stream(device)
    streams = [current]
    if len(launches) > 1:
        streams = _SIDE_STREAMS.setdefault(device, [])
        while len(streams) < len(launches):
            streams.append(torch.cuda.Stream(device))
        ready = torch.cuda.Event()
        ready.record(current)
    start = 0
    with torch.cuda.device(device):
        for launch, stream in zip(launches, streams):
            if stream is not current:
                stream.wait_event(ready)
            rc = call(launch, task_ids[start:].data_ptr(), stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
            if stream is not current:
                done = torch.cuda.Event()
                done.record(stream)
                current.wait_event(done)
            start += int(launch.tasks.size)


def _launch(tasks: RaggedTasks, max_em_its: int, max_rel_em_conv: float):
    """The kernel on ``tasks``; counts its launches (one per team size)
    and tasks in the run's ``em.ragged.launches`` / ``.tasks``."""
    _check_inputs(tasks)
    device = tasks.device
    n = tasks.n_tasks
    shapes = tasks.shapes
    fracs = torch.empty(int(shapes[:, 1].sum()), dtype=torch.float64, device=device)
    iters = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return fracs, iters
    launches = plan_launches(shapes[:, 0], shapes[:, 1])
    layouts = to_device(sum_layouts(shapes[:, 0], shapes[:, 1]), device)
    unstaged = any(not launch.staged for launch in launches)
    q_scratch = torch.empty(
        int(shapes[:, 0].sum()) if unstaged else 1, dtype=torch.float64, device=device
    )

    def call(launch: Launch, ids: int, stream: int) -> int:
        return _kernel_fn()(
            tasks.probs.data_ptr(), tasks.counts.data_ptr(),
            tasks.mat_offsets.data_ptr(), tasks.row_offsets.data_ptr(),
            tasks.col_offsets.data_ptr(), tasks.n_rows.data_ptr(),
            tasks.n_cols.data_ptr(), layouts.data_ptr(), ids, int(launch.tasks.size),
            launch.threads, int(launch.staged), launch.smem_bytes,
            int(max_em_its), float(max_rel_em_conv),
            q_scratch.data_ptr(), fracs.data_ptr(), iters.data_ptr(), stream,
        )

    run_launches(KERNEL_NAME, launches, launch_task_ids(launches, device), call)
    spans.count("em.ragged.launches", len(launches))
    spans.count("em.ragged.tasks", n)
    return fracs, iters


# ------------------------------------------------------------ plain version


def em_fixed_point_plain(
    tasks: RaggedTasks,
    max_em_its: int,
    max_rel_em_conv: float,
    max_bucket_rows: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch, on the tasks' device.

    Tasks are padded into the JAX package's buckets and chunks
    (:func:`rpvg_tpu_torch.infer.batching.plan_chunks`) and solved by
    the batched fixed point of :mod:`rpvg_tpu_torch.infer.em`.  Padded
    rows carry zero counts,
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

    # Imported here: batching imports this module.
    from rpvg_tpu_torch.infer.batching import plan_chunks

    shapes = list(zip(n_rows.tolist(), n_cols.tolist()))
    for members, R_pad, C_pad in plan_chunks(shapes, range(n), max_bucket_rows):
        idx = np.asarray(members, dtype=np.int64)
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
