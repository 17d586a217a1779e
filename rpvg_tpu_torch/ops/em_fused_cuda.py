"""EM fixed point over several padded shape buckets in one launch: the
CUDA kernel ``csrc/em_fused.cu`` and its plain PyTorch version.

Counterpart of ``rpvg_tpu/ops/em_pallas.py`` (``_em_fused_kernel``,
public ``em_pallas_fused``).  A block is one padded bucket ``(probs
(B, R, C), counts (B, R), col_masks (B, C))`` in float64, as
:func:`rpvg_tpu_torch.infer.batching.build_block` makes it: padded rows
carry zero counts and zero probabilities, padded columns a zero mask and
zero probabilities, masks are 0 or 1.

:func:`em_fixed_point_padded` dispatches on the device of the blocks: a
CUDA tensor launches the kernel once for all blocks (or raises), a CPU
tensor runs :func:`em_fixed_point_padded_plain`.  Each cluster's
extent is found on the device and planned like a ragged task
(:func:`rpvg_tpu_torch.ops.em_cuda.plan_launches`), so it runs as the
same team in the same order as in the ragged kernel.  The plain version
accepts tensors on any device, so the kernel can be held against it on
the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from rpvg_tpu_torch.infer.em import _em_solve_batched
from rpvg_tpu_torch import spans
from rpvg_tpu_torch.ops import build
from rpvg_tpu_torch.ops.em_cuda import (
    launch_task_ids,
    plan_launches,
    run_launches,
    sum_layouts,
    to_device,
)

KERNEL_NAME = "em_fused"
_fn = None

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def em_fixed_point_padded(
    blocks: Sequence[Block], max_em_its: int, max_rel_em_conv: float, extents=None
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(per block (B, C) fractions, per block (B,) iterations), on the
    blocks' device.  CUDA tensors go to the kernel in one launch, CPU
    tensors to the plain version.  ``extents``: :func:`cluster_extents`
    of the blocks, computed on their host copies where the caller has
    them; the call then reads nothing back from the card and returns
    while the kernel runs."""
    if not blocks:
        return [], []
    device = blocks[0][0].device
    if device.type == "cpu":
        return em_fixed_point_padded_plain(blocks, max_em_its, max_rel_em_conv)
    if device.type != "cuda":
        raise ValueError(f"em_fixed_point_padded: unsupported device {device}")
    return _launch(blocks, max_em_its, max_rel_em_conv, extents)


def em_fixed_point_padded_plain(
    blocks: Sequence[Block], max_em_its: int, max_rel_em_conv: float
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The kernel's contract in plain PyTorch: one batched fixed point
    (:func:`rpvg_tpu_torch.infer.em._em_solve_batched`) per block."""
    fracs, iters = [], []
    for probs, counts, col_masks in blocks:
        block_fracs, _, block_iters = _em_solve_batched(
            probs, counts, col_masks, max_em_its, max_rel_em_conv
        )
        fracs.append(block_fracs)
        iters.append(block_iters)
    return fracs, iters


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library(KERNEL_NAME).rpvg_em_fused_f64
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
            + [ctypes.c_int64] * 5 + [ctypes.c_double]
            + [ctypes.c_void_p] * 4
        )
        _fn = fn
    return _fn


def _check_blocks(blocks: Sequence[Block], device: torch.device) -> None:
    for k, (probs, counts, col_masks) in enumerate(blocks):
        for name, t, ndim in (("probs", probs, 3), ("counts", counts, 2), ("col_masks", col_masks, 2)):
            if (
                t.dtype != torch.float64 or t.dim() != ndim
                or not t.is_contiguous() or t.device != device
            ):
                raise ValueError(
                    f"em_fixed_point_padded: block {k} {name} must be a contiguous "
                    f"{ndim}-d float64 tensor on {device}"
                )
        B, R, C = probs.shape
        if counts.shape != (B, R) or col_masks.shape != (B, C):
            raise ValueError(
                f"em_fixed_point_padded: block {k} shapes {tuple(probs.shape)}, "
                f"{tuple(counts.shape)}, {tuple(col_masks.shape)} do not agree"
            )


def cluster_extents(blocks) -> np.ndarray:
    """(n_clusters, 2) host array of each padded cluster's extent, as the
    kernel finds it: rows up to the last nonzero count, columns up to the
    last column with a positive mask.  ``blocks`` are (probs, counts,
    col_masks) as numpy arrays or tensors; a CUDA block's counts and
    masks are read back from the card."""
    def last(on):
        return np.where(on.any(axis=1), on.shape[1] - np.argmax(on[:, ::-1], axis=1), 0)

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    extents = [np.stack([last(host(c) != 0), last(host(m) > 0)], axis=1) for _, c, m in blocks]
    return np.concatenate(extents).astype(np.int64).reshape(-1, 2)


def _launch(blocks: Sequence[Block], max_em_its: int, max_rel_em_conv: float, extents=None):
    """The kernel on ``blocks``; counts its launches (one per team size),
    padded clusters and blocks in the run's ``em.padded.launches`` /
    ``.tasks`` / ``.blocks``."""
    device = blocks[0][0].device
    _check_blocks(blocks, device)
    shapes = np.array([p.shape for p, _, _ in blocks], dtype=np.int64).reshape(-1, 3)
    B, R, C = shapes[:, 0], shapes[:, 1], shapes[:, 2]
    starts = lambda sizes: np.concatenate([[0], np.cumsum(sizes)])  # noqa: E731
    prob_off, count_off, col_off, cluster_off = (
        starts(B * R * C), starts(B * R), starts(B * C), starts(B)
    )
    n_clusters = int(cluster_off[-1])
    if n_clusters >= 2**31:
        raise ValueError("em_fixed_point_padded: more clusters than one grid can hold")
    desc = np.stack([prob_off[:-1], count_off[:-1], col_off[:-1], R, C], axis=1)

    probs = torch.cat([p.reshape(-1) for p, _, _ in blocks])
    counts = torch.cat([c.reshape(-1) for _, c, _ in blocks])
    col_masks = torch.cat([m.reshape(-1) for _, _, m in blocks])
    desc_t = to_device(desc, device)
    cluster_off_t = to_device(cluster_off, device)
    fracs = torch.empty(int(col_off[-1]), dtype=torch.float64, device=device)
    iters = torch.empty(n_clusters, dtype=torch.int64, device=device)
    if n_clusters:
        if extents is None:
            extents = cluster_extents(blocks)
        extents = np.asarray(extents, dtype=np.int64).reshape(n_clusters, 2)
        launches = plan_launches(
            extents[:, 0], extents[:, 1], KERNEL_NAME, strides=np.repeat(C, B)
        )
        layouts = to_device(sum_layouts(extents[:, 0], extents[:, 1]), device)
        unstaged = any(not launch.staged for launch in launches)
        q_scratch = torch.empty(
            counts.numel() if unstaged else 1, dtype=torch.float64, device=device
        )

        def call(launch, ids, stream):
            return _kernel_fn()(
                probs.data_ptr(), counts.data_ptr(), col_masks.data_ptr(),
                desc_t.data_ptr(), cluster_off_t.data_ptr(), len(blocks), layouts.data_ptr(),
                ids, int(launch.tasks.size), launch.threads, int(launch.staged),
                launch.smem_bytes, int(max_em_its), float(max_rel_em_conv),
                q_scratch.data_ptr(), fracs.data_ptr(), iters.data_ptr(), stream,
            )

        run_launches(KERNEL_NAME, launches, launch_task_ids(launches, device), call)
        spans.count("em.padded.launches", len(launches))
        spans.count("em.padded.tasks", n_clusters)
        spans.count("em.padded.blocks", len(blocks))
    return (
        [fracs[col_off[k] : col_off[k + 1]].view(int(B[k]), int(C[k])) for k in range(len(blocks))],
        [iters[cluster_off[k] : cluster_off[k + 1]] for k in range(len(blocks))],
    )
