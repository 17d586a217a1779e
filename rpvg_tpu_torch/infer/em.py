"""Batched EM fixed point in plain PyTorch (counterpart of
``rpvg_tpu/infer/em.py``).

This is the plain version of the CUDA kernels ``csrc/em_fixed_point.cu``
and ``csrc/em_fused.cu``: the same q-formulation, the same per-cluster
freeze after ``MIN_EM_CONV_ITS`` converged iterations and the same 1e-8
activity gate, over a padded (B, R, C) stack.  CPU tensors run through it on the main
path; on the card it is the specification the kernels are compared with.

Convergence contract (reference path_abundance_estimator.cpp:47-114):
every unmasked abundance >= 1e-8 must move relatively by at most
``max_rel_em_conv`` for 10 consecutive iterations.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rpvg_tpu_torch.constants import MIN_EM_ABUNDANCE, MIN_EM_CONV_ITS

# Iterations run between two host reads of the convergence state.  A
# cluster that has converged is frozen, so iterations past the last
# cluster's convergence change nothing; the check only bounds how many
# such no-op iterations run.
_CHECK_EVERY = 16


def _masked_em_step(probs, counts, abundances, total_count, col_mask):
    """One EM iteration for a padded batch.

    q-formulation: new_c = a_c * (sum_r counts_r / rowsum_r * P_rc) /
    max(total, 1).  Each cluster's sums run in an order that does not
    depend on the batch it is in (a batched matvec with the vector on
    the right does on the CPU), so a cluster's result is the same however
    the clusters are batched or sharded."""
    a = abundances * col_mask
    row_sums = (probs * a.unsqueeze(1)).sum(dim=-1)
    positive = row_sums > 0
    q = torch.where(positive, counts / torch.where(positive, row_sums, 1.0), 0.0)
    t = torch.bmm(q.unsqueeze(1), probs).squeeze(1)
    return a * t / torch.clamp(total_count, min=1.0).unsqueeze(-1)


def _em_solve_batched(
    probs: torch.Tensor,
    counts: torch.Tensor,
    col_masks: torch.Tensor,
    max_em_its: int,
    max_rel_em_conv: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probs (B, R, C), counts (B, R), col_masks (B, C), all float64 on
    one device.  Padded rows must have zero counts; padded columns zero
    mask.

    Returns (abundance fractions (B, C), converged-iteration counters
    (B,), iterations each cluster ran (B,)).  The iteration count of a
    cluster stops growing once it is frozen, so its maximum equals the
    JAX loop's batch iteration count."""
    B = probs.shape[0]
    device = probs.device
    totals = counts.sum(dim=1)
    n_cols = col_masks.sum(dim=1)
    init = torch.where(
        col_masks > 0, (1.0 / torch.clamp(n_cols, min=1.0)).unsqueeze(-1), 0.0
    )
    abundances = init
    conv_its = torch.zeros(B, dtype=torch.int32, device=device)
    iterations = torch.zeros(B, dtype=torch.int64, device=device)
    mask_on = col_masks > 0
    it = 0
    while it < max_em_its and B:
        for _ in range(min(_CHECK_EVERY, max_em_its - it)):
            already_done = conv_its >= MIN_EM_CONV_ITS
            new = _masked_em_step(probs, counts, abundances, totals, col_masks)
            new = torch.where(already_done.unsqueeze(-1), abundances, new)
            active = (new >= MIN_EM_ABUNDANCE) & mask_on
            rel_diff = torch.where(
                active,
                (new - abundances).abs() / torch.where(active, new, 1.0),
                0.0,
            )
            has_converged = (rel_diff <= max_rel_em_conv).all(dim=1)
            conv_its = torch.where(
                already_done,
                conv_its,
                torch.where(has_converged, conv_its + 1, 0).to(torch.int32),
            )
            iterations += (~already_done).to(torch.int64)
            abundances = new
            it += 1
        if not bool((conv_its < MIN_EM_CONV_ITS).any()):
            break
    return abundances, conv_its, iterations
