"""The least time the group scorer (``csrc/group_scores.cu``: its
pre-pass ``prepare_kernel`` and its ``score_kernel``) could take on one
NVIDIA H100 for a call's work, from the work's logical shapes: the
program's counters ``groups.rows`` (sum of R), ``groups.cells`` (R P)
and ``groups.groups`` (G), summed over the clusters it scored.

The larger of two floors, each one that any implementation pays:

* bytes: every probability, noise and count read once in float64
  (8 (R P + 2 R)) and every score written once in float64 (8 G), at the
  HBM rate;
* operations: one float64 log per probability (R P of them), at the 14
  FP64 instructions of the scorer's own log (``csrc/log_f64.cuh``), each
  counted as one operation at the FP64 rate without tensor cores.

A kernel that factors its sums computes fewer than R G logs, but none
computes fewer than one a probability, so the share of this bound cannot
pass 100 %.  The groups' paths are not charged: a group is a multiset of
its cluster's columns, which a kernel may enumerate rather than read,
and the scorer reads one table per distinct (P, k), shared by every
cluster of that width.  ``chip_smoke.group_scores_bound`` counts the
same bytes plus that layout (the tables and its seven offset words a
cluster) and, by default, R G logs; the layout is the kernel's choice,
and R G logs overcount a factored kernel, so neither is counted here."""

from __future__ import annotations

from typing import Tuple

from bench_port.bounds import HBM_BYTES_PER_S

FP64_FLOPS_NO_TENSOR = 34e12
LOG_FP64_INSTRUCTIONS = 14


def group_scores_bytes(rows: int, cells: int, groups: int) -> float:
    """Bytes read and written once: probabilities, noise and counts in,
    the scores out."""
    return 8.0 * (cells + 2 * rows) + 8.0 * groups


def group_scores_bound(rows: int, cells: int, groups: int) -> Tuple[float, str]:
    """(bound in seconds, what bounds it) of one call's group scores."""
    bytes_s = group_scores_bytes(rows, cells, groups) / HBM_BYTES_PER_S
    ops_s = float(cells) * LOG_FP64_INSTRUCTIONS / FP64_FLOPS_NO_TENSOR
    return max(bytes_s, ops_s), "bytes" if bytes_s >= ops_s else "operations"
