"""Peaks of one NVIDIA H100 (SXM, 700 W; NVIDIA's data sheet, dense
rates) and the least time a kernel launch could take on it.

``em_bound`` is ``chip_smoke.em_bound``: each input byte read once and
each output byte written once at the HBM rate, against 4 R C flops per
iteration (E and M step) at the FP64 peak, for the iterations these
inputs need under the EM's own stopping rule."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 67e12


def em_bound(in_bytes: float, out_bytes: float, iterations, rows, cols) -> Tuple[float, str]:
    """(bound in seconds, what bounds it) of one EM launch."""
    flops = 4.0 * float(np.sum(np.asarray(iterations, dtype=np.float64)
                               * np.asarray(rows, dtype=np.float64)
                               * np.asarray(cols, dtype=np.float64)))
    bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    flops_s = flops / FP64_FLOPS
    return max(bytes_s, flops_s), "bytes" if bytes_s >= flops_s else "operations"


def ragged_em_bound(shapes: Sequence[Tuple[int, int]], iterations) -> Tuple[float, str]:
    """em_bound of the ragged EM kernel over tasks of (rows, cols):
    the matrices, counts, three offset arrays and two size arrays in,
    the fractions and iterations out, in float64 and int64."""
    shapes = np.asarray(shapes, dtype=np.int64).reshape(-1, 2)
    n = shapes.shape[0]
    rows, cols = shapes[:, 0], shapes[:, 1]
    in_bytes = 8 * (int((rows * cols).sum()) + int(rows.sum()) + 3 * (n + 1) + 2 * n)
    out_bytes = 8 * (int(cols.sum()) + n)
    return em_bound(in_bytes, out_bytes, iterations, rows, cols)
