"""Numeric comparison of two estimate files (``.txt`` / ``_joint.txt``).

Byte-level equality is too strict across devices: a last-ulp difference
can change a ``%.8g`` digit.  Two files agree when their headers, row
order and text columns (``Name*``, ``ClusterID``) are identical and every
other column agrees within ``atol + rtol * |reference|``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


class OutputMismatch(AssertionError):
    """Two estimate files disagree beyond the stated tolerance."""


def _read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    with open(path) as handle:
        lines = handle.read().splitlines()
    if not lines:
        raise OutputMismatch(f"{path} is empty")
    return lines[0].split("\t"), [line.split("\t") for line in lines[1:]]


def _is_text_column(name: str) -> bool:
    return name.startswith("Name") or name == "ClusterID"


def compare_estimate_files(path: str, reference: str, rtol: float, atol: float) -> Dict:
    """Compare ``path`` against ``reference``; raises OutputMismatch on
    any difference beyond tolerance.  Returns a report: rows, the largest
    absolute and relative numeric difference, and byte identity."""
    header, rows = _read_table(path)
    ref_header, ref_rows = _read_table(reference)
    if header != ref_header:
        raise OutputMismatch(f"headers differ: {header} vs {ref_header}")
    if len(rows) != len(ref_rows):
        raise OutputMismatch(f"row counts differ: {len(rows)} vs {len(ref_rows)}")
    text_cols = [i for i, name in enumerate(header) if _is_text_column(name)]
    max_abs = 0.0
    max_rel = 0.0
    for line_no, (row, ref_row) in enumerate(zip(rows, ref_rows), start=2):
        if len(row) != len(header) or len(ref_row) != len(header):
            raise OutputMismatch(f"line {line_no}: wrong number of fields")
        for i in text_cols:
            if row[i] != ref_row[i]:
                raise OutputMismatch(
                    f"line {line_no}: {header[i]} {row[i]!r} vs {ref_row[i]!r}"
                )
        for i, name in enumerate(header):
            if i in text_cols:
                continue
            value, ref_value = float(row[i]), float(ref_row[i])
            if not (math.isfinite(value) and math.isfinite(ref_value)):
                raise OutputMismatch(f"line {line_no}: {name} not finite ({row[i]}, {ref_row[i]})")
            diff = abs(value - ref_value)
            max_abs = max(max_abs, diff)
            if ref_value != 0.0:
                max_rel = max(max_rel, diff / abs(ref_value))
            if diff > atol + rtol * abs(ref_value):
                raise OutputMismatch(
                    f"line {line_no}: {name} {row[i]} vs {ref_row[i]} "
                    f"(|diff| {diff:.3g} > {atol} + {rtol} * |ref|)"
                )
    with open(path, "rb") as a, open(reference, "rb") as b:
        identical = a.read() == b.read()
    return {
        "rows": len(rows),
        "max_abs_diff": max_abs,
        "max_rel_diff": max_rel,
        "byte_identical": identical,
    }


def check_estimate_file(path: str) -> int:
    """Rows of a well-formed estimate file whose numeric fields are all
    finite; raises OutputMismatch otherwise."""
    header, rows = _read_table(path)
    if not rows:
        raise OutputMismatch(f"{path} has no rows")
    for line_no, row in enumerate(rows, start=2):
        if len(row) != len(header):
            raise OutputMismatch(f"{path} line {line_no}: wrong number of fields")
        for name, field in zip(header, row):
            if not _is_text_column(name) and not math.isfinite(float(field)):
                raise OutputMismatch(f"{path} line {line_no}: {name} = {field}")
    return len(rows)
