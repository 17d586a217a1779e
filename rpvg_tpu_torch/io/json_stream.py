"""Alignment streaming from JSON-lines files (one protobuf-JSON
alignment per line, optionally gzipped) — the text twin of vg's GAM/GAMP
streams (`vg view -a` output)."""

from __future__ import annotations

import gzip
import json
from typing import Iterator, Tuple, Union

from ..alignments import (
    Alignment,
    MultipathAlignment,
    parse_alignment,
    parse_multipath_alignment,
)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def stream_alignments(path: str, is_multipath: bool) -> Iterator:
    parse = parse_multipath_alignment if is_multipath else parse_alignment
    with _open(path) as handle:
        for line in handle:
            line = line.strip()
            if line:
                yield parse(json.loads(line))


def stream_alignment_pairs(path: str, is_multipath: bool) -> Iterator[Tuple]:
    """Interleaved pairs: consecutive records are mates."""
    it = stream_alignments(path, is_multipath)
    while True:
        try:
            first = next(it)
        except StopIteration:
            return
        second = next(it)  # interleaved files must have even length
        yield first, second


def stream_alignment_dicts(path: str) -> Iterator[dict]:
    with _open(path) as handle:
        for line in handle:
            line = line.strip()
            if line:
                yield json.loads(line)
