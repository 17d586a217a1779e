"""`.rpa` — rpvg_tpu's binary alignment container.

The on-disk production input format (the GAMP analogue): fragment
blocks in exactly the native projection engine's batch serialization, so
the reader hands payloads straight to the C++ kernels with zero Python
object construction.  Convert protobuf-JSON alignments once with
:func:`convert_json` (the `vg view` analogue).

Layout (little-endian):
  magic   8 bytes  b"RPATPU01"
  u8      is_multipath
  u8      is_paired
  f64     frag_mean   (0 when absent)
  f64     frag_sd     (0 when absent)
  blocks: i64 payload_length, payload bytes   (until EOF)
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Sequence, Tuple

MAGIC = b"RPATPU01"
DEFAULT_BLOCK_FRAGMENTS = 10000


class RpaWriter:
    def __init__(
        self,
        path: str,
        is_multipath: bool,
        is_paired: bool,
        frag_mean: float = 0.0,
        frag_sd: float = 0.0,
    ):
        self.handle = open(path, "wb")
        self.handle.write(MAGIC)
        self.handle.write(
            struct.pack("<BBdd", int(is_multipath), int(is_paired), frag_mean, frag_sd)
        )

    def write_block(self, payload: bytes) -> None:
        self.handle.write(struct.pack("<q", len(payload)))
        self.handle.write(payload)

    def close(self) -> None:
        self.handle.close()


class RpaReader:
    def __init__(self, path: str):
        self.handle = open(path, "rb")
        magic = self.handle.read(8)
        assert magic == MAGIC, f"not an rpa file: {path}"
        self.is_multipath, self.is_paired, self.frag_mean, self.frag_sd = struct.unpack(
            "<BBdd", self.handle.read(18)
        )
        self.is_multipath = bool(self.is_multipath)
        self.is_paired = bool(self.is_paired)

    def blocks(self) -> Iterator[bytes]:
        while True:
            header = self.handle.read(8)
            if not header:
                return
            # A partial header or short payload is a truncated
            # container: fail loudly, never yield a garbled block
            # (fuzz-pinned by tests/test_fuzz_loaders.py).  Real raises
            # rather than asserts so the guarantee survives python -O.
            if len(header) != 8:
                raise ValueError("truncated rpa block header")
            (length,) = struct.unpack("<q", header)
            if length < 0:
                raise ValueError("corrupt rpa block length")
            payload = self.handle.read(length)
            if len(payload) != length:
                raise ValueError("truncated rpa block")
            yield payload

    def close(self) -> None:
        self.handle.close()


def write_fragments(
    path: str,
    fragments: Sequence,
    is_multipath: bool,
    is_paired: bool,
    frag_mean: float = 0.0,
    frag_sd: float = 0.0,
    block_size: int = DEFAULT_BLOCK_FRAGMENTS,
) -> None:
    """Write parsed Alignment/MultipathAlignment fragments (or mate
    tuples) to an rpa file."""
    from ..native import serialize_fragments

    writer = RpaWriter(path, is_multipath, is_paired, frag_mean, frag_sd)
    batch: List = []
    for fragment in fragments:
        batch.append(fragment)
        if len(batch) == block_size:
            writer.write_block(serialize_fragments(batch))
            batch = []
    if batch:
        writer.write_block(serialize_fragments(batch))
    writer.close()


def convert_json(
    json_path: str, rpa_path: str, is_multipath: bool, is_paired: bool
) -> None:
    """Convert protobuf-JSON lines to rpa (scans the stream for embedded
    fragment-length parameters and records them in the header)."""
    from ..fragments import FragmentLengthDist
    from . import json_stream

    frag_mean = frag_sd = 0.0
    for obj in json_stream.stream_alignment_dicts(json_path):
        from ..alignments import _parse_annotation

        record = dict(obj)
        if "annotation" in record:
            record["annotation"] = _parse_annotation(record["annotation"])
        parsed = FragmentLengthDist.parse_alignment(record)
        if parsed is not None:
            frag_mean, frag_sd = parsed
            break

    if is_paired:
        fragments = json_stream.stream_alignment_pairs(json_path, is_multipath)
    else:
        fragments = json_stream.stream_alignments(json_path, is_multipath)
    write_fragments(
        rpa_path, list(fragments), is_multipath, is_paired, frag_mean, frag_sd
    )
