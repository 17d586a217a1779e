"""The ``.rpa`` container writer and the fragment serialization it
stores, copied from ``rpvg_tpu_torch/io/rpa.py`` (``RpaWriter``,
``write_fragments``) and ``rpvg_tpu_torch/native.py``
(``serialize_fragments`` and its helpers).

Layout (little-endian): magic ``RPATPU01``, u8 is_multipath, u8
is_paired, f64 frag_mean, f64 frag_sd, then blocks of (i64 payload
length, payload) until EOF.  A payload is ``serialize_fragments`` of up
to ``DEFAULT_BLOCK_FRAGMENTS`` fragments.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

from .alignments import MultipathAlignment

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


def serialize_fragments(fragments: Sequence) -> bytes:
    """Serialize fragments into the native batch format (also the .rpa
    on-disk block payload)."""
    s = _Serializer()
    s.put("<i", len(fragments))
    for fragment in fragments:
        paired = isinstance(fragment, tuple)
        first = fragment[0] if paired else fragment
        multipath = isinstance(first, MultipathAlignment)
        kind = (1 if multipath else 0) | (2 if paired else 0)
        s.put("<B", kind)
        if paired:
            _serialize_alignment(s, fragment[0])
            _serialize_alignment(s, fragment[1])
        else:
            _serialize_alignment(s, first)
    return s.buffer()


class _Serializer:
    def __init__(self):
        self.parts: List[bytes] = []

    def put(self, fmt: str, *values):
        self.parts.append(struct.pack(fmt, *values))

    def raw(self, data: bytes):
        self.parts.append(data)

    def buffer(self) -> bytes:
        return b"".join(self.parts)


def _serialize_path(s: _Serializer, path) -> None:
    # An absent path (unaligned record, or a multipath record read in
    # --single-path mode) serializes as zero mappings — the projection
    # kernel finds nothing and the fragment counts as unaligned/noise,
    # matching the Python finder's has_path() handling.
    mappings = path.mappings if path is not None else ()
    s.put("<i", len(mappings))
    for m in mappings:
        first_edit = m.edits[0]
        last_edit = m.edits[-1]
        s.put(
            "<qiiiiiii",
            m.gbwt_node(),
            m.offset,
            m.to_length(),
            m.from_length(),
            first_edit.from_length,
            first_edit.to_length,
            last_edit.from_length,
            last_edit.to_length,
        )


def _serialize_alignment(s: _Serializer, aln) -> None:
    is_multipath = isinstance(aln, MultipathAlignment)
    allelic_mapq = int(aln.annotation.get("allelic_mapq", -1))
    s.put("<iiiBB", len(aln.sequence), aln.mapping_quality, allelic_mapq,
          int("disconnected" in aln.annotation), int(bool(aln.quality)))
    if aln.quality:
        s.raw(bytes(aln.quality))
    if not is_multipath:
        s.put("<i", aln.score)
        _serialize_path(s, aln.path)
    else:
        s.put("<ii", len(aln.subpaths), len(aln.start))
        for start in aln.start:
            s.put("<i", start)
        for sp in aln.subpaths:
            s.put("<iii", sp.score, len(sp.connections), len(sp.next))
            for nxt in sp.next:
                s.put("<i", nxt)
            _serialize_path(s, sp.path)
