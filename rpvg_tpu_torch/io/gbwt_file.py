"""gbwt::GBWT container reader/writer (sdsl stream layout).

The reference loads its haplotype/transcript panel as a serialized
gbwt::GBWT (``-p pantranscriptome.gbwt``, reference/src/main.cpp:616-629)
and resolves path names through its metadata
(reference/src/paths_index.cpp:146-170).  This module reads that
container directly — no conversion step — and converts it into the
framework's PathIndex, plus writes the same layout for fixtures (the
snapshot strips every binary index and the gbwt submodule is a stub, so
layout fidelity is validated by round-trip; each structure fails loudly
on mismatch).

Container layout (GBWT file format version 5):

    GBWTHeader   48 bytes: tag u32 = 0x6B376B37, version u32,
                 sequences u64, size u64, offset u64, alphabet_size u64,
                 flags u64 (bit 0 bidirectional, bit 1 metadata).
    Tags         StringArray of 2n strings (key, value, ...);
                 StringArray = int_vector<0> offsets + int_vector<8> data.
    BWT          RecordArray: records u64, sd_vector index (record start
                 offsets into the byte blob), byte blob (u64 count + raw).
    DASamples    sampled_records bit_vector, bwt_ranges sd_vector,
                 sampled_offsets sd_vector, array int_vector<0>.
    Metadata     (when flagged) MetadataHeader 48 bytes: tag u32 =
                 0x6B375E7A, version u32 = 2, sample_count u64,
                 haplotype_count u64, contig_count u64, path_count u64,
                 flags u64 (1 path names, 2 sample names, 4 contig
                 names); then PathName[] (u64 count + 4xu32 each),
                 sample Dictionary, contig Dictionary.
    Dictionary   int_vector<0> offsets (n+1), int_vector<8> data,
                 int_vector<0> sorted_ids.

Record encoding (per node, GBWT wire format):

    outdegree    ByteCode (LEB128).
    edges        outdegree x (successor delta ByteCode — first raw,
                 then (succ - prev - 1) — and incoming-offset ByteCode).
    body         runs of outgoing-edge ranks: with outdegree sigma and
                 run_continues = max(0, 256 // sigma - 1) > 0, a run of
                 rank c length l is byte c + sigma*(l-1) when
                 l - 1 < run_continues, else byte c + sigma*run_continues
                 followed by ByteCode(l - run_continues - 1); when
                 run_continues == 0 (large sigma), ByteCode(c) then
                 ByteCode(l - 1).

GBWT node space follows vg: node = node_id * 2 + is_reverse for
bidirectional indexes, node_id for unidirectional; 0 is the endmarker.
Sequence extraction walks LF from the endmarker record, so document
array samples are not required (DASamples may be empty); locate() in
this framework always runs over its own occurrence arrays.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import sdsl

GBWT_TAG = 0x6B376B37
GBWT_VERSION = 5
FLAG_BIDIRECTIONAL = 0x0001
FLAG_METADATA = 0x0002

METADATA_TAG = 0x6B375E7A
METADATA_VERSION = 2
META_FLAG_PATH_NAMES = 0x0001
META_FLAG_SAMPLE_NAMES = 0x0002
META_FLAG_CONTIG_NAMES = 0x0004

ENDMARKER = 0


# ------------------------------------------------------------- ByteCode


def write_byte_code(buf: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            buf.append(bits | 0x80)
        else:
            buf.append(bits)
            return


def read_byte_code(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    shift = 0
    while True:
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not (byte & 0x80):
            return value, pos
        shift += 7


# --------------------------------------------------------------- records


@dataclass
class GBWTRecord:
    """One node's compressed record: outgoing edges (successor node,
    incoming offset in successor) and the BWT body as (edge_rank, run
    length) runs."""

    edges: List[Tuple[int, int]] = field(default_factory=list)
    runs: List[Tuple[int, int]] = field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        sigma = len(self.edges)
        write_byte_code(buf, sigma)
        prev = 0
        for i, (succ, offset) in enumerate(self.edges):
            write_byte_code(buf, succ if i == 0 else succ - prev - 1)
            write_byte_code(buf, offset)
            prev = succ
        run_continues = max(0, 256 // sigma - 1) if sigma else 0
        for rank, length in self.runs:
            if run_continues == 0:
                write_byte_code(buf, rank)
                write_byte_code(buf, length - 1)
            elif length - 1 < run_continues:
                buf.append(rank + sigma * (length - 1))
            else:
                buf.append(rank + sigma * run_continues)
                write_byte_code(buf, length - run_continues - 1)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "GBWTRecord":
        pos = 0
        sigma, pos = read_byte_code(data, pos)
        edges: List[Tuple[int, int]] = []
        prev = 0
        for i in range(sigma):
            delta, pos = read_byte_code(data, pos)
            succ = delta if i == 0 else prev + delta + 1
            offset, pos = read_byte_code(data, pos)
            edges.append((succ, offset))
            prev = succ
        runs: List[Tuple[int, int]] = []
        run_continues = max(0, 256 // sigma - 1) if sigma else 0
        while pos < len(data):
            if run_continues == 0:
                rank, pos = read_byte_code(data, pos)
                ext, pos = read_byte_code(data, pos)
                runs.append((rank, ext + 1))
            else:
                byte = data[pos]
                pos += 1
                rank = byte % sigma
                length = byte // sigma + 1
                if length - 1 == run_continues:
                    ext, pos = read_byte_code(data, pos)
                    length += ext
                runs.append((rank, length))
        return cls(edges=edges, runs=runs)

    def body(self) -> np.ndarray:
        """Expanded BWT body: the outgoing edge rank of each position."""
        if not self.runs:
            return np.zeros(0, dtype=np.int64)
        ranks = np.array([r for r, _ in self.runs], dtype=np.int64)
        lengths = np.array([l for _, l in self.runs], dtype=np.int64)
        return np.repeat(ranks, lengths)


# --------------------------------------------------------------- metadata


@dataclass
class GBWTMetadata:
    sample_names: List[str] = field(default_factory=list)
    contig_names: List[str] = field(default_factory=list)
    # Each path name: (sample id, contig id, phase, count).
    path_names: List[Tuple[int, int, int, int]] = field(default_factory=list)
    haplotype_count: int = 0

    def path_name_string(self, path_id: int) -> str:
        """Reference path-name formatting
        (reference/src/paths_index.cpp:146-170): `sample` or
        `sample_contig_phase_count`."""
        if path_id >= len(self.path_names) or not self.sample_names:
            return str(path_id + 1)
        sample, contig, phase, count = self.path_names[path_id]
        name = self.sample_names[sample]
        if self.contig_names:
            name += f"_{self.contig_names[contig]}_{phase}_{count}"
        return name


def _write_dictionary(out: BinaryIO, names: Sequence[str]) -> None:
    blobs = [name.encode() for name in names]
    offsets = np.zeros(len(blobs) + 1, dtype=np.uint64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    sdsl.write_int_vector(out, offsets)
    sdsl.write_byte_vector(out, b"".join(blobs))
    order = sorted(range(len(names)), key=lambda i: names[i])
    sdsl.write_int_vector(out, np.asarray(order, dtype=np.uint64))


def _read_dictionary(handle: BinaryIO) -> List[str]:
    offsets = sdsl.read_int_vector(handle)
    data = sdsl.read_byte_vector(handle)
    sdsl.read_int_vector(handle)  # sorted ids (rebuilt on demand)
    return [
        data[int(offsets[i]) : int(offsets[i + 1])].decode()
        for i in range(len(offsets) - 1)
    ]


def _write_metadata(out: BinaryIO, meta: GBWTMetadata) -> None:
    flags = 0
    if meta.path_names:
        flags |= META_FLAG_PATH_NAMES
    if meta.sample_names:
        flags |= META_FLAG_SAMPLE_NAMES
    if meta.contig_names:
        flags |= META_FLAG_CONTIG_NAMES
    sdsl.write_u32(out, METADATA_TAG)
    sdsl.write_u32(out, METADATA_VERSION)
    sdsl.write_u64(out, len(meta.sample_names))
    sdsl.write_u64(out, meta.haplotype_count or len(meta.sample_names))
    sdsl.write_u64(out, len(meta.contig_names))
    sdsl.write_u64(out, len(meta.path_names))
    sdsl.write_u64(out, flags)
    if meta.path_names:
        sdsl.write_u64(out, len(meta.path_names))
        for sample, contig, phase, count in meta.path_names:
            sdsl.write_u32(out, sample)
            sdsl.write_u32(out, contig)
            sdsl.write_u32(out, phase)
            sdsl.write_u32(out, count)
    if meta.sample_names:
        _write_dictionary(out, meta.sample_names)
    if meta.contig_names:
        _write_dictionary(out, meta.contig_names)


def _read_metadata(handle: BinaryIO) -> GBWTMetadata:
    tag = sdsl.read_u32(handle)
    if tag != METADATA_TAG:
        raise ValueError(f"GBWT metadata: bad tag 0x{tag:08X}")
    version = sdsl.read_u32(handle)
    if version > METADATA_VERSION:
        raise ValueError(f"GBWT metadata: unsupported version {version}")
    sdsl.read_u64(handle)  # sample_count (implied by dictionary)
    haplotype_count = sdsl.read_u64(handle)
    sdsl.read_u64(handle)  # contig_count
    path_count = sdsl.read_u64(handle)
    flags = sdsl.read_u64(handle)
    meta = GBWTMetadata(haplotype_count=haplotype_count)
    if flags & META_FLAG_PATH_NAMES:
        count = sdsl.read_u64(handle)
        if count != path_count:
            raise ValueError(
                f"GBWT metadata: {count} path names for {path_count} paths"
            )
        for _ in range(count):
            meta.path_names.append(
                (
                    sdsl.read_u32(handle),
                    sdsl.read_u32(handle),
                    sdsl.read_u32(handle),
                    sdsl.read_u32(handle),
                )
            )
    if flags & META_FLAG_SAMPLE_NAMES:
        meta.sample_names = _read_dictionary(handle)
    if flags & META_FLAG_CONTIG_NAMES:
        meta.contig_names = _read_dictionary(handle)
    return meta


# ------------------------------------------------------------- container


@dataclass
class GBWTFile:
    """In-memory view of a serialized gbwt::GBWT."""

    sequences: int = 0
    size: int = 0
    offset: int = 0
    alphabet_size: int = 0
    bidirectional: bool = False
    records: Dict[int, GBWTRecord] = field(default_factory=dict)  # comp -> record
    metadata: Optional[GBWTMetadata] = None
    tags: Dict[str, str] = field(default_factory=dict)

    # ------------------------------------------------------------ write

    def write(self, path: str) -> None:
        with open(path, "wb") as out:
            self.write_stream(out)

    def write_stream(self, out: BinaryIO) -> None:
        flags = (FLAG_BIDIRECTIONAL if self.bidirectional else 0) | (
            FLAG_METADATA if self.metadata is not None else 0
        )
        sdsl.write_u32(out, GBWT_TAG)
        sdsl.write_u32(out, GBWT_VERSION)
        sdsl.write_u64(out, self.sequences)
        sdsl.write_u64(out, self.size)
        sdsl.write_u64(out, self.offset)
        sdsl.write_u64(out, self.alphabet_size)
        sdsl.write_u64(out, flags)

        tags = dict(self.tags)
        tags.setdefault("source", "rpvg_tpu")
        flat: List[str] = []
        for key in sorted(tags):
            flat.extend((key, tags[key]))
        blobs = [s.encode() for s in flat]
        offsets = np.zeros(len(blobs) + 1, dtype=np.uint64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        sdsl.write_int_vector(out, offsets)
        sdsl.write_byte_vector(out, b"".join(blobs))

        # RecordArray: comp ids are dense 0..max_comp.
        n_records = self.alphabet_size - self.offset
        blob = bytearray()
        starts = []
        for comp in range(n_records):
            starts.append(len(blob))
            record = self.records.get(comp)
            blob.extend(record.encode() if record is not None else b"\x00")
        sdsl.write_u64(out, n_records)
        sdsl.write_sd_vector(out, np.asarray(starts, dtype=np.uint64), max(1, len(blob)))
        sdsl.write_u64(out, len(blob))
        out.write(bytes(blob))

        # Empty DASamples (extraction walks LF; locate uses our own
        # occurrence arrays).
        sdsl.write_bit_vector(out, np.zeros(n_records, dtype=bool))
        sdsl.write_sd_vector(out, np.zeros(0, dtype=np.uint64), max(1, self.size))
        sdsl.write_sd_vector(out, np.zeros(0, dtype=np.uint64), max(1, self.size))
        sdsl.write_int_vector(out, np.zeros(0, dtype=np.uint64), width=1)

        if self.metadata is not None:
            _write_metadata(out, self.metadata)

    # ------------------------------------------------------------- read

    @classmethod
    def read(cls, path: str) -> "GBWTFile":
        with open(path, "rb") as handle:
            return cls.read_stream(handle)

    @classmethod
    def read_stream(cls, handle: BinaryIO) -> "GBWTFile":
        tag = sdsl.read_u32(handle)
        if tag != GBWT_TAG:
            raise ValueError(
                f"not a GBWT file (tag 0x{tag:08X}, expected 0x{GBWT_TAG:08X})"
            )
        version = sdsl.read_u32(handle)
        if version > GBWT_VERSION:
            raise ValueError(f"GBWT: unsupported file format version {version}")
        out = cls()
        out.sequences = sdsl.read_u64(handle)
        out.size = sdsl.read_u64(handle)
        out.offset = sdsl.read_u64(handle)
        out.alphabet_size = sdsl.read_u64(handle)
        flags = sdsl.read_u64(handle)
        out.bidirectional = bool(flags & FLAG_BIDIRECTIONAL)

        if version >= 5:
            offsets = sdsl.read_int_vector(handle)
            data = sdsl.read_byte_vector(handle)
            flat = [
                data[int(offsets[i]) : int(offsets[i + 1])].decode()
                for i in range(len(offsets) - 1)
            ]
            out.tags = dict(zip(flat[0::2], flat[1::2]))

        n_records = sdsl.read_u64(handle)
        starts, _ = sdsl.read_sd_vector(handle)
        blob_size = sdsl.read_u64(handle)
        blob = handle.read(blob_size)
        if len(blob) != blob_size:
            raise EOFError("GBWT: truncated record blob")
        if len(starts) != n_records:
            raise ValueError(
                f"GBWT: record index has {len(starts)} entries for {n_records} records"
            )
        bounds = list(starts) + [blob_size]
        for comp in range(n_records):
            chunk = blob[int(bounds[comp]) : int(bounds[comp + 1])]
            if chunk and chunk != b"\x00":
                out.records[comp] = GBWTRecord.decode(chunk)

        # DASamples (contents unused: extraction walks LF from the
        # endmarker).
        sdsl.read_bit_vector(handle)
        sdsl.read_sd_vector(handle)
        sdsl.read_sd_vector(handle)
        sdsl.read_int_vector(handle)

        if flags & FLAG_METADATA:
            out.metadata = _read_metadata(handle)
        return out

    # ------------------------------------------------------- extraction

    def node_of_comp(self, comp: int) -> int:
        return 0 if comp == 0 else comp + self.offset

    def comp_of_node(self, node: int) -> int:
        return 0 if node == 0 else node - self.offset

    def extract(self, sequence_id: int) -> List[int]:
        """Extract sequence `sequence_id` as a list of GBWT node ids by
        walking LF from the endmarker (gbwt::GBWT::extract)."""
        endmarker = self.records.get(0)
        if endmarker is None or sequence_id >= self.sequences:
            raise IndexError(f"sequence {sequence_id} out of range")
        bodies: Dict[int, np.ndarray] = {}

        def body(comp: int) -> np.ndarray:
            if comp not in bodies:
                bodies[comp] = self.records[comp].body()
            return bodies[comp]

        result: List[int] = []
        record = endmarker
        comp = 0
        offset = sequence_id
        while True:
            ranks = body(comp)
            edge_rank = int(ranks[offset])
            succ, succ_offset = record.edges[edge_rank]
            if succ == ENDMARKER:
                return result
            # LF: offset within successor = stored incoming offset +
            # rank of this position among same-edge positions before it.
            offset = succ_offset + int(
                np.count_nonzero(ranks[:offset] == edge_rank)
            )
            comp = self.comp_of_node(succ)
            record = self.records[comp]
            result.append(succ)
            if len(result) > self.size:
                raise ValueError("GBWT: extraction exceeded index size (corrupt?)")

    def extract_all(self) -> List[List[int]]:
        return [self.extract(i) for i in range(self.sequences)]


# ------------------------------------------------------------ construction


def build_gbwt(
    sequences: Sequence[Sequence[int]],
    bidirectional: bool = False,
    metadata: Optional[GBWTMetadata] = None,
    tags: Optional[Dict[str, str]] = None,
) -> GBWTFile:
    """Construct a GBWT over `sequences` of GBWT node ids (already in
    GBWT node space; for bidirectional indexes pass forward and reverse
    orientations alternately, vg convention node*2+orient).

    Positions within each node's record are ordered co-lexicographically
    by their preceding path (ties broken by sequence rank), matching the
    prefix-sorted invariant LF extraction relies on.
    """
    sequences = [list(map(int, seq)) for seq in sequences]
    for seq in sequences:
        assert all(node > 0 for node in seq), "node 0 is the endmarker"

    all_nodes = sorted({node for seq in sequences for node in seq})
    if not all_nodes:
        offset = 0
        alphabet_size = 1
    else:
        offset = all_nodes[0] - 1
        alphabet_size = all_nodes[-1] + 1

    out = GBWTFile(
        sequences=len(sequences),
        size=sum(len(seq) + 1 for seq in sequences),
        offset=offset,
        alphabet_size=alphabet_size,
        bidirectional=bidirectional,
        metadata=metadata,
        tags=dict(tags or {}),
    )

    # Visits to each node: (sequence, step).  Sort key = reverse prefix
    # (previous nodes walking backwards), endmarker (0) then sequence
    # rank as the final tiebreaker.
    visits: Dict[int, List[Tuple[Tuple[int, ...], int, int]]] = {}
    for si, seq in enumerate(sequences):
        for t, node in enumerate(seq):
            key = tuple(reversed(seq[:t])) + (0, si)
            visits.setdefault(node, []).append((key, si, t))

    # Record per node: sorted visit list and successor of each visit.
    order: Dict[int, List[Tuple[int, int]]] = {}
    for node, items in visits.items():
        items.sort()
        order[node] = [(si, t) for _, si, t in items]

    def successor(si: int, t: int) -> int:
        seq = sequences[si]
        return seq[t + 1] if t + 1 < len(seq) else ENDMARKER

    # Incoming offsets: for edge (v -> w), the number of positions in
    # records u < v (comp order, endmarker first) whose successor is w.
    nodes_in_order = [0] + all_nodes
    succ_counts: Dict[int, Dict[int, int]] = {}
    for node in nodes_in_order:
        if node == 0:
            positions = [(si, -1) for si in range(len(sequences))]
        else:
            positions = order[node]
        counts: Dict[int, int] = {}
        for si, t in positions:
            seq = sequences[si]
            succ = seq[t + 1] if t + 1 < len(seq) else ENDMARKER
            counts[succ] = counts.get(succ, 0) + 1
        succ_counts[node] = counts

    incoming_offset: Dict[Tuple[int, int], int] = {}
    running: Dict[int, int] = {}
    for node in nodes_in_order:
        for succ, count in sorted(succ_counts[node].items()):
            incoming_offset[(node, succ)] = running.get(succ, 0)
            running[succ] = running.get(succ, 0) + count

    # Build records.
    for node in nodes_in_order:
        if node == 0:
            positions = [(si, -1) for si in range(len(sequences))]
        else:
            positions = order[node]
        succs = [successor(si, t) for si, t in positions]
        edge_nodes = sorted(set(succs))
        edge_rank = {w: i for i, w in enumerate(edge_nodes)}
        record = GBWTRecord(
            edges=[(w, incoming_offset[(node, w)] if w != ENDMARKER else 0) for w in edge_nodes]
        )
        runs: List[Tuple[int, int]] = []
        for s in succs:
            rank = edge_rank[s]
            if runs and runs[-1][0] == rank:
                runs[-1] = (rank, runs[-1][1] + 1)
            else:
                runs.append((rank, 1))
        record.runs = runs
        comp = node if node == 0 else node - offset
        out.records[comp] = record

    return out


# ------------------------------------------------------------- r-index

# gbwt::FastLocate serialized header (fast_locate.h in the vendored gbwt
# submodule; the reference auto-loads `<paths>.gbwt.ri` when present,
# reference/src/main.cpp:616-631, via the R-INDEX VPKG magic =
# Header::TAG, src/io/register_loader_saver_r_index.cpp:23-42).
RI_TAG = 0x6B37AAA1


def read_ri_header(path: str) -> Dict[str, int]:
    """Validate a gbwt::FastLocate (.ri) sidecar header.

    rpvg_tpu's locate() is a vectorised searchsorted over the occurrence
    index, which already serves the role the r-index plays for the
    reference (fast locate of path ids), so the structure body is
    validated-and-ignored; a wrong magic fails loudly like every other
    binary loader (tests/test_gam_framing.py contract)."""
    import struct

    with open(path, "rb") as handle:
        data = handle.read(24)
    if len(data) < 24:
        raise ValueError(f"truncated r-index header in {path}")
    tag, version, max_length, flags = struct.unpack("<IIQQ", data)
    if tag != RI_TAG:
        raise ValueError(
            f"not a FastLocate r-index (tag 0x{tag:08X}, expected 0x{RI_TAG:08X})"
        )
    return {"version": version, "max_length": max_length, "flags": flags}


def write_ri_stub(path: str, max_length: int = 1, version: int = 1) -> None:
    """Write a minimal structurally-valid FastLocate container (header +
    empty sample structures) — fixture writer for the sidecar tests."""
    import struct

    with open(path, "wb") as out:
        out.write(struct.pack("<IIQQ", RI_TAG, version, max_length, 0))
        sdsl.write_int_vector(out, np.zeros(0, dtype=np.uint64))  # samples
        sdsl.write_bit_vector(out, np.zeros(0, dtype=bool))  # last
        sdsl.write_int_vector(out, np.zeros(0, dtype=np.uint64))  # last_to_run
        sdsl.write_int_vector(out, np.zeros(0, dtype=np.uint64))  # comp_to_run
