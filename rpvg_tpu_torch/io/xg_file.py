"""xg::XG succinct graph container — node-length loading (+ fixture
writer).

The reference loads its graph as a serialized xg::XG via typed VPKG
dispatch (``-g graph.xg``, reference/src/main.cpp:616-623,
src/io/register_libvg_io.cpp:26-31) and consumes ONLY node lengths from
it (src/paths_index.cpp:33-54 builds an id->length table through
``get_length(get_handle(id))``); topology and paths come from the GBWT.
This module therefore parses the XG prefix up to the packed graph
vector and extracts ``{node_id: sequence_length}``.

Container layout (XG serialization format v13, vgteam/xg layout over
sdsl-lite streams; the xg submodule is a stub in this snapshot and all
binary fixtures are stripped, so the layout below is validated by
round-trip and enforced with named defensive checks that fail loudly on
mismatch instead of misparsing):

    [VPKG]     optionally the whole payload is wrapped in a BGZF
               type-tagged message stream with tag "XG" (vg's VPKG
               save); chunk payloads concatenate to the raw stream.
    magic      u32 big-endian (SerializableHandleGraph); readers accept
               a missing/unknown magic by rewinding, like the upstream
               deserializer does for older files.
    version    u32 little-endian file format version.
    members    sequence_length u64, node_count u64, edge_count u64,
               path_count u64, min_id u64, max_id u64 (sdsl
               write_member PODs).
    r_iv       int_vector<0>: (id - min_id) -> rank+1, 0 when absent.
    g_iv       int_vector<0>: packed graph records, per node
               [id, seq_start, length, to_count, from_count,
                to_count+from_count x (relative_offset, type)].
    g_bv       bit_vector marking each record start in g_iv,
               + rank_support_v (int_vector<64> basic blocks)
               + select_support_mcl.
    s_iv...    sequence/base-code vectors and path structures follow;
               node-length extraction never reads past g_bv's supports.
"""

from __future__ import annotations

import gzip
import io as _io
import struct
from typing import BinaryIO, Dict

import numpy as np

from . import sdsl

XG_MAGIC = 0x58472667  # best-effort "XG" magic; readers tolerate others
XG_VERSION = 13

_G_NODE_ID = 0
_G_NODE_SEQ_START = 1
_G_NODE_LENGTH = 2
_G_NODE_TO_COUNT = 3
_G_NODE_FROM_COUNT = 4
_G_NODE_HEADER = 5
_G_EDGE_LENGTH = 2


# --------------------------------------------------------- VPKG wrapping


def _unwrap_vpkg(path: str, tag: bytes) -> bytes:
    """Return the raw serialized payload: concatenated chunk messages
    when the file is a (gzip/BGZF) type-tagged framed stream carrying
    `tag`, the file bytes verbatim otherwise."""
    with open(path, "rb") as handle:
        head = handle.read(2)
    if head != b"\x1f\x8b":
        with open(path, "rb") as handle:
            return handle.read()
    from .gam import read_framed_messages

    chunks = []
    for seen_tag, payload in read_framed_messages(path):
        if seen_tag is not None and seen_tag != tag:
            raise ValueError(
                f"VPKG stream carries tag {seen_tag!r}, expected {tag!r}"
            )
        chunks.append(payload)
    return b"".join(chunks)


def _wrap_vpkg(path: str, payload: bytes, tag: bytes) -> None:
    from .gam import write_framed_messages

    chunk = 1 << 20
    write_framed_messages(
        path,
        (payload[i : i + chunk] for i in range(0, max(len(payload), 1), chunk)),
        tag=tag,
        compress=True,
    )


# ----------------------------------------------------------------- reader


def read_xg_node_lengths(path: str) -> Dict[int, int]:
    """Parse a serialized xg::XG (bare or VPKG-wrapped) and return its
    ``{node_id: length}`` table."""
    payload = _unwrap_vpkg(path, b"XG")
    handle = _io.BytesIO(payload)

    magic = struct.unpack(">I", handle.read(4))[0]
    if magic != XG_MAGIC:
        handle.seek(0)  # upstream tolerates magicless/older files

    version = sdsl.read_u32(handle)
    if version > XG_VERSION:
        raise ValueError(f"XG: unsupported file format version {version}")

    sequence_length = sdsl.read_u64(handle)
    node_count = sdsl.read_u64(handle)
    edge_count = sdsl.read_u64(handle)
    path_count = sdsl.read_u64(handle)
    min_id = sdsl.read_u64(handle)
    max_id = sdsl.read_u64(handle)
    if node_count and not (0 < min_id <= max_id):
        raise ValueError(f"XG: invalid id range [{min_id}, {max_id}]")

    r_iv = sdsl.read_int_vector(handle)
    if node_count and len(r_iv) != max_id - min_id + 1:
        raise ValueError(
            f"XG: rank vector has {len(r_iv)} entries for id range "
            f"[{min_id}, {max_id}]"
        )
    g_iv = sdsl.read_int_vector(handle)
    g_bv = sdsl.read_bit_vector(handle)
    if len(g_bv) != len(g_iv):
        raise ValueError(
            f"XG: graph bit vector length {len(g_bv)} != graph vector "
            f"length {len(g_iv)}"
        )

    starts = np.flatnonzero(g_bv)
    if len(starts) != node_count:
        raise ValueError(
            f"XG: {len(starts)} node records marked for node_count {node_count}"
        )

    lengths: Dict[int, int] = {}
    g = g_iv.astype(np.int64)
    for start in starts:
        node_id = int(g[start + _G_NODE_ID])
        if not (min_id <= node_id <= max_id):
            raise ValueError(f"XG: record node id {node_id} outside id range")
        lengths[node_id] = int(g[start + _G_NODE_LENGTH])
    if sum(lengths.values()) != sequence_length:
        raise ValueError(
            "XG: node lengths do not sum to the recorded sequence length"
        )
    return lengths


# ----------------------------------------------------------------- writer


def write_xg(
    path: str, node_lengths: Dict[int, int], vpkg: bool = True
) -> None:
    """Serialize a minimal structurally-valid xg::XG container holding
    `node_lengths` (fixture writer; no edges or paths — the loading
    surface above never reads them)."""
    out = _io.BytesIO()
    ids = sorted(node_lengths)
    node_count = len(ids)
    min_id = ids[0] if ids else 0
    max_id = ids[-1] if ids else 0
    sequence_length = sum(node_lengths.values())

    out.write(struct.pack(">I", XG_MAGIC))
    sdsl.write_u32(out, XG_VERSION)
    sdsl.write_u64(out, sequence_length)
    sdsl.write_u64(out, node_count)
    sdsl.write_u64(out, 0)  # edge_count
    sdsl.write_u64(out, 0)  # path_count
    sdsl.write_u64(out, min_id)
    sdsl.write_u64(out, max_id)

    r_iv = np.zeros(max_id - min_id + 1 if ids else 0, dtype=np.uint64)
    for rank, node_id in enumerate(ids):
        r_iv[node_id - min_id] = rank + 1
    sdsl.write_int_vector(out, r_iv)

    g_iv = np.zeros(node_count * _G_NODE_HEADER, dtype=np.uint64)
    g_bv = np.zeros(node_count * _G_NODE_HEADER, dtype=bool)
    seq_start = 0
    for rank, node_id in enumerate(ids):
        base = rank * _G_NODE_HEADER
        g_bv[base] = True
        g_iv[base + _G_NODE_ID] = node_id
        g_iv[base + _G_NODE_SEQ_START] = seq_start
        g_iv[base + _G_NODE_LENGTH] = node_lengths[node_id]
        seq_start += node_lengths[node_id]
    sdsl.write_int_vector(out, g_iv)
    sdsl.write_bit_vector(out, g_bv)
    # g_bv supports: rank_support_v basic blocks (2 u64 words per
    # 512-bit block) and select_support_mcl — readers skip + rebuild.
    n_blocks = (len(g_bv) + 511) // 512
    basic = np.zeros(2 * n_blocks, dtype=np.uint64)
    running = 0
    for block in range(n_blocks):
        basic[2 * block] = running
        running += int(g_bv[block * 512 : (block + 1) * 512].sum())
    sdsl.write_int_vector(out, basic, fixed_width=64)
    sdsl.write_select_support(
        out, np.flatnonzero(g_bv).astype(np.uint64), len(g_bv)
    )

    payload = out.getvalue()
    if vpkg:
        _wrap_vpkg(path, payload, b"XG")
    else:
        with open(path, "wb") as handle:
            handle.write(payload)
