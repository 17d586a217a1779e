"""sdsl-lite serialization primitives (little-endian, stream layout).

The reference loads its prebuilt indexes — `.gbwt` (gbwt::GBWT),
`.gbwt.ri` (gbwt::FastLocate) and `.xg` (xg::XG) — through sdsl-lite
serialization (reference reference/src/main.cpp:616-631 via
vg::io::VPKG; the vendored sdsl-lite submodule is the byte-layout
authority, reference/.gitmodules:1-24).  This module implements
the stream primitives those containers are built from:

* ``write_member``/``read_member`` — raw little-endian scalars
  (sdsl-lite ``util::write_member`` for POD types).
* ``int_vector<w>`` — header = size in BITS (uint64), plus the width
  byte (uint8) for the variable-width ``int_vector<0>`` only, followed
  by the packed 64-bit words (``ceil(bits/64)`` full words).
* ``bit_vector`` — ``int_vector<1>``.
* ``sd_vector<>`` — Elias-Fano: size (u64), low width (u8), ``m_low``
  (int_vector<0>), ``m_high`` (bit_vector), then the two
  ``select_support_mcl`` members (1-select and 0-select over m_high).

The vendored submodules are empty stubs in this snapshot and the binary
example indexes are stripped (``.MISSING_LARGE_BLOBS``), so the layout
follows the sdsl-lite stream format as documented here and is validated
by writer/reader round-trip fixtures (tests/test_sdsl.py); structure
boundaries are checked defensively so a mismatch against a real file
fails loudly at a named structure instead of silently misparsing.

Readers rebuild rank/select supports from the underlying bit vectors
rather than trusting file payloads, so support blocks only need to be
*skipped* correctly.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Tuple

import numpy as np


# ------------------------------------------------------------- scalars


def write_u64(out: BinaryIO, value: int) -> None:
    out.write(struct.pack("<Q", value))


def read_u64(handle: BinaryIO) -> int:
    data = handle.read(8)
    if len(data) != 8:
        raise EOFError("truncated uint64")
    return struct.unpack("<Q", data)[0]


def write_u32(out: BinaryIO, value: int) -> None:
    out.write(struct.pack("<I", value))


def read_u32(handle: BinaryIO) -> int:
    data = handle.read(4)
    if len(data) != 4:
        raise EOFError("truncated uint32")
    return struct.unpack("<I", data)[0]


def write_u8(out: BinaryIO, value: int) -> None:
    out.write(struct.pack("<B", value))


def read_u8(handle: BinaryIO) -> int:
    data = handle.read(1)
    if len(data) != 1:
        raise EOFError("truncated uint8")
    return data[0]


# --------------------------------------------------------- bit packing


def _pack_bits(values: np.ndarray, width: int) -> bytes:
    """Pack `values` (uint64 array) at `width` bits each into sdsl's
    64-bit little-endian word layout (bit i of the logical stream is bit
    (i % 64) of word (i // 64))."""
    n = len(values)
    total_bits = n * width
    n_words = (total_bits + 63) // 64
    if width == 0 or n == 0:
        return b"\x00" * (n_words * 8)
    # Spread each value's bits into a flat boolean array, then pack.
    bits = np.zeros(n_words * 64, dtype=bool)
    vals = np.asarray(values, dtype=np.uint64)
    starts = np.arange(n, dtype=np.int64) * width
    for b in range(width):
        bits[starts + b] = (vals >> np.uint64(b)) & np.uint64(1) != 0
    words = np.packbits(bits.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)
    return words.tobytes()


def _unpack_bits(data: bytes, n: int, width: int) -> np.ndarray:
    """Inverse of _pack_bits: read n values of `width` bits."""
    if n == 0 or width == 0:
        return np.zeros(n, dtype=np.uint64)
    raw = np.frombuffer(data, dtype=np.uint8)
    bits = np.unpackbits(raw.reshape(-1, 1), axis=1)[:, ::-1].reshape(-1)
    out = np.zeros(n, dtype=np.uint64)
    starts = np.arange(n, dtype=np.int64) * width
    for b in range(width):
        out |= bits[starts + b].astype(np.uint64) << np.uint64(b)
    return out


# ----------------------------------------------------------- IntVector


def write_int_vector(out: BinaryIO, values, width: int = 0, fixed_width: int = 0) -> None:
    """Serialize an sdsl int_vector.

    fixed_width == 0 -> int_vector<0> (variable width; width byte in the
    header, `width` chooses the stored width, auto-fit when 0).
    fixed_width  > 0 -> int_vector<fixed_width> (no width byte).
    """
    values = np.asarray(values, dtype=np.uint64)
    if fixed_width:
        width = fixed_width
    elif width == 0:
        max_val = int(values.max()) if len(values) else 0
        width = max(1, max_val.bit_length())
    size_bits = len(values) * width
    write_u64(out, size_bits)
    if not fixed_width:
        write_u8(out, width)
    out.write(_pack_bits(values, width))


def read_int_vector(handle: BinaryIO, fixed_width: int = 0) -> np.ndarray:
    size_bits = read_u64(handle)
    width = fixed_width if fixed_width else read_u8(handle)
    if width == 0 or width > 64:
        raise ValueError(f"sdsl int_vector: invalid width {width}")
    if size_bits % width != 0:
        raise ValueError(
            f"sdsl int_vector: size {size_bits} bits not divisible by width {width}"
        )
    n = size_bits // width
    n_words = (size_bits + 63) // 64
    data = handle.read(n_words * 8)
    if len(data) != n_words * 8:
        raise EOFError("truncated int_vector payload")
    return _unpack_bits(data, n, width)


def write_bit_vector(out: BinaryIO, bits) -> None:
    """Serialize an sdsl bit_vector (int_vector<1>)."""
    bits = np.asarray(bits, dtype=bool)
    write_u64(out, len(bits))
    n_words = (len(bits) + 63) // 64
    padded = np.zeros(n_words * 64, dtype=bool)
    padded[: len(bits)] = bits
    words = np.packbits(padded.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)
    out.write(words.tobytes())


def read_bit_vector(handle: BinaryIO) -> np.ndarray:
    size_bits = read_u64(handle)
    n_words = (size_bits + 63) // 64
    data = handle.read(n_words * 8)
    if len(data) != n_words * 8:
        raise EOFError("truncated bit_vector payload")
    raw = np.frombuffer(data, dtype=np.uint8)
    bits = np.unpackbits(raw.reshape(-1, 1), axis=1)[:, ::-1].reshape(-1)
    return bits[:size_bits].astype(bool)


def write_byte_vector(out: BinaryIO, data: bytes) -> None:
    """Serialize an sdsl int_vector<8> holding raw bytes."""
    write_u64(out, len(data) * 8)
    out.write(data)
    pad = (-len(data)) % 8
    out.write(b"\x00" * pad)


def read_byte_vector(handle: BinaryIO) -> bytes:
    size_bits = read_u64(handle)
    if size_bits % 8 != 0:
        raise ValueError("sdsl int_vector<8>: bit size not a byte multiple")
    n = size_bits // 8
    n_words = (size_bits + 63) // 64
    data = handle.read(n_words * 8)
    if len(data) != n_words * 8:
        raise EOFError("truncated int_vector<8> payload")
    return data[:n]


# ------------------------------------------------- select_support_mcl
#
# sd_vector's two select members are serialized inline.  Readers here
# rebuild select from the decoded bit vector, so the support payload is
# written in a self-describing layout faithful to select_support_mcl's
# stream members (arg count, then the superblock tables when non-empty)
# and parsed structurally on read.  sdsl's m_longsuperblock/m_miniblock
# tables are emitted per superblock, each as an int_vector<0> (absent
# tables are written as empty vectors, the layout sdsl stores for
# superblocks that never triggered the long/mini cases).


_SUPER_BLOCK_SIZE = 4096


def write_select_support(out: BinaryIO, positions: np.ndarray, universe: int) -> None:
    """Serialize a select support over a bit vector whose set bits are
    at `positions` (sorted) within [0, universe)."""
    arg_cnt = len(positions)
    write_u64(out, arg_cnt)
    if arg_cnt == 0:
        return
    sb_count = (arg_cnt + _SUPER_BLOCK_SIZE - 1) // _SUPER_BLOCK_SIZE
    superblock = positions[::_SUPER_BLOCK_SIZE]
    write_int_vector(out, superblock, width=max(1, int(universe).bit_length()))
    # Per-superblock long/mini tables: emit the miniblock sample table
    # (every 64th argument) for each superblock; long tables empty.
    for sb in range(sb_count):
        write_int_vector(out, np.zeros(0, dtype=np.uint64), width=1)  # longsuperblock
    for sb in range(sb_count):
        lo = sb * _SUPER_BLOCK_SIZE
        hi = min(arg_cnt, lo + _SUPER_BLOCK_SIZE)
        mini = positions[lo:hi:64] - positions[lo]
        write_int_vector(out, mini, width=max(1, int(universe).bit_length()))


def read_select_support(handle: BinaryIO) -> None:
    """Parse (and discard) a select support block written by
    write_select_support; supports are rebuilt from the bit vector."""
    arg_cnt = read_u64(handle)
    if arg_cnt == 0:
        return
    read_int_vector(handle)  # superblock samples
    sb_count = (arg_cnt + _SUPER_BLOCK_SIZE - 1) // _SUPER_BLOCK_SIZE
    for _ in range(sb_count):
        read_int_vector(handle)  # longsuperblock
    for _ in range(sb_count):
        read_int_vector(handle)  # miniblock


# ------------------------------------------------------------ sd_vector
#
# Elias-Fano encoding of a sorted position set: low `wl` bits of each
# position stored flat in m_low, high bits unary-coded in m_high
# (position i set => bit (high(i) + i) of m_high).


def _sd_params(n: int, universe: int) -> int:
    """sdsl's low-part width choice: wl = max(1, floor(log2(universe/n)))."""
    if n == 0:
        return 1
    ratio = max(1, universe // n)
    return max(1, ratio.bit_length() - 1)


def write_sd_vector(out: BinaryIO, positions, universe: int) -> None:
    positions = np.asarray(positions, dtype=np.uint64)
    n = len(positions)
    wl = _sd_params(n, universe)
    write_u64(out, universe)
    write_u8(out, wl)
    low = positions & np.uint64((1 << wl) - 1)
    high = (positions >> np.uint64(wl)).astype(np.int64)
    write_int_vector(out, low, width=wl)
    high_len = n + (int(high[-1]) + 1 if n else 0)
    high_bits = np.zeros(high_len, dtype=bool)
    if n:
        high_bits[high + np.arange(n, dtype=np.int64)] = True
    write_bit_vector(out, high_bits)
    one_positions = np.flatnonzero(high_bits).astype(np.uint64)
    zero_positions = np.flatnonzero(~high_bits).astype(np.uint64)
    write_select_support(out, one_positions, high_len)
    write_select_support(out, zero_positions, high_len)


def read_sd_vector(handle: BinaryIO) -> Tuple[np.ndarray, int]:
    """Returns (sorted set-bit positions, universe size)."""
    universe = read_u64(handle)
    wl = read_u8(handle)
    if wl == 0 or wl > 64:
        raise ValueError(f"sd_vector: invalid low width {wl}")
    low = read_int_vector(handle)
    high_bits = read_bit_vector(handle)
    read_select_support(handle)
    read_select_support(handle)
    n = len(low)
    ones = np.flatnonzero(high_bits)
    if len(ones) != n:
        raise ValueError(
            f"sd_vector: {len(ones)} high bits set for {n} low entries"
        )
    high = ones - np.arange(n, dtype=np.int64)
    positions = (high.astype(np.uint64) << np.uint64(wl)) | low
    return positions, universe
