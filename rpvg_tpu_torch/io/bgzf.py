"""BGZF (blocked gzip) writer for the `.txt.gz` outputs.

The reference compresses every `.gz` output through HTSlib's BGZF layer
(reference/src/threaded_output_writer.cpp:10): each block is an
independent gzip member (<= 64 KiB) carrying a `BC` extra subfield with
the compressed block size, and the stream ends with a fixed 28-byte
empty-block EOF marker.  The result is readable by every ordinary gzip
reader (multi-member streams are standard) while staying blocked,
virtual-offset-indexable and `bgzip -t`-clean.

Layout per block (SAM spec section 4.1):

  1f 8b 08 04 | MTIME=0(4) | XFL=0 | OS=ff | XLEN=6
  'B' 'C' 02 00 | BSIZE(2, total block length - 1)
  <raw deflate of at most 0xff00 input bytes>
  CRC32(4) | ISIZE(4)
"""

from __future__ import annotations

import struct
import zlib

# HTSlib caps the uncompressed payload so a worst-case (incompressible)
# block still fits the 65536-byte BSIZE field.
MAX_BLOCK_INPUT = 0xFF00

# Empty final block — the BGZF end-of-file magic (SAM spec 4.1.2).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH2B2H")


def _pack_block(data: bytes, compresslevel: int) -> bytes:
    comp = zlib.compressobj(compresslevel, zlib.DEFLATED, -15)
    cdata = comp.compress(data) + comp.flush()
    bsize = len(cdata) + 25  # header(12) + BC subfield(6) + crc/isize(8) - 1
    if bsize >= 1 << 16:  # pragma: no cover - input cap prevents this
        raise ValueError("BGZF block overflow")
    header = _HEADER.pack(
        0x1F, 0x8B, 8, 4,  # gzip magic, deflate, FEXTRA
        0,  # MTIME
        0, 0xFF,  # XFL, OS=unknown
        6,  # XLEN
        0x42, 0x43, 2,  # 'B' 'C', SLEN=2
        bsize,
    )
    return header + cdata + struct.pack(
        "<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF
    )


class BgzfWriter:
    """Binary BGZF stream writer over an opened binary file object."""

    def __init__(self, raw, compresslevel: int = 6):
        self._raw = raw
        self._level = compresslevel
        self._buf = bytearray()
        self._closed = False

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_INPUT:
            chunk = bytes(self._buf[:MAX_BLOCK_INPUT])
            del self._buf[:MAX_BLOCK_INPUT]
            self._raw.write(_pack_block(chunk, self._level))
        return len(data)

    def flush(self) -> None:
        if self._buf:
            self._raw.write(_pack_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._raw.flush()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._raw.write(BGZF_EOF)
        self._closed = True
        self._raw.close()


class BgzfTextWriter:
    """Text-mode facade (the writers produce str chunks)."""

    def __init__(self, path: str, compresslevel: int = 6):
        self._writer = BgzfWriter(open(path, "wb"), compresslevel)

    def write(self, text: str) -> int:
        return self._writer.write(text.encode())

    def close(self) -> None:
        self._writer.close()
