"""vg framed protobuf stream (.gam/.gamp) support.

The vg ecosystem stores alignments as BGZF-compressed framed protobuf
streams (libvgio): a sequence of groups, each

    varint64  count
    count x ( varint32 length, message bytes )

where in type-tagged streams the first element of a group is a short
ASCII tag string ("GAM" for vg::Alignment, "MPA" for
vg::MultipathAlignment) instead of a message.  BGZF is gzip-compatible,
so the standard gzip module decompresses it.

Message decoding goes through the vendored wire codec
(rpvg_tpu.io.vgproto) by default, so binary .gam/.gamp streams load
with no conversion step and no external schema:

    rpvg-tpu -g graph.json -p panel.gbwt -a aln.gamp ...

A user-supplied vg.proto can still be compiled with protoc on the fly
(`--vg-proto`), which pins decoding to that exact schema instead.
"""

from __future__ import annotations

import gzip
import os
import subprocess
import sys
import tempfile
from typing import Iterator, Optional, Tuple

_TAGS = {b"GAM", b"MPA", b"GAMP"}


# ------------------------------------------------------------- varint I/O


def _read_varint(handle) -> Optional[int]:
    """LEB128 varint; None at clean EOF."""
    shift = 0
    value = 0
    first = True
    while True:
        byte = handle.read(1)
        if not byte:
            if first:
                return None
            raise EOFError("truncated varint")
        b = byte[0]
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value
        shift += 7
        first = False


def _write_varint(handle, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            handle.write(bytes([bits | 0x80]))
        else:
            handle.write(bytes([bits]))
            return


# ------------------------------------------------------------ frame layer


def read_framed_messages(path: str) -> Iterator[Tuple[Optional[bytes], bytes]]:
    """Yield (tag, message_bytes) from a framed (optionally BGZF/gzip
    compressed) vg stream."""
    with open(path, "rb") as raw:
        magic = raw.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open
    with opener(path, "rb") as handle:
        current_tag: Optional[bytes] = None
        while True:
            count = _read_varint(handle)
            if count is None:
                return
            first = True
            remaining = count
            while remaining > 0:
                length = _read_varint(handle)
                if length is None:
                    raise EOFError("truncated group")
                payload = handle.read(length)
                if len(payload) != length:
                    raise EOFError("truncated message")
                if first and _looks_like_tag(payload):
                    current_tag = payload
                else:
                    yield current_tag, payload
                first = False
                remaining -= 1


def _looks_like_tag(payload: bytes) -> bool:
    return 0 < len(payload) <= 8 and payload in _TAGS or (
        0 < len(payload) <= 8 and all(0x21 <= b <= 0x7E for b in payload) and payload.isupper()
    )


def write_framed_messages(
    path: str, messages, tag: bytes = b"GAM", group_size: int = 1000, compress: bool = True
) -> None:
    """Write a type-tagged framed stream (for tests and interchange)."""
    opener = gzip.open if compress else open
    with opener(path, "wb") as handle:
        group = []
        for message in messages:
            group.append(message)
            if len(group) == group_size:
                _write_group(handle, tag, group)
                group = []
        if group:
            _write_group(handle, tag, group)


def _write_group(handle, tag: bytes, group) -> None:
    _write_varint(handle, len(group) + 1)
    _write_varint(handle, len(tag))
    handle.write(tag)
    for message in group:
        _write_varint(handle, len(message))
        handle.write(message)


# -------------------------------------------------------- schema compile


def compile_vg_proto(vg_proto_path: str):
    """Compile a user-supplied vg.proto with protoc and import the
    generated module; returns it (exposes Alignment /
    MultipathAlignment classes)."""
    with tempfile.TemporaryDirectory() as tmp:
        proto_dir = os.path.dirname(os.path.abspath(vg_proto_path)) or "."
        result = subprocess.run(
            [
                "protoc",
                f"--proto_path={proto_dir}",
                f"--python_out={tmp}",
                os.path.basename(vg_proto_path),
            ],
            capture_output=True,
            text=True,
        )
        if result.returncode != 0:
            raise RuntimeError(f"protoc failed: {result.stderr}")
        module_name = os.path.basename(vg_proto_path).replace(".proto", "_pb2")
        sys.path.insert(0, tmp)
        try:
            import importlib

            return importlib.import_module(module_name)
        finally:
            sys.path.remove(tmp)


def stream_gam_dicts(
    path: str, vg_proto_path: Optional[str], is_multipath: bool
) -> Iterator[dict]:
    """Decode a binary .gam/.gamp into protobuf-JSON-style snake_case
    dicts.  With `vg_proto_path` the schema is compiled with protoc and
    decoding runs through google.protobuf; otherwise the vendored wire
    codec (rpvg_tpu.io.vgproto) decodes directly."""
    if vg_proto_path is None:
        from . import vgproto

        decode = (
            vgproto.decode_multipath_alignment
            if is_multipath
            else vgproto.decode_alignment
        )
        for tag, payload in read_framed_messages(path):
            yield decode(payload)
        return

    from google.protobuf.json_format import MessageToDict

    vg_pb2 = compile_vg_proto(vg_proto_path)
    message_class = (
        vg_pb2.MultipathAlignment if is_multipath else vg_pb2.Alignment
    )
    for tag, payload in read_framed_messages(path):
        message = message_class()
        message.ParseFromString(payload)
        yield MessageToDict(message, preserving_proto_field_name=True)


def stream_gam_alignments(path: str, is_multipath: bool) -> Iterator:
    """Parsed Alignment/MultipathAlignment objects from a binary
    .gam/.gamp stream (vendored schema), mirroring
    json_stream.stream_alignments."""
    from ..alignments import parse_alignment, parse_multipath_alignment

    parse = parse_multipath_alignment if is_multipath else parse_alignment
    for obj in stream_gam_dicts(path, None, is_multipath):
        yield parse(obj)


def write_gam_dicts(
    path: str, dicts, is_multipath: bool, compress: bool = True
) -> None:
    """Encode snake_case alignment dicts through the vendored schema
    into a type-tagged framed stream (fixtures and interchange).
    Base64-string quality values are accepted (the protobuf-JSON
    convention sim produces) alongside raw bytes."""
    import base64

    from . import vgproto

    encode = (
        vgproto.encode_multipath_alignment
        if is_multipath
        else vgproto.encode_alignment
    )

    def prepare(obj: dict) -> bytes:
        if isinstance(obj.get("quality"), str):
            obj = dict(obj)
            obj["quality"] = base64.b64decode(obj["quality"])
        return encode(obj)

    write_framed_messages(
        path,
        (prepare(obj) for obj in dicts),
        tag=b"MPA" if is_multipath else b"GAM",
        compress=compress,
    )


def is_gam_path(path: str) -> bool:
    base = path[:-3] if path.endswith(".gz") else path
    return base.endswith(".gam") or base.endswith(".gamp")
