"""Self-contained protobuf wire codec for the vg alignment messages.

The reference consumes binary ``.gam`` (vg::Alignment) and ``.gamp``
(vg::MultipathAlignment) streams through libvgio's generated protobuf
classes (reference/src/main.cpp:111,157 via
vg::io::ProtobufIterator).  The snapshot ships no vg.proto (deps are
stubs), so this module implements the protobuf *wire format* directly
— varint/64-bit/length-delimited field parsing — against a vendored
field-number table for the public vg schema (vgteam/libvgio
deps/vg.proto).  Field numbers are part of the serialized format
contract: any decoder interoperating with vg files must use the same
numbers, exactly as JSON field names are shared with `vg view -a`.

Only the messages and fields the reference reads are decoded
(alignment_path_finder.cpp, fragment_length_dist.cpp:289-311); unknown
fields are skipped by wire type, so files produced by newer vg versions
still parse.  Decoding yields plain snake_case dicts shaped like
``MessageToDict(preserving_proto_field_name=True)`` with bytes left as
bytes, which is exactly what rpvg_tpu.alignments.parse_* consume.

Encoders for every decoded message are included for fixture generation;
tests cross-validate both directions against google.protobuf with a
protoc-compiled copy of VG_PROTO_MINIMAL below (tests/test_vgproto.py),
so the wire layer is oracle-checked even though real vg binaries are
absent from the snapshot.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

# --------------------------------------------------------------- wire I/O

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    shift = 0
    while True:
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not (byte & 0x80):
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint longer than 64 bits")


def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement, 10-byte form
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            buf.append(bits | 0x80)
        else:
            buf.append(bits)
            return


def _iter_fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, raw value) over a message body."""
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field = key >> 3
        wire = key & 7
        if wire == _WIRE_VARINT:
            value, pos = _read_varint(data, pos)
        elif wire == _WIRE_LEN:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            if len(value) != length:
                raise ValueError("truncated length-delimited field")
            pos += length
        elif wire == _WIRE_I64:
            value = data[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_I32:
            value = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _iter_packed_varints(data: bytes) -> Iterator[int]:
    pos = 0
    while pos < len(data):
        value, pos = _read_varint(data, pos)
        yield value


# ------------------------------------------------------------ field tables
#
# kind: how to interpret + store the field.
#   "string" / "bytes" / "uint" / "int" / "bool" / "double"
#   "msg:Name"  submessage            "msgs:Name"   repeated submessage
#   "uints"     repeated uint (packed or not)
#   "struct"    google.protobuf.Struct

_SCHEMAS: Dict[str, Dict[int, Tuple[str, str]]] = {
    "Position": {
        1: ("node_id", "int"),
        2: ("offset", "int"),
        4: ("is_reverse", "bool"),
        5: ("name", "string"),
    },
    "Edit": {
        1: ("from_length", "int"),
        2: ("to_length", "int"),
        3: ("sequence", "string"),
    },
    "Mapping": {
        1: ("position", "msg:Position"),
        2: ("edit", "msgs:Edit"),
        5: ("rank", "int"),
    },
    "Path": {
        1: ("name", "string"),
        2: ("mapping", "msgs:Mapping"),
        4: ("is_circular", "bool"),
        5: ("length", "int"),
    },
    "Alignment": {
        1: ("sequence", "string"),
        2: ("path", "msg:Path"),
        3: ("name", "string"),
        4: ("quality", "bytes"),
        5: ("mapping_quality", "int"),
        6: ("score", "int"),
        7: ("query_position", "int"),
        9: ("sample_name", "string"),
        10: ("read_group", "string"),
        11: ("fragment_prev", "msg:Alignment"),
        12: ("fragment_next", "msg:Alignment"),
        15: ("is_secondary", "bool"),
        16: ("identity", "double"),
        17: ("fragment", "msgs:Path"),
        19: ("refpos", "msgs:Position"),
        20: ("paired_read_name", "string"),
        21: ("fragment_score", "double"),
        22: ("mate_mapped_to_disjoint_subgraph", "bool"),
        23: ("fragment_length_distribution", "string"),
        24: ("time_used", "int"),
        25: ("to_correct", "msg:Position"),
        26: ("correctly_mapped", "bool"),
        100: ("annotation", "struct"),
    },
    "MultipathAlignment": {
        1: ("sequence", "string"),
        2: ("quality", "bytes"),
        3: ("name", "string"),
        4: ("sample_name", "string"),
        5: ("read_group", "string"),
        6: ("subpath", "msgs:Subpath"),
        7: ("mapping_quality", "int"),
        8: ("start", "uints"),
        9: ("paired_read_name", "string"),
        10: ("annotation", "struct"),
    },
    "Subpath": {
        1: ("path", "msg:Path"),
        2: ("next", "uints"),
        3: ("score", "int"),
        4: ("connection", "msgs:Connection"),
    },
    "Connection": {
        1: ("next", "uint"),
        2: ("score", "int"),
    },
}


def _to_signed64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _decode_struct(data: bytes) -> dict:
    """google.protobuf.Struct -> plain dict of unwrapped values."""
    fields: dict = {}
    for field, wire, value in _iter_fields(data):
        if field == 1 and wire == _WIRE_LEN:  # map<string, Value> entry
            key = None
            val = None
            for efield, ewire, evalue in _iter_fields(value):
                if efield == 1 and ewire == _WIRE_LEN:
                    key = evalue.decode("utf-8")
                elif efield == 2 and ewire == _WIRE_LEN:
                    val = _decode_value(evalue)
            if key is not None:
                fields[key] = val
    return fields


def _decode_value(data: bytes):
    """google.protobuf.Value -> python value."""
    result = None
    for field, wire, value in _iter_fields(data):
        if field == 1:  # null_value
            result = None
        elif field == 2:  # number_value
            result = struct.unpack("<d", value)[0]
        elif field == 3:  # string_value
            result = value.decode("utf-8")
        elif field == 4:  # bool_value
            result = bool(value)
        elif field == 5:  # struct_value
            result = _decode_struct(value)
        elif field == 6:  # list_value
            result = [
                _decode_value(v)
                for f, w, v in _iter_fields(value)
                if f == 1 and w == _WIRE_LEN
            ]
    return result


def decode_message(data: bytes, message: str) -> dict:
    schema = _SCHEMAS[message]
    out: dict = {}
    for field, wire, value in _iter_fields(data):
        entry = schema.get(field)
        if entry is None:
            continue  # unknown field: already skipped by wire type
        name, kind = entry
        # Wire-type validation: a corrupted key byte can flip a field's
        # wire type, delivering e.g. a varint where a string is declared.
        # Reject loudly instead of dying downstream on the wrong Python
        # type (real protobuf parsers reject wire mismatches the same way).
        if kind in ("string", "bytes", "struct") or kind.startswith(("msg:", "msgs:")):
            if wire != _WIRE_LEN:
                raise ValueError(f"{message}.{name}: {kind} with wire type {wire}")
        elif kind in ("int", "uint", "bool"):
            if wire != _WIRE_VARINT:
                raise ValueError(f"{message}.{name}: {kind} with wire type {wire}")
        if kind == "string":
            out[name] = value.decode("utf-8")
        elif kind == "bytes":
            out[name] = bytes(value)
        elif kind == "int":
            out[name] = _to_signed64(value)
        elif kind == "uint":
            out[name] = value
        elif kind == "bool":
            out[name] = bool(value)
        elif kind == "double":
            if wire != _WIRE_I64:
                raise ValueError(f"{message}.{name}: double with wire type {wire}")
            out[name] = struct.unpack("<d", value)[0]
        elif kind == "struct":
            out[name] = _decode_struct(value)
        elif kind == "uints":
            target = out.setdefault(name, [])
            if wire == _WIRE_LEN:  # packed (proto3 default)
                target.extend(_iter_packed_varints(value))
            else:
                target.append(value)
        elif kind.startswith("msgs:"):
            out.setdefault(name, []).append(decode_message(value, kind[5:]))
        elif kind.startswith("msg:"):
            out[name] = decode_message(value, kind[4:])
        else:  # pragma: no cover - table is static
            raise AssertionError(kind)
    return out


def decode_alignment(data: bytes) -> dict:
    return decode_message(data, "Alignment")


def decode_multipath_alignment(data: bytes) -> dict:
    return decode_message(data, "MultipathAlignment")


# -------------------------------------------------------------- encoders


def _write_key(buf: bytearray, field: int, wire: int) -> None:
    _write_varint(buf, (field << 3) | wire)


def _write_len_field(buf: bytearray, field: int, payload: bytes) -> None:
    _write_key(buf, field, _WIRE_LEN)
    _write_varint(buf, len(payload))
    buf.extend(payload)


def _encode_value(value) -> bytes:
    buf = bytearray()
    if value is None:
        _write_key(buf, 1, _WIRE_VARINT)
        _write_varint(buf, 0)
    elif isinstance(value, bool):
        _write_key(buf, 4, _WIRE_VARINT)
        _write_varint(buf, int(value))
    elif isinstance(value, (int, float)):
        _write_key(buf, 2, _WIRE_I64)
        buf.extend(struct.pack("<d", float(value)))
    elif isinstance(value, str):
        _write_len_field(buf, 3, value.encode("utf-8"))
    elif isinstance(value, dict):
        _write_len_field(buf, 5, _encode_struct(value))
    elif isinstance(value, list):
        inner = bytearray()
        for item in value:
            _write_len_field(inner, 1, _encode_value(item))
        _write_len_field(buf, 6, bytes(inner))
    else:
        raise TypeError(f"unsupported Struct value {value!r}")
    return bytes(buf)


def _encode_struct(fields: dict) -> bytes:
    buf = bytearray()
    for key, value in fields.items():
        entry = bytearray()
        _write_len_field(entry, 1, key.encode("utf-8"))
        _write_len_field(entry, 2, _encode_value(value))
        _write_len_field(buf, 1, bytes(entry))
    return bytes(buf)


def encode_message(obj: dict, message: str) -> bytes:
    schema = _SCHEMAS[message]
    by_name = {name: (field, kind) for field, (name, kind) in schema.items()}
    buf = bytearray()
    for name, value in obj.items():
        if name not in by_name:
            raise KeyError(f"{message} has no field {name!r}")
        field, kind = by_name[name]
        if kind == "string":
            _write_len_field(buf, field, str(value).encode("utf-8"))
        elif kind == "bytes":
            _write_len_field(buf, field, bytes(value))
        elif kind in ("int", "uint"):
            _write_key(buf, field, _WIRE_VARINT)
            _write_varint(buf, int(value))
        elif kind == "bool":
            _write_key(buf, field, _WIRE_VARINT)
            _write_varint(buf, int(bool(value)))
        elif kind == "double":
            _write_key(buf, field, _WIRE_I64)
            buf.extend(struct.pack("<d", float(value)))
        elif kind == "struct":
            _write_len_field(buf, field, _encode_struct(value))
        elif kind == "uints":
            packed = bytearray()
            for item in value:
                _write_varint(packed, int(item))
            _write_len_field(buf, field, bytes(packed))
        elif kind.startswith("msgs:"):
            for item in value:
                _write_len_field(buf, field, encode_message(item, kind[5:]))
        elif kind.startswith("msg:"):
            _write_len_field(buf, field, encode_message(value, kind[4:]))
        else:  # pragma: no cover - table is static
            raise AssertionError(kind)
    return bytes(buf)


def encode_alignment(obj: dict) -> bytes:
    return encode_message(obj, "Alignment")


def encode_multipath_alignment(obj: dict) -> bytes:
    return encode_message(obj, "MultipathAlignment")


# ----------------------------------------------------- reference schema text
#
# protoc-compilable twin of the vendored field table, used by the tests
# to cross-validate the hand-rolled codec against google.protobuf, and
# by `python -m rpvg_tpu.tools gamp-to-rpa` when no vg.proto is given.

VG_PROTO_MINIMAL = """
syntax = "proto3";
package vg;
import "google/protobuf/struct.proto";

message Position {
  int64 node_id = 1;
  int64 offset = 2;
  bool is_reverse = 4;
  string name = 5;
}

message Edit {
  int32 from_length = 1;
  int32 to_length = 2;
  string sequence = 3;
}

message Mapping {
  Position position = 1;
  repeated Edit edit = 2;
  int64 rank = 5;
}

message Path {
  string name = 1;
  repeated Mapping mapping = 2;
  bool is_circular = 4;
  int64 length = 5;
}

message Alignment {
  string sequence = 1;
  Path path = 2;
  string name = 3;
  bytes quality = 4;
  int32 mapping_quality = 5;
  int32 score = 6;
  int32 query_position = 7;
  string sample_name = 9;
  string read_group = 10;
  Alignment fragment_prev = 11;
  Alignment fragment_next = 12;
  bool is_secondary = 15;
  double identity = 16;
  repeated Path fragment = 17;
  repeated Position refpos = 19;
  string paired_read_name = 20;
  double fragment_score = 21;
  bool mate_mapped_to_disjoint_subgraph = 22;
  string fragment_length_distribution = 23;
  int64 time_used = 24;
  Position to_correct = 25;
  bool correctly_mapped = 26;
  google.protobuf.Struct annotation = 100;
}

message Connection {
  uint32 next = 1;
  int32 score = 2;
}

message Subpath {
  Path path = 1;
  repeated uint32 next = 2;
  int32 score = 3;
  repeated Connection connection = 4;
}

message MultipathAlignment {
  string sequence = 1;
  bytes quality = 2;
  string name = 3;
  string sample_name = 4;
  string read_group = 5;
  repeated Subpath subpath = 6;
  int32 mapping_quality = 7;
  repeated uint32 start = 8;
  string paired_read_name = 9;
  google.protobuf.Struct annotation = 10;
}
"""
