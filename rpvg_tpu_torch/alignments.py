"""Graph alignment data model: single-path (GAM-style) and multipath
(GAMP-style) alignments, with protobuf-JSON parsing and the lazy
reverse-complement transforms the projection engine needs.

Mirrors the vg::Alignment / vg::MultipathAlignment subset actually
consumed by the reference engine (see reference/src/utils.hpp:304-479
for the lazy RC semantics: mappings are reversed and offsets flipped,
sequences/edits are NOT complemented).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from .constants import encode_node


@dataclass
class Edit:
    from_length: int = 0
    to_length: int = 0
    sequence: str = ""


@dataclass
class Mapping:
    node_id: int = 0
    offset: int = 0
    is_reverse: bool = False
    edits: List[Edit] = field(default_factory=list)

    def to_length(self) -> int:
        return sum(e.to_length for e in self.edits)

    def from_length(self) -> int:
        return sum(e.from_length for e in self.edits)

    def gbwt_node(self) -> int:
        return encode_node(self.node_id, self.is_reverse)

    def reverse_complement(self, node_length: Callable[[int], int]) -> "Mapping":
        """Offset-flipping lazy RC (reference utils.hpp:341-372)."""
        new_offset = self.offset
        if self.node_id != 0:
            used = self.from_length()
            unused_after = self.offset
            new_offset = node_length(self.node_id) - used - unused_after
        return Mapping(
            node_id=self.node_id,
            offset=new_offset,
            is_reverse=not self.is_reverse,
            edits=list(reversed(self.edits)),
        )


@dataclass
class GraphPath:
    mappings: List[Mapping] = field(default_factory=list)

    def reverse_complement(self, node_length: Callable[[int], int]) -> "GraphPath":
        return GraphPath([m.reverse_complement(node_length) for m in reversed(self.mappings)])


@dataclass
class Alignment:
    sequence: str = ""
    quality: bytes = b""
    score: int = 0
    mapping_quality: int = 0
    path: Optional[GraphPath] = None
    fragment_length_distribution: str = ""
    annotation: dict = field(default_factory=dict)
    name: str = ""

    def has_path(self) -> bool:
        return self.path is not None and len(self.path.mappings) > 0

    def reverse_complement(self, node_length: Callable[[int], int]) -> "Alignment":
        return Alignment(
            sequence=self.sequence[::-1],
            quality=self.quality[::-1],
            score=self.score,
            mapping_quality=self.mapping_quality,
            path=self.path.reverse_complement(node_length) if self.path else None,
            annotation=self.annotation,
            name=self.name,
        )


@dataclass
class Subpath:
    path: GraphPath = field(default_factory=GraphPath)
    next: List[int] = field(default_factory=list)
    score: int = 0
    connections: List[dict] = field(default_factory=list)


@dataclass
class MultipathAlignment:
    sequence: str = ""
    quality: bytes = b""
    mapping_quality: int = 0
    subpaths: List[Subpath] = field(default_factory=list)
    start: List[int] = field(default_factory=list)
    annotation: dict = field(default_factory=dict)
    name: str = ""

    def has_path(self) -> bool:
        return len(self.subpaths) > 0

    def reverse_complement(self, node_length: Callable[[int], int]) -> "MultipathAlignment":
        """Reverse the subpath DAG, keeping topological order (reference
        utils.hpp:410-479): subpaths are emitted in reverse order, edges
        and connections re-targeted, sinks become sources."""
        n = len(self.subpaths)
        reverse_edges: List[List[int]] = [[] for _ in range(n)]
        reverse_connections: List[List[tuple]] = [[] for _ in range(n)]
        reverse_starts: List[int] = []

        new_subpaths: List[Subpath] = []
        for i in range(n - 1, -1, -1):
            sp = self.subpaths[i]
            new_subpaths.append(
                Subpath(path=sp.path.reverse_complement(node_length), score=sp.score)
            )
            if sp.next or sp.connections:
                for nxt in sp.next:
                    reverse_edges[nxt].append(i)
                for conn in sp.connections:
                    reverse_connections[conn["next"]].append((i, conn.get("score", 0)))
            else:
                reverse_starts.append(i)

        for i in range(n):
            rc_sp = new_subpaths[i]
            for src in reverse_edges[n - i - 1]:
                rc_sp.next.append(n - src - 1)
            for src, score in reverse_connections[n - i - 1]:
                rc_sp.connections.append({"next": n - src - 1, "score": score})

        new_start: List[int] = []
        if self.start:
            new_start = [n - s - 1 for s in reverse_starts]

        return MultipathAlignment(
            sequence=self.sequence[::-1],
            quality=self.quality[::-1],
            mapping_quality=self.mapping_quality,
            subpaths=new_subpaths,
            start=new_start,
            annotation=self.annotation,
            name=self.name,
        )


# --------------------------------------------------------------------------
# Protobuf-JSON parsing (accepts both camelCase and snake_case keys).
# --------------------------------------------------------------------------


def _get(obj: dict, snake: str, camel: str, default=None):
    if snake in obj:
        return obj[snake]
    return obj.get(camel, default)


def _parse_quality(value) -> bytes:
    if not value:
        return b""
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    if isinstance(value, list):
        return bytes(value)
    # Protobuf JSON encodes bytes fields as base64.
    return base64.b64decode(value)


def _parse_annotation(value) -> dict:
    """Flatten a protobuf Struct-style annotation into plain values."""
    if not value:
        return {}
    fields = value.get("fields", value)

    def unwrap(v):
        if isinstance(v, dict):
            for k in ("string_value", "stringValue", "number_value", "numberValue",
                      "bool_value", "boolValue"):
                if k in v:
                    return v[k]
            return v
        return v

    return {k: unwrap(v) for k, v in fields.items()}


def parse_edit(obj: dict) -> Edit:
    return Edit(
        from_length=int(_get(obj, "from_length", "fromLength", 0) or 0),
        to_length=int(_get(obj, "to_length", "toLength", 0) or 0),
        sequence=obj.get("sequence", ""),
    )


def parse_mapping(obj: dict) -> Mapping:
    pos = obj.get("position", {}) or {}
    return Mapping(
        node_id=int(_get(pos, "node_id", "nodeId", 0) or 0),
        offset=int(pos.get("offset", 0) or 0),
        is_reverse=bool(_get(pos, "is_reverse", "isReverse", False)),
        edits=[parse_edit(e) for e in obj.get("edit", [])],
    )


def parse_path(obj: dict) -> GraphPath:
    return GraphPath([parse_mapping(m) for m in obj.get("mapping", [])])


def parse_alignment(obj: dict) -> Alignment:
    path_obj = obj.get("path")
    return Alignment(
        sequence=obj.get("sequence", ""),
        quality=_parse_quality(obj.get("quality")),
        score=int(obj.get("score", 0) or 0),
        mapping_quality=int(_get(obj, "mapping_quality", "mappingQuality", 0) or 0),
        path=parse_path(path_obj) if path_obj else None,
        fragment_length_distribution=_get(
            obj, "fragment_length_distribution", "fragmentLengthDistribution", ""
        )
        or "",
        annotation=_parse_annotation(obj.get("annotation")),
        name=obj.get("name", ""),
    )


def parse_subpath(obj: dict) -> Subpath:
    conns = []
    for conn in obj.get("connection", []):
        conns.append(
            {"next": int(conn.get("next", 0) or 0), "score": int(conn.get("score", 0) or 0)}
        )
    return Subpath(
        path=parse_path(obj.get("path", {}) or {}),
        next=[int(i) for i in obj.get("next", [])],
        score=int(obj.get("score", 0) or 0),
        connections=conns,
    )


def parse_multipath_alignment(obj: dict) -> MultipathAlignment:
    return MultipathAlignment(
        sequence=obj.get("sequence", ""),
        quality=_parse_quality(obj.get("quality")),
        mapping_quality=int(_get(obj, "mapping_quality", "mappingQuality", 0) or 0),
        subpaths=[parse_subpath(s) for s in obj.get("subpath", [])],
        start=[int(i) for i in obj.get("start", [])],
        annotation=_parse_annotation(obj.get("annotation")),
        name=obj.get("name", ""),
    )
