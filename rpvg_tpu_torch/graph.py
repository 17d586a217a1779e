"""Minimal pangenome graph model.

rpvg only ever consumes node lengths from the graph
(reference/src/paths_index.cpp:33-54); topology is taken from the
haplotype path index.  We therefore model the graph as a dense
id -> length table, loadable from vg-style Graph JSON
({"node": [{"id": .., "sequence": ..}], ...}) or a plain mapping.
"""

from __future__ import annotations

import gzip
import json
from typing import Iterable, Mapping, Tuple

import numpy as np


class Graph:
    __slots__ = ("node_lengths",)

    def __init__(self, node_lengths: Mapping[int, int]):
        max_id = max(node_lengths) if node_lengths else 0
        table = np.full(max_id + 1, -1, dtype=np.int64)
        for nid, length in node_lengths.items():
            assert nid > 0, "node ids must be positive"
            assert table[nid] == -1, f"duplicate node id {nid}"
            table[nid] = length
        self.node_lengths = table

    # ------------------------------------------------------------- loaders
    @classmethod
    def from_json_obj(cls, obj: dict) -> "Graph":
        return cls(
            {
                int(node["id"]): len(node.get("sequence", ""))
                for node in obj.get("node", [])
            }
        )

    @classmethod
    def from_json_file(cls, path: str) -> "Graph":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as handle:
            return cls.from_json_obj(json.load(handle))

    @classmethod
    def from_edges(cls, nodes: Iterable[Tuple[int, int]]) -> "Graph":
        return cls(dict(nodes))

    @classmethod
    def from_xg_file(cls, path: str) -> "Graph":
        """Load node lengths from a serialized xg::XG container (bare or
        VPKG-wrapped), the reference's -g input
        (reference/src/main.cpp:616-623)."""
        from .io.xg_file import read_xg_node_lengths

        return cls(read_xg_node_lengths(path))

    def to_xg_file(self, path: str) -> None:
        """Serialize as an xg::XG container (fixture writer; inverse of
        :meth:`from_xg_file`)."""
        from .io.xg_file import write_xg

        lengths = {
            int(nid): int(self.node_lengths[nid])
            for nid in range(self.node_lengths.size)
            if self.node_lengths[nid] != -1
        }
        write_xg(path, lengths)

    # ------------------------------------------------------------- queries
    def num_nodes(self) -> int:
        return int(self.node_lengths.size)

    def has_node(self, node_id: int) -> bool:
        return 0 <= node_id < self.node_lengths.size and self.node_lengths[node_id] != -1

    def node_length(self, node_id: int) -> int:
        assert self.has_node(node_id), f"unknown node id {node_id}"
        return int(self.node_lengths[node_id])


def load_graph(path: str) -> Graph:
    """Load a graph from an xg::XG container (.xg) or vg-Graph JSON
    (optionally gzipped)."""
    if path.endswith(".xg"):
        return Graph.from_xg_file(path)
    return Graph.from_json_file(path)
