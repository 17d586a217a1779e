"""Path clustering: connected components over the haplotype panel.

Paths are connected when one fragment's alignment-path list touches both
(read-sharing edges); optionally also when they share a graph node
(node-sharing merge, used by --path-node-cluster and the transcript
collapse mode).  Re-designed around a single vectorised
connected-components sweep over the collected edge list instead of the
reference's striped-mutex adjacency sets + BFS
(reference/src/path_clusters.cpp); the emitted clustering is
identical: clusters ordered by their smallest member path id, members
sorted ascending.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from .constants import ENDMARKER
from .pathindex import PathIndex


def split_by_bounds(arr: np.ndarray, bounds: np.ndarray) -> List[np.ndarray]:
    """Views of `arr` between consecutive `bounds` (len n+1).  Same
    result as np.split(arr, bounds[1:-1]) without its per-section
    swapaxes/array_split overhead — the split runs once per cluster, so
    at ~20k clusters the constant factor is a measurable pipeline cost."""
    b = bounds.tolist()
    return [arr[b[i] : b[i + 1]] for i in range(len(b) - 1)]


def _edge_labels(u: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """Component labels over an edge list: native union-find when the
    C++ library is available (scipy's connected_components pays a full
    COO->CSR sort/dedup conversion ~10x the labelling cost at bench
    scale), scipy otherwise.  Both label arbitrarily; _rebuild
    re-labels by smallest member, so the results are identical."""
    try:
        from .native import load_library

        lib = load_library()
    except Exception:
        lib = None
    if lib is not None:
        import ctypes

        if not getattr(lib, "_union_find_configured", False):
            lib.rpvg_union_find.restype = None
            lib.rpvg_union_find.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]
            lib._union_find_configured = True
        u = np.ascontiguousarray(u, dtype=np.int64)
        v = np.ascontiguousarray(v, dtype=np.int64)
        labels = np.empty(n, dtype=np.int64)
        as_i64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
        lib.rpvg_union_find(as_i64(u), as_i64(v), u.size, n, as_i64(labels))
        return labels
    graph = coo_matrix((np.ones(u.size, dtype=np.int8), (u, v)), shape=(n, n))
    _, labels = connected_components(graph, directed=False)
    return labels


class PathClusters:
    """Connected components over path ids.

    Attributes
    ----------
    path_to_cluster: np.ndarray  (num_paths,)
    cluster_to_paths: List[np.ndarray]  sorted member ids per cluster
    """

    def __init__(self, paths_index: PathIndex, align_path_lists: Sequence) -> None:
        self.index = paths_index
        self.num_paths = paths_index.number_of_paths()

        # One star of edges per fragment: every located path id connects
        # to the first alignment path's first id (the anchor).  Native
        # entries arrive pre-located (anchor + id union) — connecting the
        # union to the anchor yields the same components as per-path
        # edges, since every edge has the anchor as one endpoint.
        edge_u: List[np.ndarray] = []
        edge_v: List[np.ndarray] = []
        locate = getattr(paths_index, "locate_cached", paths_index.locate)
        for align_paths in align_path_lists:
            if hasattr(align_paths, "anchor"):
                if align_paths.ids.size:
                    edge_u.append(
                        np.full(align_paths.ids.size, align_paths.anchor, dtype=np.int64)
                    )
                    edge_v.append(align_paths.ids)
                continue
            anchor = None
            for ap in align_paths:
                if ap.search.empty():
                    continue
                ids = locate(ap.search)
                if anchor is None:
                    anchor = int(ids[0])
                edge_u.append(np.full(ids.size, anchor, dtype=np.int64))
                edge_v.append(ids)

        self._edge_u = [np.concatenate(edge_u)] if edge_u else []
        self._edge_v = [np.concatenate(edge_v)] if edge_v else []
        self._rebuild()

    @classmethod
    def from_columnar(cls, paths_index: PathIndex, cols) -> "PathClusters":
        """Build from a native ColumnarFragments dump: the anchor/located
        id CSR yields the whole edge star list in two array ops."""
        self = cls.__new__(cls)
        self.index = paths_index
        self.num_paths = paths_index.number_of_paths()
        n_ids = np.diff(cols.id_bounds)
        if cols.all_ids.size:
            self._edge_u = [np.repeat(cols.anchors, n_ids)]
            self._edge_v = [cols.all_ids]
        else:
            self._edge_u = []
            self._edge_v = []
        self._rebuild()
        return self

    def add_node_clusters(self, paths_index: PathIndex) -> None:
        """Merge clusters whose paths share a graph node (reference
        path_clusters.cpp:85-161).

        One vectorised pass over the panel's occurrence stream instead
        of a per-graph-node find/locate loop: every (node, path)
        incidence is deduplicated and each node contributes a star from
        its smallest member path id.  For bidirectional indexes the
        orientation is collapsed on both axes (node id and sequence
        pair), exactly what per-node `locate(find(forward))` yields —
        a path visiting the node in reverse stores the forward encoding
        in its reverse-complement sequence.  Components are identical
        to the reference loop (stars are anchor-invariant)."""
        concat = paths_index.concat
        pos = np.flatnonzero(concat != ENDMARKER)
        if pos.size == 0 or self.num_paths == 0:
            self._rebuild()
            return
        nodes = concat[pos]
        seq_ids = np.searchsorted(paths_index.seq_starts, pos, side="right") - 1
        if paths_index.is_bidirectional:
            keys = nodes >> 1  # orientation-collapsed node id
            path_ids = seq_ids >> 1  # sequence pair -> path id
        else:
            keys = nodes  # one star per (node, orientation), as the loop
            path_ids = seq_ids
        order = np.lexsort((path_ids, keys))
        keys = keys[order]
        path_ids = path_ids[order]
        keep = np.empty(keys.size, dtype=bool)
        keep[0] = True
        np.logical_or(
            keys[1:] != keys[:-1], path_ids[1:] != path_ids[:-1], out=keep[1:]
        )
        keys = keys[keep]
        path_ids = path_ids[keep]
        starts = np.flatnonzero(np.diff(keys, prepend=keys[0] - 1))
        lens = np.diff(np.append(starts, keys.size))
        self._edge_u.append(np.repeat(path_ids[starts], lens))
        self._edge_v.append(path_ids)
        self._rebuild()

    def _rebuild(self) -> None:
        n = self.num_paths
        if self._edge_u:
            u = np.concatenate(self._edge_u)
            v = np.concatenate(self._edge_v)
            labels = _edge_labels(u, v, n)
        else:
            labels = np.arange(n, dtype=np.int64)

        # Re-label clusters by smallest member path id (scipy already
        # scans nodes in ascending order, but we do not rely on it).
        uniq, first = np.unique(labels, return_index=True)
        new_ids = np.empty(uniq.size, dtype=np.int64)
        new_ids[np.argsort(first, kind="stable")] = np.arange(uniq.size)
        compact = np.searchsorted(uniq, labels)
        self.path_to_cluster = new_ids[compact]

        # Stable argsort keeps member ids ascending within each cluster.
        order = np.argsort(self.path_to_cluster, kind="stable")
        sizes = np.bincount(self.path_to_cluster, minlength=uniq.size)
        self._member_order = order
        self._member_bounds = np.zeros(sizes.size + 1, dtype=np.int64)
        np.cumsum(sizes, out=self._member_bounds[1:])
        self.cluster_to_paths = split_by_bounds(order, self._member_bounds)

    def members_concat(self, cluster_order: Sequence[int]):
        """Member path ids of the given clusters concatenated in that
        cluster order, plus per-cluster offsets — one vectorised ranges
        gather over the argsort base (equivalent to concatenating
        cluster_to_paths[ci] per ci, without 1 array per cluster)."""
        cluster_order = np.asarray(cluster_order, dtype=np.int64)
        starts = self._member_bounds[cluster_order]
        lens = self._member_bounds[cluster_order + 1] - starts
        offsets = np.zeros(cluster_order.size + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        if offsets[-1] == 0:
            return np.empty(0, dtype=np.int64), offsets
        idx = np.arange(offsets[-1], dtype=np.int64)
        idx += np.repeat(starts - offsets[:-1], lens)
        return self._member_order[idx], offsets

    def num_clusters(self) -> int:
        return len(self.cluster_to_paths)
