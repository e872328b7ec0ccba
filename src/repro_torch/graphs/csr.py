"""Compact CSR representation of a simple undirected graph.

This is the substrate for the SLUGGER pipeline: every engine (the host
numpy engine and the CUDA-kernel batched engine) consumes the same arrays.
"""
from __future__ import annotations

import numpy as np


class Graph:
    """Simple undirected graph in CSR form.

    Invariants:
      * no self-loops, no duplicate edges
      * symmetric: (u, v) present iff (v, u) present
      * ``indices`` sorted within each row
    """

    __slots__ = ("n", "indptr", "indices")

    def __init__(self, n: int, indptr: np.ndarray, indices: np.ndarray):
        self.n = int(n)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_edges(n: int, edges: np.ndarray) -> "Graph":
        """Build from an (m, 2) array of (possibly dirty) edges.

        Removes self-loops and duplicates, symmetrizes, sorts rows.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if edges.size:
            mask = edges[:, 0] != edges[:, 1]
            edges = edges[mask]
        if edges.size == 0:
            return Graph(n, np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int32))
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        key = lo * n + hi
        key = np.unique(key)
        lo, hi = key // n, key % n
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return Graph(n, indptr, dst.astype(np.int32))

    @staticmethod
    def from_edge_set(n: int, edge_set) -> "Graph":
        if not edge_set:
            return Graph.from_edges(n, np.zeros((0, 2), dtype=np.int64))
        return Graph.from_edges(n, np.array(sorted(edge_set), dtype=np.int64))

    # -- accessors ---------------------------------------------------------
    @property
    def m(self) -> int:
        """Number of undirected edges."""
        return int(self.indices.shape[0] // 2)

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u]:self.indptr[u + 1]]

    def edge_list(self) -> np.ndarray:
        """(m, 2) array with u < v per row."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))
        mask = src < self.indices
        return np.stack([src[mask], self.indices[mask]], axis=1)

    def edge_set(self) -> set:
        el = self.edge_list()
        return {(int(u), int(v)) for u, v in el}

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors(u)
        i = np.searchsorted(row, v)
        return bool(i < row.shape[0] and row[i] == v)

    def partitioned(self, n_parts: int = 1, owner=None):
        """This graph as shards — `Graph` is the one-partition special case
        of `PartitionedGraph` (DESIGN.md §8)."""
        from repro_torch.graphs.partitioned import PartitionedGraph
        return PartitionedGraph.from_graph(self, n_parts, owner=owner)

    def subgraph(self, nodes: np.ndarray) -> "Graph":
        """Induced subgraph with nodes relabeled 0..len(nodes)-1."""
        nodes = np.asarray(nodes, dtype=np.int64)
        relabel = -np.ones(self.n, dtype=np.int64)
        relabel[nodes] = np.arange(nodes.shape[0])
        el = self.edge_list()
        keep = (relabel[el[:, 0]] >= 0) & (relabel[el[:, 1]] >= 0)
        el = relabel[el[keep]]
        return Graph.from_edges(nodes.shape[0], el)

    def __repr__(self):
        return f"Graph(n={self.n}, m={self.m})"

    def __eq__(self, other):
        return (
            isinstance(other, Graph)
            and self.n == other.n
            and np.array_equal(self.indptr, other.indptr)
            and np.array_equal(self.indices, other.indices)
        )
