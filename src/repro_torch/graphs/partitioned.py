"""Partition-sharded graph storage (DESIGN.md §8).

A ``PartitionedGraph`` splits a simple undirected graph into per-partition
CSR *shards* keyed by node ownership: partition p stores the adjacency rows
of the nodes it owns (neighbor ids stay global). The summarization engine
(`core/engine.py`) runs its shard-local stages against these shards; the
single-partition case is exactly one shard whose CSR equals `csr.Graph` —
the monolithic graph is the ``n_parts=1`` special case, not a separate code
path.

Construction comes in two flavors:

* ``from_graph`` — slice an in-memory CSR by the ownership map (cheap:
  block ownership slices rows contiguously).
* ``from_edge_stream`` — chunked ingestion: edges arrive from any
  iterable; each chunk is cleaned, symmetrized, sorted, and split into
  per-partition *runs*; finalization merges each partition's sorted runs
  and dedupes. With ``spill_dir`` the runs live on disk between chunk and
  finalize, making peak memory O(chunk + largest partition) — graphs
  larger than RAM can be ingested; without it the run pool stays in
  memory for speed.

Ownership is any int array ``owner[node] -> partition``; the default is
balanced contiguous blocks (``block_owner``), which keeps shard rows
contiguous in node id and makes ``to_graph`` a concatenation.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.graphs.csr import Graph


def block_owner(n: int, n_parts: int) -> np.ndarray:
    """Balanced contiguous-block ownership map: node -> partition."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    return (np.arange(n, dtype=np.int64) * n_parts) // n


def _clean_stale_runs(spill_dir: str) -> int:
    """Remove spill-run files left by a crashed prior ingestion.

    Run files are namespaced ``run-<part>-<idx>.npy`` (plus ``.tmp``
    half-writes from a kill mid-write) and are consumed by the ingestion
    that wrote them — any survivor is an orphan, and letting it linger
    would at best waste disk and at worst be merged into a LATER ingestion
    sharing the spill dir. Returns the number of files removed."""
    removed = 0
    for fname in os.listdir(spill_dir):
        if fname.startswith("run-") and (fname.endswith(".npy")
                                         or fname.endswith(".npy.tmp")):
            try:
                os.remove(os.path.join(spill_dir, fname))
                removed += 1
            except OSError:  # pragma: no cover - racing cleaner is fine
                pass
    return removed


def _check_owner(owner: np.ndarray, n: int, n_parts: int) -> np.ndarray:
    """Validate an ownership map: one entry per node, values in range —
    an out-of-range owner would silently drop that node's adjacency."""
    owner = np.asarray(owner, dtype=np.int64)
    if owner.shape != (n,):
        raise ValueError(f"owner must have shape ({n},), got {owner.shape}")
    if n and (owner.min() < 0 or owner.max() >= n_parts):
        raise ValueError(
            f"owner values must be in [0, {n_parts}); got range "
            f"[{owner.min()}, {owner.max()}]")
    return owner


class GraphShard:
    """Adjacency rows of one partition's owned nodes (neighbor ids global).

    ``nodes[i]`` is the global id of local row i; ``indptr/indices`` are the
    CSR over local rows. A shard of the trivial 1-partition split is exactly
    the input graph's CSR.
    """

    __slots__ = ("part", "nodes", "indptr", "indices")

    def __init__(self, part: int, nodes: np.ndarray, indptr: np.ndarray,
                 indices: np.ndarray):
        self.part = int(part)
        self.nodes = np.asarray(nodes, dtype=np.int64)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)

    @property
    def n_local(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def n_entries(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, local_row: int) -> np.ndarray:
        return self.indices[self.indptr[local_row]:self.indptr[local_row + 1]]

    def __repr__(self):
        return (f"GraphShard(part={self.part}, rows={self.n_local}, "
                f"entries={self.n_entries})")


class PartitionedGraph:
    """A simple undirected graph stored as per-partition CSR shards."""

    __slots__ = ("n", "n_parts", "owner", "shards", "_source")

    def __init__(self, n: int, owner: np.ndarray, shards: list):
        self.n = int(n)
        self.owner = np.asarray(owner, dtype=np.int64)
        self.n_parts = len(shards)
        self.shards = shards
        self._source = None  # the Graph this was sliced from, if any

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_graph(g: Graph, n_parts: int = 1, owner=None) -> "PartitionedGraph":
        """Split an in-memory CSR into shards by the ownership map."""
        n_parts = max(1, int(n_parts))
        if owner is None:
            owner = block_owner(g.n, n_parts)
        owner = _check_owner(owner, g.n, n_parts)
        deg = np.diff(g.indptr)
        shards = []
        for p in range(n_parts):
            nodes = np.flatnonzero(owner == p)
            lens = deg[nodes]
            idx = _csr_slice_indices(g.indptr[nodes], lens)
            indptr = np.zeros(nodes.size + 1, dtype=np.int64)
            np.cumsum(lens, out=indptr[1:])
            shards.append(GraphShard(p, nodes, indptr, g.indices[idx]))
        pg = PartitionedGraph(g.n, owner, shards)
        pg._source = g  # shards are views of g; to_graph can return it as-is
        return pg

    @staticmethod
    def from_edge_stream(n: int, chunks, n_parts: int = 1, owner=None,
                         spill_dir=None) -> "PartitionedGraph":
        """Build from an iterable of (k, 2) edge chunks.

        Per chunk: drop self-loops, symmetrize into directed half-edges,
        dedupe within the chunk, and split into per-partition sorted runs
        (keyed ``src * n + dst`` — the same bounded keying `Graph.from_edges`
        uses). Finalization merges each partition's runs with one
        concatenate + unique and frees them as it goes.

        With ``spill_dir`` set, every run is written to disk as it is cut
        and loaded back only when its partition finalizes — peak memory is
        then O(one chunk + largest partition), so graphs larger than RAM can
        be ingested. The default keeps runs in memory (fast, but the run
        pool peaks at O(|E|) before finalization).
        """
        n = int(n)
        n_parts = max(1, int(n_parts))
        if owner is None:
            owner = block_owner(n, n_parts)
        owner = _check_owner(owner, n, n_parts)
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            _clean_stale_runs(spill_dir)
        runs: list = [[] for _ in range(n_parts)]
        n_runs = 0
        for chunk in chunks:
            chunk = np.asarray(chunk, dtype=np.int64).reshape(-1, 2)
            if chunk.size == 0:
                continue
            keep = chunk[:, 0] != chunk[:, 1]
            chunk = chunk[keep]
            if chunk.size == 0:
                continue
            src = np.concatenate([chunk[:, 0], chunk[:, 1]])
            dst = np.concatenate([chunk[:, 1], chunk[:, 0]])
            key = np.unique(src * np.int64(n) + dst)  # sorted run, deduped
            part = owner[key // n]
            for p in range(n_parts):
                sel = key[part == p]
                if sel.size == 0:
                    continue
                if spill_dir is not None:
                    path = os.path.join(spill_dir, f"run-{p}-{n_runs}.npy")
                    # temp + atomic rename: a kill mid-write leaves only a
                    # .tmp file, which the next ingestion sweeps away — a
                    # committed run file is always a complete .npy
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        np.save(f, sel)
                    os.replace(tmp, path)
                    runs[p].append(path)
                else:
                    runs[p].append(sel)
                n_runs += 1
        shards = []
        for p in range(n_parts):
            nodes = np.flatnonzero(owner == p)
            if runs[p]:
                loaded = [np.load(r) if isinstance(r, str) else r
                          for r in runs[p]]
                key = np.unique(np.concatenate(loaded))  # merge sorted runs
                src, dst = key // n, key % n
                if spill_dir is not None:
                    for r in runs[p]:
                        os.remove(r)
            else:
                src = dst = np.zeros(0, dtype=np.int64)
            runs[p] = None  # free (or forget) this partition's runs
            # local CSR: rows follow the shard's node order
            local_of = np.full(n, -1, dtype=np.int64)
            local_of[nodes] = np.arange(nodes.size)
            counts = np.bincount(local_of[src], minlength=nodes.size)
            indptr = np.zeros(nodes.size + 1, dtype=np.int64)
            np.cumsum(counts, out=indptr[1:])
            shards.append(GraphShard(p, nodes, indptr, dst.astype(np.int32)))
        return PartitionedGraph(n, owner, shards)

    # -- accessors ---------------------------------------------------------
    @property
    def m(self) -> int:
        """Number of undirected edges."""
        return sum(s.n_entries for s in self.shards) // 2

    def shard(self, p: int) -> GraphShard:
        return self.shards[p]

    def part_nodes(self, p: int) -> np.ndarray:
        return self.shards[p].nodes

    def to_graph(self) -> Graph:
        """Reassemble the full CSR (rows in global node-id order). When the
        shards were sliced from an in-memory Graph, that graph is returned
        directly — the ``partitions=1`` engine path then costs nothing."""
        if self._source is not None:
            return self._source
        deg = np.zeros(self.n, dtype=np.int64)
        for s in self.shards:
            deg[s.nodes] = s.degree()
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = np.zeros(int(indptr[-1]), dtype=np.int32)
        for s in self.shards:
            idx = _csr_slice_indices(indptr[s.nodes], s.degree())
            indices[idx] = s.indices
        return Graph(self.n, indptr, indices)

    def __repr__(self):
        return (f"PartitionedGraph(n={self.n}, m={self.m}, "
                f"parts={self.n_parts})")


def _csr_slice_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices for CSR row slices (concat of aranges)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    return np.repeat(starts, lens) + (
        np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens))


def as_partitioned(g, n_parts: int = 1) -> PartitionedGraph:
    """Coerce a Graph (or pass through a PartitionedGraph) to shards."""
    if isinstance(g, PartitionedGraph):
        return g
    return PartitionedGraph.from_graph(g, n_parts)
