"""The hierarchical graph summarization model  Ḡ = (S, P⁺, P⁻, H).

Supernode ids: ``0..n_leaves-1`` are leaves (subnodes); larger ids are
internal/root supernodes created by merging. The forest is stored as a parent
array; ``H`` is implicit: one h-edge per retained supernode with a retained
parent. An edge (u, v) exists in the decompressed graph iff

    #{p-edges between (ancestors(u) ∪ {u}) × (ancestors(v) ∪ {v})}
  > #{n-edges …}                                                   (Sect. II-B)

All structure/query methods run on the flat Summary IR (`core/summary_ir.py`,
DESIGN.md §5): leaf membership is one gather over DFS intervals, full
decompression is one vectorized expansion over all edges, and `neighbors`
(Algorithm 4, partial decompression) is a difference-array sweep over the
intervals of the edges incident to v's ancestor chain — no recursion
anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.summary_ir import (SummaryIR, pack_for_serving,
                                   segmented_indices)
from repro_torch.graphs.csr import Graph


@dataclass
class Summary:
    n_leaves: int
    # parent id per supernode (index = supernode id), -1 for roots.
    # Pruned supernodes have parent == -2 (tombstone) and must carry no edges.
    parent: np.ndarray
    # signed supernode edges: (k, 3) int64 rows (X, Y, sign) with sign ∈ {+1,-1};
    # X <= Y normalized; X == Y is a supernode self-loop.
    edges: np.ndarray

    _ir: SummaryIR = field(default=None, repr=False, compare=False)
    _inc_built: bool = field(default=False, repr=False, compare=False)

    # ------------------------------------------------------------------ basic
    @property
    def num_pos(self) -> int:
        return int(np.sum(self.edges[:, 2] > 0)) if self.edges.size else 0

    @property
    def num_neg(self) -> int:
        return int(np.sum(self.edges[:, 2] < 0)) if self.edges.size else 0

    @property
    def num_h(self) -> int:
        return int(np.sum(self.parent >= 0))

    def cost(self) -> int:
        """Encoding cost |P⁺| + |P⁻| + |H|   (Eq. 1)."""
        return self.num_pos + self.num_neg + self.num_h

    def relative_size(self, g: Graph) -> float:
        """Eq. (10): cost / |E|."""
        return self.cost() / max(1, g.m)

    def alive(self) -> np.ndarray:
        return np.where(self.parent > -2)[0]

    def roots(self) -> np.ndarray:
        return np.where(self.parent == -1)[0]

    # ------------------------------------------------------------- structure
    @property
    def ir(self) -> SummaryIR:
        """Flat interval view of the forest (built once, invalidated on edit)."""
        if self._ir is None:
            self._ir = SummaryIR(self.parent, self.n_leaves)
            self._inc_built = False
        return self._ir

    def _inc(self) -> SummaryIR:
        ir = self.ir
        if not self._inc_built:
            ir.build_incidence(self.edges)
            self._inc_built = True
        return ir

    def children(self, x: int):
        return self.ir.children_of(int(x)).tolist()

    def leaves(self, x: int) -> np.ndarray:
        """Subnodes contained in supernode x (DFS order) — one gather."""
        return self.ir.leaves_of(int(x))

    def depth_of_leaves(self) -> np.ndarray:
        """#ancestors per leaf (0 when the leaf is itself a root)."""
        return self.ir.depth[: self.n_leaves].copy()

    def tree_heights(self) -> list:
        """Height of each root's hierarchy tree."""
        return self.ir.tree_heights().tolist()

    def composition(self) -> dict:
        return {"pos": self.num_pos, "neg": self.num_neg, "h": self.num_h}

    # ---------------------------------------------------------- decompression
    def decompress(self) -> Graph:
        """Exact reconstruction of the input graph (full decompression).

        One pass: cross edges (X ≠ Y) expand to their interval products with
        a flat repeat/tile decomposition over ALL edges at once; self-loops
        expand per distinct supernode size through one shared triu template.
        """
        n = self.n_leaves
        ir = self.ir
        edges = self.edges
        if edges.shape[0] == 0:
            return Graph.from_edges(n, np.zeros((0, 2), dtype=np.int64))
        X, Y, S = edges[:, 0], edges[:, 1], edges[:, 2]
        keys, weights = [], []

        cross = X != Y
        if cross.any():
            cx, cy, cs = X[cross], Y[cross], S[cross]
            sx, sy = ir.size(cx), ir.size(cy)
            lens = sx * sy
            if lens.sum():
                local = segmented_indices(np.zeros_like(lens), lens)
                wid = np.repeat(sy, lens)
                i = local // wid
                j = local - i * wid
                u = ir.order[np.repeat(ir.first[cx], lens) + i]
                v = ir.order[np.repeat(ir.first[cy], lens) + j]
                lo, hi = np.minimum(u, v), np.maximum(u, v)
                keys.append(lo * n + hi)
                weights.append(np.repeat(cs, lens))

        if (~cross).any():
            lx, ls = X[~cross], S[~cross]
            sz = ir.size(lx)
            for s in np.unique(sz):
                if s < 2:
                    continue
                iu, iv = np.triu_indices(int(s), k=1)
                sel = lx[sz == s]
                base = np.repeat(ir.first[sel], iu.size)
                u = ir.order[base + np.tile(iu, sel.size)]
                v = ir.order[base + np.tile(iv, sel.size)]
                lo, hi = np.minimum(u, v), np.maximum(u, v)
                keys.append(lo * n + hi)
                weights.append(np.repeat(ls[sz == s], iu.size))

        if not keys:
            return Graph.from_edges(n, np.zeros((0, 2), dtype=np.int64))
        keys = np.concatenate(keys)
        weights = np.concatenate(weights)
        uniq, inv = np.unique(keys, return_inverse=True)
        tot = np.bincount(inv, weights=weights.astype(np.float64))
        sel = uniq[tot > 0]
        return Graph.from_edges(n, np.stack([sel // n, sel % n], axis=1))

    def neighbors(self, v: int) -> np.ndarray:
        """Partial decompression (Algorithm 4): one node's neighborhood,
        touching only the edges incident to v's ancestors.

        Each incident edge contributes a signed (start, end) event pair over
        DFS positions; one sort + prefix-sum sweep over the ≤ 2·deg events
        yields the positive-count ranges — O(deg·log(deg) + |answer|) per
        query, independent of n."""
        ir = self._inc()
        v = int(v)
        chain = [v]
        x = v
        while ir.parent[x] >= 0:
            x = int(ir.parent[x])
            chain.append(x)
        eids, seg = ir.incident_eids(np.array(chain, dtype=np.int64))
        if eids.size == 0:
            return np.zeros(0, dtype=np.int64)
        ex, ey, es = self.edges[eids, 0], self.edges[eids, 1], self.edges[eids, 2]
        mine = np.array(chain, dtype=np.int64)[seg]
        # the side whose leaves receive the count: the other endpoint, or the
        # supernode itself for self-loops (pairs within X).
        other = np.where(ex == mine, ey, ex)
        pos = np.concatenate([ir.first[other], ir.last[other]])
        val = np.concatenate([es, -es]).astype(np.int64)
        order = np.argsort(pos, kind="stable")
        pos, val = pos[order], val[order]
        cum = np.cumsum(val)
        tail = np.empty(pos.shape[0], dtype=bool)  # last event per position
        tail[-1] = True
        np.not_equal(pos[1:], pos[:-1], out=tail[:-1])
        seg_pos, seg_cnt = pos[tail], cum[tail]
        active = np.flatnonzero(seg_cnt[:-1] > 0)
        lens = seg_pos[active + 1] - seg_pos[active]
        hit = segmented_indices(seg_pos[active], lens)
        if hit.size == 0:
            return np.zeros(0, dtype=np.int64)
        hit = hit[hit != ir.pos_of[v]]
        return np.sort(ir.order[hit])

    # ------------------------------------------------------------- validation
    def validate_lossless(self, g: Graph) -> bool:
        return self.decompress() == g

    def stats(self, g: Graph) -> dict:
        heights = self.tree_heights()
        return {
            "cost": self.cost(),
            "relative_size": self.relative_size(g),
            **self.composition(),
            "max_height": int(max(heights)) if heights else 0,
            "avg_leaf_depth": float(np.mean(self.depth_of_leaves())),
            "n_supernodes": int(self.alive().shape[0]),
            "n_roots": int(self.roots().shape[0]),
        }

    def pack_for_serving(self):
        """Freeze into the immutable batched-serving artifact
        (`summary_ir.PackedSummary`; query it via `core.query_batch`)."""
        return pack_for_serving(self)

    def invalidate_caches(self):
        self._ir = None
        self._inc_built = False
