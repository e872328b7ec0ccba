"""Optimal pairwise hierarchical encoding (recursive dynamic program).

Role in the system: the paper updates p/n-edges *locally* during each merger,
exhaustively searching encodings over ≤10 supernodes with a memoized pattern
table (Sect. III-B3). We implement the same search as an exact DP over the two
hierarchy trees of a root pair, which (a) contains the paper's option space,
(b) contains the flat model's option space (descend to leaves), and (c) runs
in O(points · depth) with full/empty shortcuts. Per-(X,Y,parity) memoization
plays the role of the paper's lookup table.

This module is the SEMANTICS REFERENCE: production emission runs the batched
level-synchronous form of the same DP over the flat Summary IR
(`core/encode_batched.py`, DESIGN.md §5.2), which must reproduce this
recursion's edge output bit for bit (test-enforced). The recursion remains
the `backend="loop"` path and the fallback for non-binary forests.

Semantics: ``parity`` is the p−n balance contributed by edges placed at
strict-ancestor pairs. At a pair (X, Y) with parity c we may either descend
(children pairs inherit c), or place one edge — a p-edge if c == 0, an n-edge
if c == 1 (the paper's validity restriction p−n ∈ {0,1} for every subnode
pair holds by construction) — after which descendants see parity 1−c.

    enc(X, Y, 0) = 0                       if E_XY empty
                 = min(1 + D(X,Y,1), D(X,Y,0))   otherwise
    enc(X, Y, 1) = 0                       if E_XY complete
                 = min(1 + D(X,Y,0), D(X,Y,1))   otherwise
    D(X, Y, c)   = Σ_{children pairs} enc(x_i, y_j, c)   (∞ at leaf pairs)

Ties prefer descending: edges land as deep as possible, which lets the pruning
pass remove hierarchy nodes that carry no edges (maximizing |H| savings).
"""
from __future__ import annotations

import numpy as np

INF = float("inf")


class TreeView:
    """A root's hierarchy tree with contiguous DFS leaf intervals per node."""

    __slots__ = ("root_gid", "gid", "lo", "hi", "kids", "n_leaves")

    def __init__(self, root_gid: int, children: dict, n_graph_leaves: int):
        self.root_gid = int(root_gid)
        self.gid: list[int] = []
        self.lo: list[int] = []
        self.hi: list[int] = []
        self.kids: list[list[int]] = []
        counter = [0]

        def build(g: int) -> int:
            my = len(self.gid)
            self.gid.append(int(g))
            self.lo.append(0)
            self.hi.append(0)
            self.kids.append([])
            ch = children.get(int(g), []) if g >= n_graph_leaves else []
            if not ch:
                self.lo[my] = counter[0]
                counter[0] += 1
                self.hi[my] = counter[0]
            else:
                self.lo[my] = counter[0]
                for c in ch:
                    self.kids[my].append(build(c))
                self.hi[my] = counter[0]
            return my

        build(root_gid)
        self.n_leaves = counter[0]

    def size(self, x: int) -> int:
        return self.hi[x] - self.lo[x]

    def leaf_order(self, children: dict, n_graph_leaves: int) -> np.ndarray:
        """Global leaf ids in this tree's DFS order."""
        out = []

        def walk(g):
            ch = children.get(int(g), []) if g >= n_graph_leaves else []
            if not ch:
                out.append(int(g))
            else:
                for c in ch:
                    walk(c)

        walk(self.root_gid)
        return np.array(out, dtype=np.int64)


def _split_by_children(tv: TreeView, x: int, pos: np.ndarray) -> np.ndarray:
    """Child-bucket index of each position under node x."""
    bounds = np.array([tv.lo[k] for k in tv.kids[x]], dtype=np.int64)
    return np.searchsorted(bounds, pos, side="right") - 1


def encode_pair(tvA: TreeView, tvB: TreeView, pa: np.ndarray, pb: np.ndarray):
    """Minimal encoding of the bipartite subedges between two root trees.

    ``pa[k], pb[k]``: leaf positions (in each tree's DFS order) of subedge k.
    Returns (cost, edges) with edges = [(gidA, gidB, sign), ...].
    """
    memo: dict = {}

    def enc(x: int, y: int, par: int, pa, pb):
        key = (x, y, par)
        hit = memo.get(key)
        if hit is not None:
            return hit
        cnt = pa.shape[0]
        poss = tvA.size(x) * tvB.size(y)
        if par == 0 and cnt == 0:
            res = (0, [])
        elif par == 1 and cnt == poss:
            res = (0, [])
        else:
            c_desc, e_desc = _descend(x, y, par, pa, pb)
            c_flip, e_flip = _descend(x, y, 1 - par, pa, pb)
            sign = 1 if par == 0 else -1
            placed = 1 + c_flip
            if c_desc <= placed:
                res = (c_desc, e_desc)
            else:
                res = (placed, [(tvA.gid[x], tvB.gid[y], sign)] + e_flip)
        memo[key] = res
        return res

    def _descend(x: int, y: int, par: int, pa, pb):
        kx, ky = tvA.kids[x], tvB.kids[y]
        if not kx and not ky:  # leaf-leaf: direct cost
            cnt = pa.shape[0]
            ok = (par == 1 and cnt == 1) or (par == 0 and cnt == 0)
            if ok:
                return 0, []
            sign = 1 if par == 0 else -1
            return 1, [(tvA.gid[x], tvB.gid[y], sign)]
        if kx and ky:
            ca = _split_by_children(tvA, x, pa)
            cb = _split_by_children(tvB, y, pb)
            total, edges = 0, []
            for i, xi in enumerate(kx):
                mi = ca == i
                for j, yj in enumerate(ky):
                    m = mi & (cb == j)
                    c, e = enc(xi, yj, par, pa[m], pb[m])
                    if c == INF:
                        return INF, []
                    total += c
                    edges += e
            return total, edges
        if kx:
            ca = _split_by_children(tvA, x, pa)
            total, edges = 0, []
            for i, xi in enumerate(kx):
                m = ca == i
                c, e = enc(xi, y, par, pa[m], pb[m])
                total += c
                edges += e
            return total, edges
        cb = _split_by_children(tvB, y, pb)
        total, edges = 0, []
        for j, yj in enumerate(ky):
            m = cb == j
            c, e = enc(x, yj, par, pa[m], pb[m])
            total += c
            edges += e
        return total, edges

    # shortcut for empty pairs handled inside enc
    return enc(0, 0, 0, np.asarray(pa, dtype=np.int64), np.asarray(pb, dtype=np.int64))


def encode_self(tv: TreeView, pu: np.ndarray, pv: np.ndarray):
    """Minimal encoding of the subedges *within* one root tree.

    ``pu[k] < pv[k]``: positions of subedge k's endpoints in DFS order.
    """
    memo_self: dict = {}
    memo_cross: dict = {}

    def enc_cross(x: int, y: int, par: int, pa, pb):
        key = (x, y, par)
        hit = memo_cross.get(key)
        if hit is not None:
            return hit
        cnt = pa.shape[0]
        poss = tv.size(x) * tv.size(y)
        if par == 0 and cnt == 0:
            res = (0, [])
        elif par == 1 and cnt == poss:
            res = (0, [])
        else:
            c_desc, e_desc = _descend_cross(x, y, par, pa, pb)
            c_flip, e_flip = _descend_cross(x, y, 1 - par, pa, pb)
            sign = 1 if par == 0 else -1
            placed = 1 + c_flip
            if c_desc <= placed:
                res = (c_desc, e_desc)
            else:
                res = (placed, [(tv.gid[x], tv.gid[y], sign)] + e_flip)
        memo_cross[key] = res
        return res

    def _descend_cross(x: int, y: int, par: int, pa, pb):
        kx, ky = tv.kids[x], tv.kids[y]
        if not kx and not ky:
            cnt = pa.shape[0]
            ok = (par == 1 and cnt == 1) or (par == 0 and cnt == 0)
            if ok:
                return 0, []
            sign = 1 if par == 0 else -1
            return 1, [(tv.gid[x], tv.gid[y], sign)]
        if kx and ky:
            ca = _split_by_children(tv, x, pa)
            cb = _split_by_children(tv, y, pb)
            total, edges = 0, []
            for i, xi in enumerate(kx):
                mi = ca == i
                for j, yj in enumerate(ky):
                    m = mi & (cb == j)
                    c, e = enc_cross(xi, yj, par, pa[m], pb[m])
                    total += c
                    edges += e
            return total, edges
        if kx:
            ca = _split_by_children(tv, x, pa)
            total, edges = 0, []
            for i, xi in enumerate(kx):
                m = ca == i
                c, e = enc_cross(xi, y, par, pa[m], pb[m])
                total += c
                edges += e
            return total, edges
        cb = _split_by_children(tv, y, pb)
        total, edges = 0, []
        for j, yj in enumerate(ky):
            m = cb == j
            c, e = enc_cross(x, yj, par, pa[m], pb[m])
            total += c
            edges += e
        return total, edges

    def enc_self(x: int, par: int, pu, pv):
        key = (x, par)
        hit = memo_self.get(key)
        if hit is not None:
            return hit
        s = tv.size(x)
        poss = s * (s - 1) // 2
        cnt = pu.shape[0]
        if poss == 0:
            res = (0, [])
        elif par == 0 and cnt == 0:
            res = (0, [])
        elif par == 1 and cnt == poss:
            res = (0, [])
        else:
            c_desc, e_desc = _descend_self(x, par, pu, pv)
            c_flip, e_flip = _descend_self(x, 1 - par, pu, pv)
            sign = 1 if par == 0 else -1
            placed = 1 + c_flip
            if c_desc <= placed:
                res = (c_desc, e_desc)
            else:
                res = (placed, [(tv.gid[x], tv.gid[x], sign)] + e_flip)
        memo_self[key] = res
        return res

    def _descend_self(x: int, par: int, pu, pv):
        kx = tv.kids[x]
        if not kx:  # single leaf: poss == 0, nothing to encode
            return 0, []
        cu = _split_by_children(tv, x, pu)
        cv = _split_by_children(tv, x, pv)
        total, edges = 0, []
        for i, xi in enumerate(kx):
            m = (cu == i) & (cv == i)
            c, e = enc_self(xi, par, pu[m], pv[m])
            total += c
            edges += e
            for j in range(i + 1, len(kx)):
                mc = (cu == i) & (cv == j)
                c, e = enc_cross(xi, kx[j], par, pu[mc], pv[mc])
                total += c
                edges += e
        return total, edges

    return enc_self(0, 0, np.asarray(pu, dtype=np.int64), np.asarray(pv, dtype=np.int64))


def flat_pair_cost(cnt: int, sa: int, sb: int) -> int:
    """Flat (previous-model) cost of a root pair: either leaf corrections only
    (cnt) or one p-edge plus negative corrections (poss − cnt + 1)."""
    if cnt == 0:
        return 0
    poss = sa * sb
    return min(cnt, poss - cnt + 1)


def flat_self_cost(cnt: int, s: int) -> int:
    """`flat_pair_cost` of a root with itself: its s·(s − 1)/2 leaf pairs."""
    if cnt == 0:
        return 0
    poss = s * (s - 1) // 2
    return min(cnt, poss - cnt + 1)
