"""Flat Summary IR: Euler-tour/DFS-interval view of a merge forest.

Every post-merge stage (encoding emission, pruning, partial/full
decompression) used to walk the forest through recursive ``TreeView`` builds
or dict-of-set adjacency. The IR replaces those with five int64 arrays plus
two CSR indexes, built level-synchronously in O(height) vectorized passes:

  ``first[x] : last[x]``  half-open interval of x's leaves in global DFS order
  ``depth[x]``            #ancestors of x (roots are 0; dead ids are -1)
  ``parent[x]``           forest parent (-1 root, -2 pruned tombstone)
  ``order[p]``            leaf id at DFS position p  (``pos_of`` inverts it)
  ``child_ptr/child_ids`` CSR children, siblings ordered by id == by ``first``
  ``inc_ptr/inc_eid``     CSR signed-edge incidence (built per edge array)

Leaf membership of any supernode is the single gather
``order[first[x]:last[x]]``; ancestor tests are interval containment; subtree
aggregates are ``reduceat`` over root intervals. DESIGN.md §5.

Construction relies on the forest invariant ``parent[x] > x`` for every
alive non-root (merges always mint fresh, larger parent ids and pruning only
splices, which preserves the property); the constructor asserts it.
"""
from __future__ import annotations

import numpy as np


def segmented_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices for CSR slices: ``concat(arange(s, s+l))``.

    The one CSR-expansion idiom every IR consumer shares — one np.repeat of
    the slice starts plus a per-segment local offset."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    return np.repeat(starts, lens) + (
        np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
    )


def canon_edges(arr: np.ndarray) -> np.ndarray:
    """Canonical (lo, hi, sign) lexicographic row order. Edge row order is
    not semantically meaningful, so every emitter/pruner exports this order
    and equivalence tests can compare arrays bit-for-bit."""
    arr = np.asarray(arr, dtype=np.int64).reshape(-1, 3)
    if arr.shape[0] == 0:
        return np.zeros((0, 3), dtype=np.int64)
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    arr = np.stack([lo, hi, arr[:, 2]], axis=1)
    return arr[np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))]


def group_pairs(a: np.ndarray, b: np.ndarray):
    """Group index pairs without forming a combined integer key.

    Returns ``(order, starts)``: ``order`` sorts the pairs lexicographically
    by (a, b) and ``starts`` marks the first element of each distinct pair in
    the sorted view (append ``len`` for bounds). Unlike the
    ``a * (max(b)+1) + b`` keying this cannot overflow int64 for any id range
    — the same reason ``SluggerState.gather_rows`` keys with a bounded
    multiplier; here we drop the multiplier entirely and split on the sorted
    component diffs instead.
    """
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    order = np.lexsort((b, a))
    if a.size == 0:
        return order, np.zeros(0, dtype=np.int64)
    sa, sb = a[order], b[order]
    head = np.empty(a.size, dtype=bool)
    head[0] = True
    np.not_equal(sa[1:], sa[:-1], out=head[1:])
    head[1:] |= sb[1:] != sb[:-1]
    return order, np.flatnonzero(head)


class SummaryIR:
    """Flat interval representation of one merge forest."""

    __slots__ = (
        "n_leaves", "n_ids", "parent", "alive", "depth", "first", "last",
        "order", "pos_of", "child_ptr", "child_ids", "roots", "levels",
        "inc_ptr", "inc_eid",
    )

    def __init__(self, parent: np.ndarray, n_leaves: int):
        parent = np.asarray(parent, dtype=np.int64)
        n_ids = parent.shape[0]
        self.n_leaves = int(n_leaves)
        self.n_ids = n_ids
        self.parent = parent
        self.alive = parent > -2
        ids = np.arange(n_ids, dtype=np.int64)
        has_par = self.alive & (parent >= 0)
        if has_par.any() and not (parent[has_par] > ids[has_par]).all():
            raise ValueError("SummaryIR requires parent[x] > x (merge-forest order)")

        # children CSR: stable sort by parent keeps siblings id-ascending,
        # which below becomes first-ascending as intervals are dealt in order.
        kids = ids[has_par]
        kpar = parent[kids]
        k_order = np.argsort(kpar, kind="stable")
        self.child_ids = kids[k_order]
        counts = np.bincount(kpar, minlength=n_ids)
        self.child_ptr = np.zeros(n_ids + 1, dtype=np.int64)
        np.cumsum(counts, out=self.child_ptr[1:])

        self.roots = ids[self.alive & (parent == -1)]
        depth = np.full(n_ids, -1, dtype=np.int64)
        depth[self.roots] = 0
        # level-synchronous BFS: each pass gathers the children of the whole
        # frontier through the CSR in one repeat/arange indexing op.
        levels = [self.roots]
        frontier = self.roots
        while True:
            lens = self.child_ptr[frontier + 1] - self.child_ptr[frontier]
            idx = segmented_indices(self.child_ptr[frontier], lens)
            if idx.size == 0:
                break
            nxt = self.child_ids[idx]
            depth[nxt] = depth[np.repeat(frontier, lens)] + 1
            levels.append(nxt)
            frontier = nxt
        self.depth = depth
        self.levels = levels

        # subtree leaf counts, bottom-up one level at a time (duplicate
        # parents within a level are why this is add.at and not plain fancy
        # assignment).
        nleaf = np.zeros(n_ids, dtype=np.int64)
        nleaf[: self.n_leaves][self.alive[: self.n_leaves]] = 1
        for lvl in levels[:0:-1]:
            np.add.at(nleaf, parent[lvl], nleaf[lvl])

        # DFS intervals, top-down: roots get consecutive blocks in id order;
        # each child starts at its parent's start plus the leaf mass of its
        # earlier siblings (an exclusive segment prefix-sum).
        first = np.full(n_ids, -1, dtype=np.int64)
        csum = np.cumsum(nleaf[self.roots])
        first[self.roots] = csum - nleaf[self.roots]
        for lvl in levels[:-1]:
            lens = self.child_ptr[lvl + 1] - self.child_ptr[lvl]
            par_l = lvl[lens > 0]
            lens = lens[lens > 0]
            total = int(lens.sum())
            if total == 0:
                continue
            ends = np.cumsum(lens)
            idx = segmented_indices(self.child_ptr[par_l], lens)
            kids_l = self.child_ids[idx]
            pref = np.cumsum(nleaf[kids_l]) - nleaf[kids_l]
            seg_base = np.repeat(pref[ends - lens], lens)
            first[kids_l] = np.repeat(first[par_l], lens) + (pref - seg_base)
        self.first = first
        self.last = first + nleaf

        leaves = np.arange(self.n_leaves, dtype=np.int64)
        self.pos_of = first[: self.n_leaves].copy()
        order = np.empty(self.n_leaves, dtype=np.int64)
        if self.n_leaves:
            order[self.pos_of] = leaves
        self.order = order
        self.inc_ptr = None
        self.inc_eid = None

    # ------------------------------------------------------------- accessors
    def size(self, x) -> np.ndarray:
        return self.last[x] - self.first[x]

    def leaves_of(self, x: int) -> np.ndarray:
        """Leaf ids contained in supernode x (DFS order) — one gather."""
        return self.order[self.first[x]: self.last[x]]

    def children_of(self, x: int) -> np.ndarray:
        return self.child_ids[self.child_ptr[x]: self.child_ptr[x + 1]]

    def n_children(self) -> np.ndarray:
        return self.child_ptr[1:] - self.child_ptr[:-1]

    def max_children(self) -> int:
        return int(self.n_children().max()) if self.n_ids else 0

    def tree_heights(self) -> np.ndarray:
        """Height of each root's tree = max leaf depth inside its interval."""
        if self.roots.size == 0:
            return np.zeros(0, dtype=np.int64)
        leaf_depth = self.depth[self.order]  # depth per DFS position
        starts = self.first[self.roots]
        nonempty = self.last[self.roots] > starts
        out = np.zeros(self.roots.size, dtype=np.int64)
        if nonempty.any():
            out[nonempty] = np.maximum.reduceat(leaf_depth, starts[nonempty])
        return out

    # ------------------------------------------------------------- incidence
    def build_incidence(self, edges: np.ndarray):
        """CSR incidence for a (k, 3) signed edge array; self-loops once."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 3)
        k = edges.shape[0]
        if k == 0:
            self.inc_ptr = np.zeros(self.n_ids + 1, dtype=np.int64)
            self.inc_eid = np.zeros(0, dtype=np.int64)
            return
        nonloop = edges[:, 0] != edges[:, 1]
        ends = np.concatenate([edges[:, 0], edges[nonloop, 1]])
        eids = np.concatenate([
            np.arange(k, dtype=np.int64),
            np.flatnonzero(nonloop),
        ])
        order = np.argsort(ends, kind="stable")
        self.inc_eid = eids[order]
        counts = np.bincount(ends, minlength=self.n_ids)
        self.inc_ptr = np.zeros(self.n_ids + 1, dtype=np.int64)
        np.cumsum(counts, out=self.inc_ptr[1:])

    def incident_eids(self, xs: np.ndarray) -> tuple:
        """Concatenated incident edge ids of ``xs`` plus a segment index."""
        xs = np.asarray(xs, dtype=np.int64)
        lens = self.inc_ptr[xs + 1] - self.inc_ptr[xs]
        idx = segmented_indices(self.inc_ptr[xs], lens)
        if idx.size == 0:
            return idx, idx
        seg = np.repeat(np.arange(xs.size, dtype=np.int64), lens)
        return self.inc_eid[idx], seg


# ---------------------------------------------------------------------------
# Frozen serving artifact
# ---------------------------------------------------------------------------
def pack_sign_bits(sign: np.ndarray) -> np.ndarray:
    """(k,) ±1 signs -> bit-packed uint32 words (bit set = positive)."""
    sign = np.asarray(sign, dtype=np.int64)
    bits = np.zeros((sign.size + 31) // 32, dtype=np.uint32)
    pos = np.flatnonzero(sign > 0)
    if pos.size:
        np.bitwise_or.at(bits, pos >> 5, np.uint32(1) << (pos & 31).astype(np.uint32))
    return bits


def unpack_sign_bits(bits: np.ndarray, k: int) -> np.ndarray:
    """Inverse of `pack_sign_bits`: uint32 words -> (k,) int64 ±1 signs."""
    e = np.arange(k, dtype=np.int64)
    hit = (bits[e >> 5] >> (e & 31).astype(np.uint32)) & np.uint32(1)
    return np.where(hit.astype(bool), 1, -1).astype(np.int64)


class PackedSummary:
    """Frozen, device-ready serving artifact of one (pruned) summary.

    The mutable `Summary` answers one query at a time through lazily built
    caches; serving wants an immutable blob of flat arrays that batched
    query backends can gather from without touching the forest again. The
    ``.npz`` format is the JAX package's, so either package loads an
    artifact the other wrote. Serialized state (``save``/``load``,
    compact ``.npz``):

      ``parent/first/last``   interval table per supernode id (int32)
      ``order``               leaf id per global DFS position (int32)
      ``inc_ptr/inc_eid``     CSR signed-edge incidence per supernode
      ``edge_x/edge_y``       edge endpoints (int32)
      ``sign_bits``           1 bit per edge (set = p-edge), uint32-packed

    Everything else is derived on construction: ``pos_of`` inverts ``order``;
    ``inc_lo/inc_hi/inc_sign`` pre-resolve, for every incidence entry, the
    *other* endpoint's DFS interval and the edge sign, so a query never
    chases ``edge_x/edge_y`` indirection at serve time; ``max_depth`` bounds
    the ancestor-chain climb. DESIGN.md §7.
    """

    __slots__ = (
        "n_leaves", "n_ids", "parent", "first", "last", "order",
        "inc_ptr", "inc_eid", "edge_x", "edge_y", "sign_bits",
        "pos_of", "inc_lo", "inc_hi", "inc_sign", "max_depth",
    )

    def __init__(self, n_leaves: int, parent, first, last, order,
                 inc_ptr, inc_eid, edge_x, edge_y, sign_bits):
        self.n_leaves = int(n_leaves)
        self.n_ids = int(np.asarray(parent).shape[0])
        self.parent = np.asarray(parent, dtype=np.int32)
        self.first = np.asarray(first, dtype=np.int32)
        self.last = np.asarray(last, dtype=np.int32)
        self.order = np.asarray(order, dtype=np.int32)
        self.inc_ptr = np.asarray(inc_ptr, dtype=np.int64)
        self.inc_eid = np.asarray(inc_eid, dtype=np.int32)
        self.edge_x = np.asarray(edge_x, dtype=np.int32)
        self.edge_y = np.asarray(edge_y, dtype=np.int32)
        self.sign_bits = np.asarray(sign_bits, dtype=np.uint32)
        self._derive()

    @property
    def n_edges(self) -> int:
        return int(self.edge_x.shape[0])

    def _derive(self):
        self.pos_of = self.first[: self.n_leaves].astype(np.int64)
        sign = unpack_sign_bits(self.sign_bits, self.n_edges)
        # per incidence entry: owning node, then the other endpoint's interval
        node = np.repeat(np.arange(self.n_ids, dtype=np.int64),
                         np.diff(self.inc_ptr))
        eid = self.inc_eid.astype(np.int64)
        ex, ey = self.edge_x[eid].astype(np.int64), self.edge_y[eid].astype(np.int64)
        other = np.where(ex == node, ey, ex)
        self.inc_lo = self.first[other].astype(np.int64)
        self.inc_hi = self.last[other].astype(np.int64)
        self.inc_sign = sign[eid]
        # deepest leaf chain, by climbing all leaves level-synchronously
        depth = 0
        cur = self.parent[: self.n_leaves].astype(np.int64)
        cur = cur[cur >= 0]
        while cur.size:
            depth += 1
            cur = self.parent[cur].astype(np.int64)
            cur = cur[cur >= 0]
        self.max_depth = depth

    # ------------------------------------------------------------------- io
    @staticmethod
    def _npz_path(path: str) -> str:
        # savez_compressed appends ".npz" to suffix-less paths; normalize in
        # BOTH directions so save(p) and load(p) always name the same file
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> str:
        path = self._npz_path(path)
        np.savez_compressed(
            path, n_leaves=np.int64(self.n_leaves), parent=self.parent,
            first=self.first, last=self.last, order=self.order,
            inc_ptr=self.inc_ptr, inc_eid=self.inc_eid,
            edge_x=self.edge_x, edge_y=self.edge_y, sign_bits=self.sign_bits,
            n_edges=np.int64(self.n_edges))
        return path

    @classmethod
    def load(cls, path: str) -> "PackedSummary":
        with np.load(cls._npz_path(path)) as d:
            return cls(int(d["n_leaves"]), d["parent"], d["first"], d["last"],
                       d["order"], d["inc_ptr"], d["inc_eid"],
                       d["edge_x"], d["edge_y"], d["sign_bits"])

    def nbytes(self) -> int:
        """Serialized payload size (uncompressed array bytes)."""
        return sum(getattr(self, f).nbytes for f in (
            "parent", "first", "last", "order", "inc_ptr", "inc_eid",
            "edge_x", "edge_y", "sign_bits"))


def pack_for_serving(summary) -> PackedSummary:
    """Freeze a (pruned) `Summary` into the immutable serving artifact.

    Accepts any object with ``n_leaves``/``parent``/``edges`` — the
    `Summary` dataclass itself — without importing it (core.summary already
    imports this module)."""
    parent = np.asarray(summary.parent, dtype=np.int64)
    n = int(summary.n_leaves)
    if parent.shape[0] >= np.iinfo(np.int32).max:
        raise ValueError("packed artifact uses int32 ids; summary too large")
    edges = np.asarray(summary.edges, dtype=np.int64).reshape(-1, 3)
    ir = SummaryIR(parent, n)
    ir.build_incidence(edges)
    return PackedSummary(
        n, parent, ir.first, ir.last, ir.order, ir.inc_ptr, ir.inc_eid,
        edges[:, 0], edges[:, 1], pack_sign_bits(edges[:, 2]))
