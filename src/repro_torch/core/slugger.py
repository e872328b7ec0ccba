"""SLUGGER (Algorithm 1): scalable lossless hierarchical graph summarization.

Pipeline, exactly as the paper's:
  1. initialize Ḡ = G (singleton supernodes, P⁺ = E)
  2. T iterations of {candidate generation → in-group greedy merging with the
     decaying threshold θ(t) = 1/(1+t), θ(T) = 0}
  3. encoding emission (the paper maintains encodings incrementally with the
     memoized ≤10-supernode local search; we defer to the exact per-pair DP —
     see DESIGN.md §2.1: same model, search space a superset of the paper's,
     so per-pair cost is never worse given the same merge forest)
  4. pruning (three substeps, Sect. III-B4)

Losslessness is structural: the emission DP re-encodes the *input* edges
exactly, so any merge forest — however heuristic — yields an exact summary.

Merging runs on one of four engines selected by ``backend=`` (DESIGN.md
§3, §9):
  * ``"batched"`` — batched group-merge engine ranking partners with the
    CUDA bitset-intersection kernel over size-bucketed ``(B, G, W)`` bitmap
    batches, and counting the emission DP's state membership with the CUDA
    segment-histogram kernel (default)
  * ``"resident"`` — the same engine with each chunk's whole merge-round
    state resident on the card: the CUDA top-J ranking and bitset-fold
    kernels, exact Saving and θ̂ on the device, the adjacency bank and the
    root shingles carried there across iterations; host emission counts
  * ``"numpy"``  — the same engine with NumPy popcount ranking and host
    histograms; bit-identical to ``"batched"`` and ``"resident"``
  * ``"loop"``   — the per-group sequential loop (semantics reference)
"""
from __future__ import annotations

import logging
import sys

import numpy as np

from repro_torch.core import encode_dp
from repro_torch.core.encode_batched import encode_forest, forest_is_binary
from repro_torch.core.summary import Summary
from repro_torch.core.summary_ir import SummaryIR, canon_edges
from repro_torch.graphs.csr import Graph


class SluggerState:
    """Merge forest + root-level subedge counts in flat-array storage.

    Adjacency lives in an append-only arena (``arena_ids``/``arena_cnt``) with
    one ``(row_ptr, row_len)`` slot per supernode id — CSR rows seed the arena
    directly. Neighbor ids stored in a row may be stale (merged away); reads
    resolve them through the ``forward`` pointer array (with path compression
    and in-place row compaction), so a merge costs O(deg(A)+deg(B)) array work
    and never touches the rows of the merged node's neighbors (DESIGN.md §4).
    """

    def __init__(self, g: Graph):
        n = g.n
        self.g = g
        cap = 2 * n + 8
        self.parent = np.full(cap, -1, dtype=np.int64)
        self.size = np.ones(cap, dtype=np.int64)
        self.height = np.zeros(cap, dtype=np.int64)
        self.ndesc = np.zeros(cap, dtype=np.int64)
        self.selfcnt = np.zeros(cap, dtype=np.int64)
        self.forward = np.arange(cap, dtype=np.int64)
        self.alive_mask = np.zeros(cap, dtype=bool)
        self.alive_mask[:n] = True
        self.n_ids = n
        self.children: dict = {}
        acap = max(2 * int(g.indices.size) + 16, 64)
        self.arena_ids = np.zeros(acap, dtype=np.int64)
        self.arena_cnt = np.zeros(acap, dtype=np.int64)
        self.arena_ids[: g.indices.size] = g.indices
        self.arena_cnt[: g.indices.size] = 1
        self.arena_top = int(g.indices.size)
        self.row_ptr = np.zeros(cap, dtype=np.int64)
        self.row_ptr[:n] = g.indptr[:-1]
        self.row_len = np.zeros(cap, dtype=np.int64)
        self.row_len[:n] = np.diff(g.indptr)
        self._root_cache: np.ndarray | None = None

    # -- id/arena growth ---------------------------------------------------
    def _ensure_ids(self, need: int):
        cap = self.parent.shape[0]
        if need <= cap:
            return
        new = max(2 * cap, need)
        for name in ("parent", "size", "height", "ndesc", "selfcnt",
                     "row_ptr", "row_len"):
            old = getattr(self, name)
            arr = np.zeros(new, dtype=old.dtype)
            arr[:cap] = old
            setattr(self, name, arr)
        self.parent[cap:] = -1
        self.size[cap:] = 1
        fwd = np.arange(new, dtype=np.int64)
        fwd[:cap] = self.forward
        self.forward = fwd
        am = np.zeros(new, dtype=bool)
        am[:cap] = self.alive_mask
        self.alive_mask = am

    def _ensure_arena(self, extra: int):
        if self.arena_top + extra <= self.arena_ids.shape[0]:
            return
        new = max(2 * self.arena_ids.shape[0], self.arena_top + extra)
        for name in ("arena_ids", "arena_cnt"):
            old = getattr(self, name)
            arr = np.zeros(new, dtype=np.int64)
            arr[: self.arena_top] = old[: self.arena_top]
            setattr(self, name, arr)

    def _append_row(self, i: int, ids: np.ndarray, cnts: np.ndarray):
        k = ids.shape[0]
        self._ensure_arena(k)
        self.row_ptr[i] = self.arena_top
        self.row_len[i] = k
        self.arena_ids[self.arena_top : self.arena_top + k] = ids
        self.arena_cnt[self.arena_top : self.arena_top + k] = cnts
        self.arena_top += k

    # -- resolution --------------------------------------------------------
    def resolve(self, ids: np.ndarray) -> np.ndarray:
        """Map (possibly stale) supernode ids to their current alive roots."""
        orig = np.asarray(ids, dtype=np.int64)
        out = orig
        while True:
            nxt = self.forward[out]
            if np.array_equal(nxt, out):
                break
            out = nxt
        if out is not orig:
            self.forward[orig] = out  # path compression
        return out

    @property
    def root_of(self) -> np.ndarray:
        """Current root of every leaf (recomputed lazily after merges)."""
        if self._root_cache is None:
            self._root_cache = self.resolve(np.arange(self.g.n, dtype=np.int64))
        return self._root_cache

    @property
    def alive(self) -> np.ndarray:
        return np.flatnonzero(self.alive_mask[: self.n_ids])

    def root_min_leaf(self) -> np.ndarray:
        """Smallest leaf id owned by each root (n for leafless ids) — THE
        partition key of a root (DESIGN.md §8.1). The engine's group
        assignment and the partition-aware emission both key through this
        one method so their bucketing can never drift apart."""
        ml = np.full(self.n_ids, self.g.n, dtype=np.int64)
        np.minimum.at(ml, self.root_of, np.arange(self.g.n, dtype=np.int64))
        return ml

    # -- adjacency reads ---------------------------------------------------
    def gather_rows(self, roots: np.ndarray):
        """Resolved, per-root-aggregated adjacency of distinct ``roots``.

        Returns ``(seg, nbr, cnt)``: concatenated row entries with ``seg``
        indexing into ``roots``. As a side effect the touched rows are
        compacted in place (stale duplicates folded, shrinking ``row_len``).
        """
        roots = np.asarray(roots, dtype=np.int64)
        lens = self.row_len[roots]
        total = int(lens.sum())
        empty = np.zeros(0, dtype=np.int64)
        if total == 0:
            return empty, empty, empty
        starts = self.row_ptr[roots]
        ends = np.cumsum(lens)
        off = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
        idx = np.repeat(starts, lens) + off
        seg = np.repeat(np.arange(roots.size, dtype=np.int64), lens)
        nbr = self.resolve(self.arena_ids[idx])
        cnt = self.arena_cnt[idx]
        key = seg * np.int64(self.n_ids + 1) + nbr
        order = np.argsort(key, kind="stable")
        key, nbr, cnt, seg = key[order], nbr[order], cnt[order], seg[order]
        head = np.empty(key.size, dtype=bool)
        head[0] = True
        np.not_equal(key[1:], key[:-1], out=head[1:])
        starts_u = np.flatnonzero(head)
        cnt_u = np.add.reduceat(cnt, starts_u)
        seg_u, nbr_u = seg[starts_u], nbr[starts_u]
        # write the compacted rows back in place (they only ever shrink)
        lens_u = np.bincount(seg_u, minlength=roots.size).astype(np.int64)
        ends_u = np.cumsum(lens_u)
        pos = self.row_ptr[roots][seg_u] + (
            np.arange(seg_u.size, dtype=np.int64) - (ends_u - lens_u)[seg_u]
        )
        self.arena_ids[pos] = nbr_u
        self.arena_cnt[pos] = cnt_u
        self.row_len[roots] = lens_u
        return seg_u, nbr_u, cnt_u

    # -- merge -------------------------------------------------------------
    def merge_batch(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        """Merge m disjoint root pairs (A[i], B[i]) in one arena operation.

        All per-id bookkeeping is vectorized; the merged rows of every pair
        are built from ONE gather + segment aggregation and bulk-appended.
        Returns the m fresh parent ids.
        """
        A = np.asarray(A, dtype=np.int64)
        B = np.asarray(B, dtype=np.int64)
        m = A.size
        base = self.n_ids
        self._ensure_ids(base + m)
        self.n_ids = base + m
        M = base + np.arange(m, dtype=np.int64)
        self.parent[A] = M
        self.parent[B] = M
        self.parent[M] = -1
        for i in range(m):
            self.children[base + i] = [int(A[i]), int(B[i])]
        self.size[M] = self.size[A] + self.size[B]
        self.height[M] = np.maximum(self.height[A], self.height[B]) + 1
        self.ndesc[M] = self.ndesc[A] + self.ndesc[B] + 2
        roots = np.concatenate([A, B])
        pair_of_root = np.concatenate([np.arange(m), np.arange(m)])
        seg, nbr, cnt = self.gather_rows(roots)
        pair = pair_of_root[seg]
        cab = np.zeros(m, dtype=np.int64)
        lens = np.zeros(m, dtype=np.int64)
        nbr_k = cnt_k = np.zeros(0, dtype=np.int64)
        if nbr.size:
            # aggregate the two rows of each pair, drop internal A↔B entries
            key = pair * np.int64(self.n_ids + 1) + nbr
            order = np.argsort(key, kind="stable")
            key, pair, nbr, cnt = key[order], pair[order], nbr[order], cnt[order]
            head = np.empty(key.size, dtype=bool)
            head[0] = True
            np.not_equal(key[1:], key[:-1], out=head[1:])
            starts = np.flatnonzero(head)
            cnt_u = np.add.reduceat(cnt, starts)
            pair_u, nbr_u = pair[starts], nbr[starts]
            internal = (nbr_u == A[pair_u]) | (nbr_u == B[pair_u])
            # A→B and B→A each counted once
            cab = (np.bincount(pair_u[internal], weights=cnt_u[internal],
                               minlength=m).astype(np.int64) // 2)
            keep = ~internal
            pair_k, nbr_k, cnt_k = pair_u[keep], nbr_u[keep], cnt_u[keep]
            lens = np.bincount(pair_k, minlength=m).astype(np.int64)
        total = int(lens.sum())
        self._ensure_arena(total)
        ends = np.cumsum(lens)
        self.row_ptr[M] = self.arena_top + ends - lens
        self.row_len[M] = lens
        self.arena_ids[self.arena_top : self.arena_top + total] = nbr_k
        self.arena_cnt[self.arena_top : self.arena_top + total] = cnt_k
        self.arena_top += total
        self.selfcnt[M] = self.selfcnt[A] + self.selfcnt[B] + cab
        self.forward[A] = M
        self.forward[B] = M
        self.alive_mask[A] = False
        self.alive_mask[B] = False
        self.alive_mask[M] = True
        self.row_len[A] = 0
        self.row_len[B] = 0
        self._root_cache = None
        return M


def _emit_encoding_reference(state: SluggerState) -> Summary:
    """Per-root-pair recursive DP emission — the semantics reference the
    batched emitter is cross-checked against (kept as ``backend="loop"``)."""
    g = state.g
    n = g.n
    root_of = state.root_of
    pos_of = np.zeros(n, dtype=np.int64)
    tvs: dict = {}
    # TreeView/DP recursion depth tracks the forest height; raise the limit
    # locally instead of mutating it for the whole process.
    limit = int(4 * state.height[: state.n_ids].max() + 2000)
    old_limit = sys.getrecursionlimit()
    # lint: disable=NO-RECURSION-LIMIT -- reference emitter only: scoped to this call, restored in the finally, and the recursive-DP cross-check is the point
    sys.setrecursionlimit(max(old_limit, limit))
    try:
        for r in np.unique(root_of):
            tv = encode_dp.TreeView(int(r), state.children, n)
            tvs[int(r)] = tv
            order = tv.leaf_order(state.children, n)
            pos_of[order] = np.arange(order.shape[0])

        el = g.edge_list()
        edges_out: list = []
        if el.size:
            ra = root_of[el[:, 0]]
            rb = root_of[el[:, 1]]
            # normalize: endpoint order follows (min root, max root)
            swap = ra > rb
            u = np.where(swap, el[:, 1], el[:, 0])
            v = np.where(swap, el[:, 0], el[:, 1])
            ka, kb = np.minimum(ra, rb), np.maximum(ra, rb)
            order = np.lexsort((kb, ka))
            u, v, ka, kb = u[order], v[order], ka[order], kb[order]
            # root-pair groups split on component diffs — unlike the previous
            # ka * (max(kb)+1) + kb keying this cannot overflow int64 however
            # large the supernode ids grow (see summary_ir.group_pairs).
            head = (np.diff(ka) != 0) | (np.diff(kb) != 0)
            bounds = np.concatenate([[0], np.flatnonzero(head) + 1, [ka.shape[0]]])
            for i in range(bounds.shape[0] - 1):
                s, e = bounds[i], bounds[i + 1]
                A, B = int(ka[s]), int(kb[s])
                if A == B:
                    pu, pv = pos_of[u[s:e]], pos_of[v[s:e]]
                    lo, hi = np.minimum(pu, pv), np.maximum(pu, pv)
                    _, ee = encode_dp.encode_self(tvs[A], lo, hi)
                else:
                    pa, pb = pos_of[u[s:e]], pos_of[v[s:e]]
                    _, ee = encode_dp.encode_pair(tvs[A], tvs[B], pa, pb)
                edges_out.extend(ee)
    finally:
        # lint: disable=NO-RECURSION-LIMIT -- restores the caller's limit after the reference emitter's scoped bump above
        sys.setrecursionlimit(old_limit)

    parent = state.parent[: state.n_ids].copy()
    arr = canon_edges(np.array(edges_out, dtype=np.int64).reshape(-1, 3))
    return Summary(n_leaves=n, parent=parent, edges=arr)


def _emit_encoding(state: SluggerState, backend: str = "numpy",
                   device=None, owner=None) -> Summary:
    """Exact hierarchical encoding of the input graph over the current merge
    forest (plays the paper's 'update of encoding' role).

    ``backend="loop"`` runs the per-root-pair recursive DP; other backends
    run the batched level-synchronous DP over the flat Summary IR
    (`core/encode_batched.py`), with the per-level membership counts
    dispatched through the CUDA seghist kernel on ``device`` for
    ``backend="batched"``. Both produce bit-identical canonical edge arrays.

    ``owner`` (node → partition, DESIGN.md §8) buckets the root pairs by
    partition and emits each bucket separately, each on ``device``:
    per-pair encodings are independent and the export is canonical-sorted,
    so the result is bit-identical to the monolithic emission for any
    ownership map."""
    g = state.g
    if g.n == 0:
        return Summary(n_leaves=0, parent=np.zeros(0, dtype=np.int64),
                       edges=np.zeros((0, 3), dtype=np.int64))
    if backend == "loop":
        return _emit_encoding_reference(state)
    parent = state.parent[: state.n_ids].copy()
    ir = SummaryIR(parent, g.n)
    if not forest_is_binary(ir):  # only the recursive DP handles n-ary trees
        return _emit_encoding_reference(state)
    el = g.edge_list()
    u = el[:, 0] if el.size else np.zeros(0, dtype=np.int64)
    v = el[:, 1] if el.size else np.zeros(0, dtype=np.int64)
    if owner is None or u.size == 0:
        _, edges = encode_forest(ir, u, v, backend=backend, device=device)
        return Summary(n_leaves=g.n, parent=parent, edges=edges)
    # partition-aware emission: a root pair belongs to the partition owning
    # the smaller root's smallest leaf; buckets encode independently
    root_of = state.root_of
    min_leaf = state.root_min_leaf()
    key_root = np.minimum(root_of[u], root_of[v])
    part = np.asarray(owner, dtype=np.int64)[min_leaf[key_root]]
    chunks = []
    for p in np.unique(part):
        sel = part == p
        _, e_p = encode_forest(ir, u[sel], v[sel], backend=backend,
                               device=device)
        chunks.append(e_p)
    edges = canon_edges(np.concatenate(chunks, axis=0))
    return Summary(n_leaves=g.n, parent=parent, edges=edges)


def summarize(
    g: Graph,
    T: int = 20,
    seed: int = 0,
    max_group: int = 500,
    top_j: int = 16,
    height_bound=None,
    prune_steps=(1, 2, 3),
    verbose: bool = False,
    backend: str = "batched",
    partitions: int = 1,
    device=None,
) -> Summary:
    """Run SLUGGER end to end. ``prune_steps=()`` skips pruning (paper's
    'state 0' in Table IV); ``height_bound`` is the Table-V H_b variant.
    ``backend`` selects the merge engine (see module docstring).

    ``device`` is where the kernels run: ``None`` means the CUDA card and
    raises ``RuntimeError`` when there is none; ``"cpu"`` runs the kernels'
    plain versions. This is a thin wrapper over
    `repro_torch.core.engine.SummarizerEngine`, the stage-based
    partition-parallel engine (DESIGN.md §8): ``partitions`` shards the
    work by node ownership and the result is bit-identical for every
    value. ``verbose`` raises the engine logger to INFO."""
    from repro_torch.core.engine import SummarizerEngine  # circular-safe

    engine = SummarizerEngine(
        partitions=partitions, backend=backend, T=T, seed=seed,
        max_group=max_group, top_j=top_j, height_bound=height_bound,
        prune_steps=prune_steps, device=device)
    if not verbose:
        return engine.run(g)
    restore = _ensure_info_logging()
    try:
        return engine.run(g)
    finally:
        restore()


def _ensure_info_logging():
    """`verbose=True` compatibility shim: surface engine INFO logs on
    stderr when the caller has not configured logging themselves. Returns
    a restore callback — a later ``verbose=False`` call must be silent
    again, so nothing may stick to the logger."""
    logger = logging.getLogger("repro_torch.engine")
    old_level = logger.level
    logger.setLevel(logging.INFO)
    handler = None
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
        logger.addHandler(handler)

    def restore():
        logger.setLevel(old_level)
        if handler is not None:
            logger.removeHandler(handler)

    return restore
