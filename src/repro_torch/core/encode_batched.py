"""Batched, level-synchronous emission of the pairwise encoding DP.

Same option space and tie-breaking as the recursive reference
(`core/encode_dp.py`), evaluated over ALL root pairs at once on the flat
Summary IR instead of one memoized recursion per pair (DESIGN.md §5).

The key reduction: a pair state — cross ``(x, y)`` over disjoint supernodes
or self ``(x, x)`` — only needs the recursion when it is *mixed*
(``0 < cnt < poss``). Empty and full states have closed forms that already
fold in the reference's descend-on-tie rule:

  empty, parity 1 → one n-edge   full, parity 0 → one p-edge
  placed at (x, y) for cross states; for self states at the leaf pair when x
  has exactly two leaf children (the reference descends through the tied
  single child cross pair), else at the (x, x) loop. Parities 0/empty and
  1/full cost nothing.

Leaf–leaf and single-leaf states are never mixed, so the mixed frontier
descends one tree level per step and the whole DP is three array passes:

  1. expansion — every mixed state materializes its child-state slots
     (3 for self, ≤4 for cross); each active subedge finds its child slot
     with one interval comparison against the IR's ``first`` bounds, and the
     per-state membership counts come from one histogram dispatch
     (`kernels/seghist`, the CUDA kernel on ``backend="batched"``).
  2. bottom-up — ``D0/D1`` are `reduceat` segment sums over each state's
     contiguous child slots; ``E0 = min(D0, 1+D1)``, ``E1 = min(D1, 1+D0)``.
  3. top-down — each state holds one parity; a mixed state descends iff
     ``D(par) <= 1 + D(1-par)`` (the reference's tie rule), else places the
     signed edge and flips the children's parity.

Only strictly binary forests take this path (merge forests always are);
`encode_forest` raises ``ValueError`` otherwise and the caller falls back to
the recursive reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.summary_ir import SummaryIR, group_pairs
from repro_torch.kernels.seghist.ops import membership_counts


def forest_is_binary(ir: SummaryIR) -> bool:
    """True iff every internal node has exactly two children — the shape the
    batched emitter handles (merge forests always satisfy it)."""
    nk = ir.n_children()
    return bool(np.all(nk[nk > 0] == 2))


def _kid_arrays(ir: SummaryIR):
    """(kid0, kid1) per node; -1 for leaves. Raises on non-binary nodes."""
    if not forest_is_binary(ir):
        raise ValueError("batched emitter requires a strictly binary forest")
    nk = ir.n_children()
    internal = nk > 0
    kid0 = np.full(ir.n_ids, -1, dtype=np.int64)
    kid1 = np.full(ir.n_ids, -1, dtype=np.int64)
    kid0[internal] = ir.child_ids[ir.child_ptr[:-1][internal]]
    kid1[internal] = ir.child_ids[ir.child_ptr[:-1][internal] + 1]
    return kid0, kid1


def _state_poss(ir: SummaryIR, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    size_x, size_y = ir.size(sx), ir.size(sy)
    self_mask = sx == sy
    poss = size_x * size_y
    poss[self_mask] = size_x[self_mask] * (size_x[self_mask] - 1) // 2
    return poss


def _dedup_states(sx_e, sy_e):
    """Edge-level (sx, sy) pairs -> unique state table + per-edge index."""
    order, starts = group_pairs(sx_e, sy_e)
    nstates = starts.shape[0]
    st_sorted = np.zeros(sx_e.shape[0], dtype=np.int64)
    st_sorted[starts] = 1
    st_sorted = np.cumsum(st_sorted) - 1
    st = np.empty(sx_e.shape[0], dtype=np.int64)
    st[order] = st_sorted
    sx = sx_e[order][starts]
    sy = sy_e[order][starts]
    return sx, sy, st


def encode_forest(ir: SummaryIR, u: np.ndarray, v: np.ndarray,
                  backend: str = "numpy", device=None):
    """Minimal hierarchical encoding of subedges (u, v) over the forest.

    ``backend="batched"`` counts each level's state membership on
    ``device`` (a ``torch.device``; the CPU runs the kernel's plain
    version). Returns ``(cost, edges)`` with edges a (k, 3) int64 array (gid, gid,
    sign), rows in canonical (lo, hi, sign) lexicographic order.
    """
    empty = np.zeros((0, 3), dtype=np.int64)
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if u.size == 0:
        return 0, empty
    kid0, kid1 = _kid_arrays(ir)
    first, last, n_leaves = ir.first, ir.last, ir.n_leaves

    # -- level 0: root-pair states ----------------------------------------
    p0, p1 = ir.pos_of[u], ir.pos_of[v]
    root_first = first[ir.roots]
    ru = ir.roots[np.searchsorted(root_first, p0, side="right") - 1]
    rv = ir.roots[np.searchsorted(root_first, p1, side="right") - 1]
    sx_e = np.minimum(ru, rv)
    sy_e = np.maximum(ru, rv)
    # p0 rides the sx side, p1 the sy side; self states keep p0 < p1
    swap = np.where(ru == rv, p0 > p1, ru > rv)
    p0, p1 = np.where(swap, p1, p0), np.where(swap, p0, p1)
    sx, sy, st = _dedup_states(sx_e, sy_e)

    levels = []
    while True:
        cnt = membership_counts(st, sx.shape[0], backend=backend,
                                device=device)
        poss = _state_poss(ir, sx, sy)
        mixed = (cnt > 0) & (cnt < poss)
        lvl = {"sx": sx, "sy": sy, "cnt": cnt, "poss": poss, "mixed": mixed}
        levels.append(lvl)
        m_idx = np.flatnonzero(mixed)
        if m_idx.size == 0:
            break
        mrank = np.full(sx.shape[0], -1, dtype=np.int64)
        mrank[m_idx] = np.arange(m_idx.size)
        mx, my = sx[m_idx], sy[m_idx]
        is_self = mx == my
        x_int = kid0[mx] >= 0
        y_int = kid0[my] >= 0
        nslots = np.where(is_self, 3,
                          np.where(x_int, 2, 1) * np.where(y_int, 2, 1))
        slot_ptr = np.zeros(m_idx.size + 1, dtype=np.int64)
        np.cumsum(nslots, out=slot_ptr[1:])
        lvl["slot_ptr"] = slot_ptr
        total = int(slot_ptr[-1])
        nsx = np.empty(total, dtype=np.int64)
        nsy = np.empty(total, dtype=np.int64)
        base = slot_ptr[:-1]
        sm = is_self
        if sm.any():
            b = base[sm]
            k0, k1 = kid0[mx[sm]], kid1[mx[sm]]
            nsx[b], nsy[b] = k0, k0
            nsx[b + 1], nsy[b + 1] = k1, k1
            nsx[b + 2], nsy[b + 2] = k0, k1  # k0 < k1 by CSR construction
        cm = ~is_self
        bb = cm & x_int & y_int
        if bb.any():
            b = base[bb]
            x0, x1 = kid0[mx[bb]], kid1[mx[bb]]
            y0, y1 = kid0[my[bb]], kid1[my[bb]]
            for s_i, (cx, cy) in enumerate(((x0, y0), (x0, y1), (x1, y0), (x1, y1))):
                nsx[b + s_i] = np.minimum(cx, cy)
                nsy[b + s_i] = np.maximum(cx, cy)
        xl = cm & x_int & ~y_int
        if xl.any():
            b = base[xl]
            x0, x1, yy = kid0[mx[xl]], kid1[mx[xl]], my[xl]
            for s_i, cx in enumerate((x0, x1)):
                nsx[b + s_i] = np.minimum(cx, yy)
                nsy[b + s_i] = np.maximum(cx, yy)
        yl = cm & ~x_int & y_int
        if yl.any():
            b = base[yl]
            y0, y1, xx = kid0[my[yl]], kid1[my[yl]], mx[yl]
            nsx[b] = np.minimum(y0, xx)
            nsy[b] = np.maximum(y0, xx)
            nsx[b + 1] = np.minimum(y1, xx)
            nsy[b + 1] = np.maximum(y1, xx)

        # -- descend the active edges one level --------------------------
        act = mixed[st]
        if not act.any():
            # mixed states with no surviving edges cannot exist (mixed ⇒ cnt>0)
            raise AssertionError("mixed state without active edges")
        st_a, p0_a, p1_a = st[act], p0[act], p1[act]
        x_a, y_a = sx[st_a], sy[st_a]
        self_a = x_a == y_a
        # child on each side: kid1 iff the position is right of kid1.first
        def _descend(node, pos):
            internal = kid0[node] >= 0
            k1 = np.where(internal, kid1[node], 0)
            take1 = internal & (pos >= first[k1])
            return np.where(internal, np.where(take1, k1, kid0[node]), node)

        c0 = _descend(x_a, p0_a)
        c1 = _descend(y_a, p1_a)
        slot = np.empty(st_a.shape[0], dtype=np.int64)
        if self_a.any():
            same = c0[self_a] == c1[self_a]
            hi = c0[self_a] == kid1[x_a[self_a]]
            slot[self_a] = np.where(same, np.where(hi, 1, 0), 2)
        ca = ~self_a
        if ca.any():
            xi = x_a[ca]
            yi = y_a[ca]
            i = (kid0[xi] >= 0) & (c0[ca] == kid1[xi])
            j = (kid0[yi] >= 0) & (c1[ca] == kid1[yi])
            both = (kid0[xi] >= 0) & (kid0[yi] >= 0)
            slot[ca] = np.where(both, 2 * i + j, np.where(kid0[xi] >= 0, i, j))
        nst = slot_ptr[mrank[st_a]] + slot
        # keep p0 on the (smaller-id) sx side after normalization
        swap = c0 > c1
        p0, p1 = np.where(swap, p1_a, p0_a), np.where(swap, p0_a, p1_a)
        sx, sy, st = nsx, nsy, nst

    # -- bottom-up D/E ----------------------------------------------------
    for li in range(len(levels) - 1, -1, -1):
        lvl = levels[li]
        cnt, poss, mixed = lvl["cnt"], lvl["poss"], lvl["mixed"]
        e0 = ((cnt > 0) & ~mixed).astype(np.int64)
        e1 = ((cnt == 0) & (poss > 0)).astype(np.int64)
        if mixed.any():
            nxt = levels[li + 1]
            sp = lvl["slot_ptr"]
            D0 = np.add.reduceat(nxt["e0"], sp[:-1])
            D1 = np.add.reduceat(nxt["e1"], sp[:-1])
            e0[mixed] = np.minimum(D0, 1 + D1)
            e1[mixed] = np.minimum(D1, 1 + D0)
            lvl["D0"], lvl["D1"] = D0, D1
        lvl["e0"], lvl["e1"] = e0, e1
    cost = int(levels[0]["e0"].sum())

    # -- top-down parity + emission ---------------------------------------
    out_x, out_y, out_s = [], [], []
    par = np.zeros(levels[0]["sx"].shape[0], dtype=np.int64)
    for li, lvl in enumerate(levels):
        sx, sy, cnt, poss, mixed = (
            lvl["sx"], lvl["sy"], lvl["cnt"], lvl["poss"], lvl["mixed"])
        full = ~mixed & (cnt > 0)
        emp = ~mixed & (cnt == 0) & (poss > 0)
        hit = (full & (par == 0)) | (emp & (par == 1))
        if hit.any():
            hx, hy = sx[hit], sy[hit]
            sign = np.where(full[hit], 1, -1).astype(np.int64)
            # self states over exactly two leaves place at the leaf pair
            self_h = hx == hy
            two_leaves = self_h & (kid0[hx] >= 0) & (kid0[hx] < n_leaves) \
                & (kid1[hx] < n_leaves)
            ex = np.where(two_leaves, kid0[hx], hx)
            ey = np.where(two_leaves, kid1[hx], hy)
            out_x.append(ex)
            out_y.append(ey)
            out_s.append(sign)
        if not mixed.any():
            break
        D0, D1 = lvl["D0"], lvl["D1"]
        mpar = par[mixed]
        desc = np.where(mpar == 0, D0 <= 1 + D1, D1 <= 1 + D0)
        place = ~desc
        if place.any():
            out_x.append(sx[mixed][place])
            out_y.append(sy[mixed][place])
            out_s.append(np.where(mpar[place] == 0, 1, -1).astype(np.int64))
        childpar = np.where(desc, mpar, 1 - mpar)
        sp = lvl["slot_ptr"]
        par = np.repeat(childpar, np.diff(sp))

    if not out_x:
        return cost, empty
    ex = np.concatenate(out_x)
    ey = np.concatenate(out_y)
    es = np.concatenate(out_s)
    lo, hi = np.minimum(ex, ey), np.maximum(ex, ey)
    edges = np.stack([lo, hi, es], axis=1)
    order = np.lexsort((edges[:, 2], edges[:, 1], edges[:, 0]))
    return cost, edges[order]
