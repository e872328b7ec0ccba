"""Pruning step (Sect. III-B4): remove supernodes that do not pay for their
h-edges, without any information loss.

  Step 1 — splice every non-leaf supernode with no incident p/n-edges
           (−1 h-edge each; −#children when it is a root).
  Step 2 — the paper's exactly-one-incident-non-loop-edge rule for roots:
           push the edge down to the children (guaranteed net reduction ≥ 1).
  Step 3 — the paper falls back to the *flat* encoding per root pair when
           cheaper. Our emission DP's per-pair cost is ≤ flat by construction
           (DESIGN.md §2.1), so the residual opportunity is in |H|: we
           generalize to a benefit-tested *root flattening* — remove a root,
           promote its children, re-attach its edges at child granularity —
           applied whenever it strictly reduces |P⁺|+|P⁻|+|H|.

``_IRWork`` runs on flat arrays over the Summary IR (DESIGN.md §5). Steps
1 and 2 are vectorized mask passes over bincount degrees with pointer-jump
splicing; step 3 precomputes every candidate's benefit delta in one
bincount/reduceat sweep over the incidence CSR and walks candidates with an
index cursor, recomputing only candidates whose neighborhood a previous
splice dirtied.

Determinism: step-2 candidates are processed in synchronized passes (an
edge whose two endpoints both qualify keeps the larger id) and step-3
candidates in (depth desc, id asc) order, and edge rows are exported in
canonical (lo, hi, sign) lexicographic order — two runs on the same summary
produce identical arrays.

All steps preserve the decompressed graph exactly (test-enforced).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.summary import Summary
from repro_torch.core.summary_ir import (SummaryIR, canon_edges, group_pairs,
                                   segmented_indices)


def _aggregate_pairs(ex, ey, ec):
    """Normalize (x, y) pairs, sum multiplicities, drop zero nets."""
    lo = np.minimum(ex, ey)
    hi = np.maximum(ex, ey)
    order, starts = group_pairs(lo, hi)
    if lo.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    lo, hi, c = lo[order], hi[order], ec[order]
    sums = np.add.reduceat(c, starts)
    keep = sums != 0
    return lo[starts][keep], hi[starts][keep], sums[keep]


def _pair_lookup(bex, bey, bec, qx, qy):
    """Multiplicity of each query pair in the base pair list (0 if absent).

    Both inputs are pair lists; the base is unique per pair. One shared
    lexsort aligns queries next to their base row — no combined integer key,
    so arbitrarily large ids cannot overflow (see summary_ir.group_pairs).
    """
    nq = qx.shape[0]
    if nq == 0 or bex.shape[0] == 0:
        return np.zeros(nq, dtype=np.int64)
    allx = np.concatenate([bex, qx])
    ally = np.concatenate([bey, qy])
    isq = np.zeros(allx.shape[0], dtype=np.int64)
    isq[bex.shape[0]:] = 1
    order = np.lexsort((isq, ally, allx))
    head = np.empty(allx.shape[0], dtype=bool)
    head[0] = True
    sx, sy = allx[order], ally[order]
    np.not_equal(sx[1:], sx[:-1], out=head[1:])
    head[1:] |= sy[1:] != sy[:-1]
    gid = np.cumsum(head) - 1
    vals = np.where(isq[order] == 0, np.concatenate([bec, np.zeros(nq, dtype=np.int64)])[order], 0)
    gval = np.zeros(gid[-1] + 1, dtype=np.int64)
    np.add.at(gval, gid, vals)
    out = np.empty(allx.shape[0], dtype=np.int64)
    out[order] = gval[gid]
    return out[bex.shape[0]:]


class _IRWork:
    """Array-based pruning working set over the flat Summary IR."""

    def __init__(self, s: Summary):
        self.n = s.n_leaves
        self.parent = np.asarray(s.parent, dtype=np.int64).copy()
        edges = np.asarray(s.edges, dtype=np.int64).reshape(-1, 3)
        self.ex, self.ey, self.ec = _aggregate_pairs(
            edges[:, 0], edges[:, 1], edges[:, 2])

    # ---- helpers ----------------------------------------------------------
    def _cap(self) -> int:
        return self.parent.shape[0]

    def _alive(self) -> np.ndarray:
        return self.parent > -2

    def _nkids(self) -> np.ndarray:
        alive = self._alive()
        haspar = alive & (self.parent >= 0)
        return np.bincount(self.parent[haspar], minlength=self._cap())

    def _deg(self) -> np.ndarray:
        nonloop = self.ex != self.ey
        ends = np.concatenate([self.ex, self.ey[nonloop]])
        return np.bincount(ends, minlength=self._cap())

    def _splice(self, rem: np.ndarray):
        """Remove masked nodes; their children attach to the nearest kept
        ancestor (or become roots), via vectorized pointer jumping."""
        par = self.parent
        new_par = par.copy()
        mask = (new_par >= 0) & rem[new_par]
        while mask.any():
            new_par[mask] = par[new_par[mask]]
            mask = (new_par >= 0) & rem[new_par]
        new_par[rem] = -2
        self.parent = new_par

    # ---- step 1 -----------------------------------------------------------
    def step1(self) -> int:
        """One vectorized pass: splicing an edge-free node never changes any
        other node's degree or children, so the qualifying set is closed."""
        ids = np.arange(self._cap())
        rem = (self._alive() & (ids >= self.n) & (self._deg() == 0)
               & (self._nkids() > 0))
        if not rem.any():
            return 0
        self._splice(rem)
        return int(rem.sum())

    # ---- step 2 (paper Algorithm 3, lines 13-27) --------------------------
    def _step2_candidates(self):
        """Roots with exactly one incident edge, non-loop, multiplicity ±1.
        Returns (cands, eid, other, sign) after the larger-id conflict rule."""
        cap = self._cap()
        ids = np.arange(cap)
        nonloop = self.ex != self.ey
        ends = np.concatenate([self.ex, self.ey[nonloop]])
        eids = np.concatenate([np.arange(self.ex.shape[0], dtype=np.int64),
                               np.flatnonzero(nonloop)])
        inc_total = np.bincount(ends, minlength=cap)
        loop_cnt = np.bincount(self.ex[~nonloop], minlength=cap)
        cand_mask = (self._alive() & (self.parent == -1) & (ids >= self.n)
                     & (self._nkids() > 0) & (inc_total == 1) & (loop_cnt == 0))
        cands = np.flatnonzero(cand_mask)
        if cands.size == 0:
            return cands, cands, cands, cands
        order = np.argsort(ends, kind="stable")
        pos = np.searchsorted(ends[order], cands)
        eid = eids[order][pos]
        ok = np.abs(self.ec[eid]) == 1
        cands, eid = cands[ok], eid[ok]
        cand_mask = np.zeros(cap, dtype=bool)
        cand_mask[cands] = True
        other = self.ex[eid] + self.ey[eid] - cands
        keep = ~cand_mask[other] | (cands > other)
        cands, eid, other = cands[keep], eid[keep], other[keep]
        return cands, eid, other, np.sign(self.ec[eid])

    def step2(self) -> int:
        removed = 0
        while True:
            cands, eid, other, sg = self._step2_candidates()
            if cands.size == 0:
                return removed
            # push each candidate's single edge down to its children
            nk = self._nkids()
            haspar = self._alive() & (self.parent >= 0)
            kids = np.flatnonzero(haspar)
            kids = kids[np.argsort(self.parent[kids], kind="stable")]
            kptr = np.zeros(self._cap() + 1, dtype=np.int64)
            np.cumsum(nk, out=kptr[1:])
            lens = nk[cands]
            idx = segmented_indices(kptr[cands], lens)
            new_x = kids[idx]
            new_y = np.repeat(other, lens)
            new_c = np.repeat(sg, lens)
            keep = np.ones(self.ex.shape[0], dtype=bool)
            keep[eid] = False
            self.ex, self.ey, self.ec = _aggregate_pairs(
                np.concatenate([self.ex[keep], new_x]),
                np.concatenate([self.ey[keep], new_y]),
                np.concatenate([self.ec[keep], new_c]),
            )
            rem = np.zeros(self._cap(), dtype=bool)
            rem[cands] = True
            self._splice(rem)  # candidates are roots: children become roots
            removed += cands.size

    # ---- step 3 (benefit-tested splice of any non-leaf supernode) ----------
    def _step3_bulk(self, ir, cands, nk, sizes, bex, bey, bec, delta):
        """Bulk feasibility/plan/delta pass over the candidates.

        Emits the plan rows (plo, phi, ps, pc) and accumulates each
        candidate's benefit delta into ``delta`` in place."""
        z = np.zeros(0, dtype=np.int64)
        if cands.size == 0:
            return z, z.copy(), z.copy(), z.copy()
        eids, seg = ir.incident_eids(cands)  # per-candidate incident edges
        a_of = cands[seg]
        loop_m = bex[eids] == bey[eids]
        # non-loop incident edges: plan (kid, b, sg) per kid of a
        nl = ~loop_m
        a_nl, e_nl = a_of[nl], eids[nl]
        b_nl = bex[e_nl] + bey[e_nl] - a_nl
        reps = nk[a_nl]
        kid_nl = ir.child_ids[segmented_indices(ir.child_ptr[a_nl], reps)]
        pu1 = kid_nl
        pv1 = np.repeat(b_nl, reps)
        ps1 = np.repeat(np.sign(bec[e_nl]), reps)
        pc1 = np.repeat(a_nl, reps)
        # self-loop incident edges: kid-pair expansion + kid self-loops
        a_lp = a_of[loop_m]
        e_lp = eids[loop_m]
        pu2 = [np.zeros(0, dtype=np.int64)]
        pv2 = [np.zeros(0, dtype=np.int64)]
        ps2 = [np.zeros(0, dtype=np.int64)]
        pc2 = [np.zeros(0, dtype=np.int64)]
        if a_lp.size:
            sg_lp = np.sign(bec[e_lp])
            for k in np.unique(nk[a_lp]):
                sel = nk[a_lp] == k
                aa, ss = a_lp[sel], sg_lp[sel]
                kid_rows = ir.child_ids[
                    ir.child_ptr[aa][:, None] + np.arange(int(k))[None, :]]
                iu, iv = np.triu_indices(int(k), k=1)
                pu2.append(kid_rows[:, iu].ravel())
                pv2.append(kid_rows[:, iv].ravel())
                ps2.append(np.repeat(ss, iu.size))
                pc2.append(np.repeat(aa, iu.size))
                big = sizes[kid_rows] > 1  # child self-loops for non-singletons
                pu2.append(kid_rows[big])
                pv2.append(kid_rows[big])
                ps2.append(np.repeat(ss, int(k))[big.ravel()])
                pc2.append(np.repeat(aa, int(k))[big.ravel()])
        pu = np.concatenate([pu1] + pu2)
        pv = np.concatenate([pv1] + pv2)
        ps = np.concatenate([ps1] + ps2)
        pc = np.concatenate([pc1] + pc2)
        plo, phi = np.minimum(pu, pv), np.maximum(pu, pv)
        cur = _pair_lookup(bex, bey, bec, plo, phi)
        contrib = np.where(cur == -ps, -1, 1)
        np.add.at(delta, pc, contrib)
        return plo, phi, ps, pc

    def step3(self, partition_map=None) -> int:
        cap = self._cap()
        ir = SummaryIR(self.parent, self.n)
        nk = ir.n_children()
        ids = np.arange(cap)
        cand_mask = self._alive() & (ids >= self.n) & (nk > 0)
        cands = np.flatnonzero(cand_mask)
        if cands.size == 0:
            return 0
        # deterministic bottom-up order: deepest first, then ascending id
        cands = cands[np.lexsort((cands, -ir.depth[cands]))]
        sizes = ir.size(ids)
        bex, bey, bec = self.ex, self.ey, self.ec
        ir.build_incidence(np.stack([bex, bey, bec], axis=1))

        # -- bulk pass: feasibility, plans, deltas against the entry state --
        # Per-candidate outputs are independent, so the pass runs per
        # partition bucket when a partition map is given (DESIGN.md §8):
        # temporaries shrink to the bucket's plan size and the result is
        # bit-identical to the monolithic pass.
        bad = np.abs(bec) != 1
        bad_ends = np.concatenate([bex[bad], bey[bad & (bex != bey)]])
        infeasible_cnt = np.bincount(bad_ends, minlength=cap)
        deg_all = self._deg()
        is_root0 = self.parent == -1
        delta = np.where(is_root0, -nk, -1).astype(np.int64)
        delta = delta - deg_all
        if partition_map is None:
            buckets = [cands]
        else:
            part_of_cand = np.asarray(partition_map, dtype=np.int64)[
                ir.order[ir.first[cands]]]
            buckets = [cands[part_of_cand == p]
                       for p in np.unique(part_of_cand)]
        bulk = [self._step3_bulk(ir, csub, nk, sizes, bex, bey, bec, delta)
                for csub in buckets]
        plo, phi, ps, pc = (np.concatenate(col) for col in zip(*bulk))
        # plan rows CSR by candidate (pc is emitted in ascending-candidate
        # runs per construction branch; re-sort to be safe)
        p_order = np.argsort(pc, kind="stable")
        plo, phi, ps, pc = plo[p_order], phi[p_order], ps[p_order], pc[p_order]
        p_counts = np.bincount(pc, minlength=cap)
        p_ptr = np.zeros(cap + 1, dtype=np.int64)
        np.cumsum(p_counts, out=p_ptr[1:])

        # -- sequential sweep with staleness tracking ------------------------
        overlay: dict = {}      # pair -> absolute current multiplicity
        extra_inc: dict = {}    # node -> overlay pairs not in the base list
        kids_mut: dict = {}     # node -> current child list (if changed)
        dirty = np.zeros(cap, dtype=bool)
        parent = self.parent
        b_order = np.argsort(bex, kind="stable")
        sbex, sbey = bex[b_order], bey[b_order]

        def base_mult(x, y):
            lo = np.searchsorted(sbex, x, side="left")
            hi = np.searchsorted(sbex, x, side="right")
            j = lo + np.searchsorted(sbey[lo:hi], y)
            if j < hi and sbey[j] == y:
                return int(bec[b_order[j]])
            return 0

        def mult(x, y):
            key = (int(min(x, y)), int(max(x, y)))
            if key in overlay:
                return overlay[key]
            return base_mult(*key)

        def kids_of(a):
            got = kids_mut.get(a)
            if got is not None:
                return got
            return ir.children_of(a).tolist()

        def incident_pairs(a):
            out = []
            ee, _ = ir.incident_eids(np.array([a], dtype=np.int64))
            for e in ee:
                key = (int(bex[e]), int(bey[e]))
                c = overlay.get(key)
                c = int(bec[e]) if c is None else c
                if c != 0:
                    out.append((key[0], key[1], c))
            for key in extra_inc.get(a, ()):
                c = overlay.get(key, 0)
                if c != 0:
                    out.append((key[0], key[1], c))
            return out

        def set_mult(x, y, value):
            key = (int(min(x, y)), int(max(x, y)))
            if key not in overlay and base_mult(*key) == 0:
                extra_inc.setdefault(key[0], set()).add(key)
                if key[0] != key[1]:
                    extra_inc.setdefault(key[1], set()).add(key)
            overlay[key] = value

        def eval_one(a):
            """(accept, removals, plan) from the *current* state — the same
            benefit test as the bulk pass, for dirtied candidates."""
            kids = kids_of(a)
            inc = incident_pairs(a)
            is_root = parent[a] == -1
            d = -len(kids) if is_root else -1
            plan = []
            for (x, y, c) in inc:
                if abs(c) != 1:
                    return False, None, None
                sg = 1 if c > 0 else -1
                d -= 1
                if x == y:
                    for i in range(len(kids)):
                        for j in range(i + 1, len(kids)):
                            plan.append((kids[i], kids[j], sg))
                    for kk in kids:
                        if sizes[kk] > 1:
                            plan.append((kk, kk, sg))
                else:
                    b = y if x == a else x
                    for kk in kids:
                        plan.append((kk, b, sg))
            for (u, v, sg) in plan:
                d += -1 if mult(u, v) == -sg else 1
            accept = d <= 0 and (d < 0 or not is_root)
            return accept, inc, plan

        removed = 0
        for a in cands:
            a = int(a)
            if dirty[a]:
                accept, inc, plan = eval_one(a)
                if not accept:
                    continue
            else:
                if infeasible_cnt[a] or not (
                    delta[a] <= 0 and (delta[a] < 0 or parent[a] != -1)
                ):
                    continue
                inc = incident_pairs(a)
                s, e = p_ptr[a], p_ptr[a + 1]
                plan = list(zip(plo[s:e].tolist(), phi[s:e].tolist(), ps[s:e].tolist()))
            # apply: drop a's edges, add the plan at child granularity
            touched = set()
            for (x, y, _c) in inc:
                set_mult(x, y, 0)
                touched.add(x)
                touched.add(y)
            for (u, v, sg) in plan:
                set_mult(u, v, mult(u, v) + sg)
                touched.add(u)
                touched.add(v)
            kids = kids_of(a)
            p = int(parent[a])
            for kk in kids:
                parent[kk] = p
            if p >= 0:
                pk = kids_of(p)
                pk = [k for k in pk if k != a] + list(kids)
                kids_mut[p] = pk
                dirty[p] = True
            parent[a] = -2
            for w in sorted(touched):
                dirty[w] = True
                if parent[w] >= 0:
                    dirty[parent[w]] = True
            for kk in kids:
                dirty[kk] = True
            removed += 1

        if overlay:
            ov = sorted(overlay.items())
            ovx = np.array([k[0] for k, _ in ov], dtype=np.int64)
            ovy = np.array([k[1] for k, _ in ov], dtype=np.int64)
            ovc = np.array([v for _, v in ov], dtype=np.int64)
            # overlay values are absolute: drop overlaid base rows, then add
            overlaid = _pair_lookup(ovx, ovy, np.ones_like(ovc), bex, bey) > 0
            nz = ovc != 0
            self.ex, self.ey, self.ec = _aggregate_pairs(
                np.concatenate([bex[~overlaid], ovx[nz]]),
                np.concatenate([bey[~overlaid], ovy[nz]]),
                np.concatenate([bec[~overlaid], ovc[nz]]),
            )
        return removed

    # ---- export ------------------------------------------------------------
    def to_summary(self) -> Summary:
        reps = np.abs(self.ec)
        rows = np.stack([
            np.repeat(self.ex, reps),
            np.repeat(self.ey, reps),
            np.repeat(np.sign(self.ec), reps),
        ], axis=1)
        return Summary(n_leaves=self.n, parent=self.parent,
                       edges=canon_edges(rows))


PRUNE_ROUNDS = 3  # the reference's default; no caller sets another


def prune(summary: Summary, steps=(1, 2, 3), partition_map=None) -> Summary:
    """Run the selected pruning substeps (repeated until fixpoint, at most
    `PRUNE_ROUNDS` times) on the flat-array implementation.
    ``partition_map`` (node → partition, DESIGN.md §8) makes the step-3
    bulk pass run per partition bucket — bounded temporaries, bit-identical
    output."""
    w = _IRWork(summary)
    for _ in range(PRUNE_ROUNDS):
        changed = 0
        if 1 in steps:
            changed += w.step1()
        if 2 in steps:
            changed += w.step2()
        if 3 in steps:
            changed += w.step3(partition_map=partition_map)
        if not changed:
            break
    return w.to_summary()
