"""The resident merge round's device programs: exact integer Saving, θ̂
acceptance and the count-carrying fold (DESIGN.md §9).

Everything here runs on the arena's device (the card, or the CPU in the
tests) and is INTEGER-EXACT, in lockstep with the host sweep in
`core/merging.py` (`saving_terms_rows`, `theta_accept_host`,
`apply_merges`) and with the JAX package's device twins, so decisions are
bit-identical across every backend:

* the clamped pair costs ``poss_pair_c`` / ``poss_self_c`` /
  ``pair_cost_c`` — the same expressions as the host's int64 ones, in
  int32 (the bank's conservation guard and the workspace build keep every
  count and cost below ``C_CLAMP``);
* ``prod_lt`` / ``theta_accept`` — the exact rational comparisons as int64
  products (operands are non-negative and below 2^31, so every product is
  below 2^62; the JAX package needs 32-bit limbs here, torch has int64);
* ``round_from_ranked`` — the exact first-wins rational argmax over a
  row's ranked candidates (the `jaccard_topj` kernel ranks them);
* ``fold_counts`` — the count phases of one round's fold (the bitmap phase
  is the `bitset_fold` kernel's), in place.
"""
from __future__ import annotations

import torch

# Integer-exact Saving contract, pinned to the JAX package's values.
C_CLAMP = 1 << 30
THETA_SHIFT = 20

_BUDGET = 1 << 24  # elements of one (rows, R) temporary per chunk


def poss_pair_c(s_m, colsize):
    """min(s_m·colsize, C_CLAMP) without int32 overflow."""
    big = s_m > C_CLAMP // torch.clamp(colsize, min=1)
    return torch.where(big, C_CLAMP, s_m * colsize)


def poss_self_c(s):
    """min(s·(s−1)/2, C_CLAMP) without overflow (the even factor is halved
    before the multiply; clamped above s = 46341)."""
    half = torch.where(s % 2 == 0, (s >> 1) * (s - 1), s * ((s - 1) >> 1))
    return torch.where(s > 46341, C_CLAMP, torch.clamp(half, max=C_CLAMP))


def pair_cost_c(cnt, poss_c):
    """min(cnt, poss − cnt + 1) on the clamped poss — 0 at cnt == 0."""
    return torch.minimum(cnt, poss_c - cnt + 1)


def prod_lt(a, b, c, d):
    """a·b < c·d, exact, for non-negative int32 operands."""
    return a.to(torch.int64) * b.to(torch.int64) < c.to(torch.int64) * d.to(
        torch.int64)


def theta_accept(numer, denom, theta_p: int):
    """Saving ≥ θ̂ as the exact integer test: denom > 0, numer ≤ denom and
    (denom − numer)·2^20 ≥ theta_p·denom."""
    numer = numer.to(torch.int64)
    denom = denom.to(torch.int64)
    diff = torch.clamp(denom - numer, min=0)
    return ((denom > 0) & (numer <= denom)
            & ((diff << THETA_SHIFT) >= int(theta_p) * denom))


def row_saving_terms(cnt_r, cnt_c, colsize_r, ca, cz, s_r, s_c, selfc_r,
                     selfc_c, nd_r, nd_c, cost_r, cost_c):
    """(numer, denom) int32 of merging each row r with one candidate c,
    elementwise over the leading axis (``cnt_*``/``colsize_r`` are
    ``(n, R)``, the rest ``(n,)``)."""
    merged = cnt_r + cnt_c
    s_m = s_r + s_c
    cost_cols = pair_cost_c(merged, poss_pair_c(s_m[:, None], colsize_r))
    total = (cost_cols.sum(dim=1, dtype=torch.int32)
             - cost_cols.gather(1, ca[:, None])[:, 0]
             - cost_cols.gather(1, cz[:, None])[:, 0])
    cab = cnt_r.gather(1, cz[:, None])[:, 0]
    total = total + pair_cost_c(selfc_r + selfc_c + cab, poss_self_c(s_m))
    numer = total + nd_r + nd_c + 2
    denom = cost_r + cost_c - pair_cost_c(cab, poss_pair_c(s_r, s_c))
    return numer, denom


def round_from_ranked(state: dict, rows: torch.Tensor, cand: torch.Tensor,
                      top_j: int, height_bound):
    """Best proposal of each selected row over its ranked candidates.

    ``state`` holds the arena tensors (``alive``, ``dirty``, ``CNT``,
    ``colsize``, ``memcol``, ``s``, ``selfc``, ``nd``, ``hgt``, ``cost``);
    ``rows`` (n, 2) int64 ``[group, row]``; ``cand`` (n, J) ranked columns
    (eligible candidates strictly precede dead/self ones, so position j is
    the j-th eligible candidate while any remain). Returns ``(has, numer,
    denom, z)`` over the n rows: the first candidate of maximal exact
    Saving (strict cross-product compare, so ranked ties keep the earlier
    one), masked to dirty alive rows. Rows go in chunks that bound the
    ``(rows, R)`` temporaries.
    """
    alive, dirty, CNT = state["alive"], state["dirty"], state["CNT"]
    colsize, memcol = state["colsize"], state["memcol"]
    s, selfc, nd = state["s"], state["selfc"], state["nd"]
    hgt, cost = state["hgt"], state["cost"]
    n, J = cand.shape
    R = CNT.shape[2]
    alive_cnt = (alive > 0).sum(dim=1, dtype=torch.int32)
    outs = [(torch.zeros(0, dtype=torch.bool, device=CNT.device),
             torch.zeros(0, dtype=torch.int32, device=CNT.device),
             torch.zeros(0, dtype=torch.int32, device=CNT.device),
             torch.zeros(0, dtype=torch.int64, device=CNT.device))]
    step = max(1, _BUDGET // max(1, R))
    for r0 in range(0, n, step):
        rb = rows[r0:r0 + step, 0]
        rr = rows[r0:r0 + step, 1]
        cd = cand[r0:r0 + step].to(torch.int64)
        m = rb.shape[0]
        j_row = torch.clamp(alive_cnt[rb] - 1, max=top_j)
        cnt_r = CNT[rb, rr]
        colsize_r = colsize[rb]
        ca = memcol[rb, rr].to(torch.int64)
        s_r, selfc_r, nd_r = s[rb, rr], selfc[rb, rr], nd[rb, rr]
        hgt_r, cost_r = hgt[rb, rr], cost[rb, rr]
        has = torch.zeros(m, dtype=torch.bool, device=CNT.device)
        n_b = torch.ones(m, dtype=torch.int32, device=CNT.device)
        d_b = torch.ones(m, dtype=torch.int32, device=CNT.device)
        z_b = torch.zeros(m, dtype=torch.int64, device=CNT.device)
        for j in range(J):
            idx = cd[:, j]
            numer, denom = row_saving_terms(
                cnt_r, CNT[rb, idx], colsize_r, ca,
                memcol[rb, idx].to(torch.int64), s_r, s[rb, idx], selfc_r,
                selfc[rb, idx], nd_r, nd[rb, idx], cost_r, cost[rb, idx])
            valid = ((alive[rb, idx] > 0) & (idx != rr) & (j < j_row)
                     & (denom > 0))
            if height_bound is not None:
                new_h = torch.maximum(hgt_r, hgt[rb, idx]) + 1
                valid = valid & (new_h <= int(height_bound))
            take = valid & (~has | prod_lt(numer, d_b, n_b, denom))
            n_b = torch.where(take, numer, n_b)
            d_b = torch.where(take, denom, d_b)
            z_b = torch.where(take, idx, z_b)
            has = has | take
        has = has & (dirty[rb, rr] > 0) & (alive[rb, rr] > 0)
        outs.append((has, n_b, d_b, z_b))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def fold_counts(state: dict, b, a, z) -> None:
    """Apply one round's accepted pairs (row z into row a of group b; all
    three ``(m,)`` int64 on the device) to the count state IN PLACE.

    The phases follow the host fold (`BatchedGroupWorkspace.apply_merges`)
    exactly: capture every pre-round term first, fold CNT rows then CNT
    columns, update the per-row stats, then the incremental cost update of
    every row plus the exact recompute of the merged rows. Within a round
    the pairs of one group are disjoint in rows and member columns, so no
    scatter here sees a duplicate index.
    """
    CNT, colsize, memcol = state["CNT"], state["colsize"], state["memcol"]
    s, selfc, nd, hgt = state["s"], state["selfc"], state["nd"], state["hgt"]
    cost = state["cost"]
    G = CNT.shape[1]
    rows = torch.arange(G, device=CNT.device)[None, :]
    bc = b[:, None]
    ca = memcol[b, a].to(torch.int64)
    cz = memcol[b, z].to(torch.int64)

    # phase 0: captures before any write (gathers copy)
    s_new = s[b, a] + s[b, z]
    cab = CNT[b, a, cz]
    s_b = s[b]                                                   # (m, G)
    old_ca = pair_cost_c(CNT[bc, rows, ca[:, None]],
                         poss_pair_c(s_b, colsize[b, ca][:, None]))
    old_cz = pair_cost_c(CNT[bc, rows, cz[:, None]],
                         poss_pair_c(s_b, colsize[b, cz][:, None]))

    # phase 1: CNT rows fold, then columns fold
    CNT[b, a] += CNT[b, z]
    CNT[b, z] = 0
    CNT[bc, rows, ca[:, None]] += CNT[bc, rows, cz[:, None]]
    CNT[bc, rows, cz[:, None]] = 0
    CNT[b, a, ca] = 0

    # phase 2: per-row stats
    colsize[b, ca] = s_new
    colsize[b, cz] = 0
    selfc[b, a] = selfc[b, a] + selfc[b, z] + cab
    nd[b, a] = nd[b, a] + nd[b, z] + 2
    hgt[b, a] = torch.maximum(hgt[b, a], hgt[b, z]) + 1
    s[b, a] = s_new
    state["alive"][b, z] = 0
    state["dirty"][b, z] = 0
    state["dirty"][b, a] = 1

    # phase 3: incremental cost update of every row + merged-row recompute
    new_ca = pair_cost_c(CNT[bc, rows, ca[:, None]],
                         poss_pair_c(s[b], colsize[b, ca][:, None]))
    cost.index_add_(0, b, new_ca - old_ca - old_cz)
    s_a = s[b, a]
    crow = pair_cost_c(CNT[b, a], poss_pair_c(s_a[:, None], colsize[b])).sum(
        dim=1, dtype=torch.int32)
    crow = crow + pair_cost_c(selfc[b, a], poss_self_c(s_a)) + nd[b, a]
    cost[b, a] = crow
    cost[b, z] = 0
