"""Merging step (Algorithm 2): greedy in-group merging by Saving (Eq. 8).

Two engines, both recording their decisions into `MergePlan`s:

* `_sweep_sequential` over a `GroupWorkspace` — the sequential loop: pick a
  random root A, rank partners by packed-bitmap Jaccard, evaluate the exact
  Saving for the top-J, merge when ``Saving(A, B) ≥ θ(t)``. It runs
  ``backend="loop"`` and every group larger than ``_BATCH_MAX_GROUP``.

* `BatchedGroupWorkspace.sweep` — the batched group-merge engine (DESIGN.md
  §3): groups are size-bucketed, their neighbor bitmaps packed into one
  ``(B, G, W)`` batch, and every round's candidate ranking comes from the
  CURRENT bitmaps through a rank source — `HostRankSource`, a chunked
  NumPy popcount (``backend="numpy"``) or the CUDA intersection kernel
  (``backend="batched"``), or `ResidentRankSource`, whose device arena
  (`core/resident.py`) ranks, scores and accepts on the card
  (``backend="resident"``). Ranking uses the quantized integer Jaccard key
  (`rank_keys`) so every source orders candidates bit-identically; each
  group then runs vectorized Algorithm-2 sweeps: every dirty row's top-J
  partners are scored by the exact Saving in one array op, and a
  conflict-free random subset of the proposed mergers is applied per round.

The Saving is the flat 2-level cost estimate SWEG uses; the hierarchy's
benefit is realized by the optimal encoding DP at emission time, which also
makes every engine lossless by construction regardless of merge order.
"""
from __future__ import annotations

import functools
import logging

import numpy as np

from repro_torch import faults
from repro_torch.core.bitops import popcount


def _pair_cost(cnt, poss):
    """min(cnt, poss − cnt + 1), which is 0 at cnt == 0 (vectorized).

    Valid inputs satisfy 0 ≤ cnt ≤ poss, so poss − cnt + 1 ≥ 1 and the
    single `minimum` already lands on 0 for absent pairs — no mask needed.
    """
    return np.minimum(cnt, poss - cnt + 1)


# ---------------------------------------------------------------------------
# Integer-exact Saving contract (DESIGN.md §9)
#
# The batched sweep evaluates Savings as exact integer rationals, the same
# contract the JAX package's device round op keeps, so the two packages
# agree BIT-FOR-BIT:
#   * "possible pairs" terms are clamped at C_CLAMP with expressions that
#     equal min(product, C_CLAMP) exactly on both sides; the workspace build
#     guards that real costs stay far below the clamp (exactness, not just
#     agreement — see `BatchedGroupWorkspace._fill`);
#   * the Saving-vs-best comparison is the cross-product n_j·d_b < n_b·d_j
#     (int64), strict so ranked ties keep the earlier candidate;
#   * θ is quantized to θ̂ = P/2^THETA_SHIFT and accepted by the integer
#     inequality (d − n)·2^20 ≥ P·d. θ = 0 → P = 0 accepts Saving ≥ 0, so
#     the final iteration is exact.
# ---------------------------------------------------------------------------
C_CLAMP = 1 << 30
THETA_SHIFT = 20


def theta_to_p(theta: float) -> int:
    """Quantize θ to the integer acceptance parameter P (every backend
    applies the SAME P, so the quantization never splits backends)."""
    import math

    p = int(math.ceil(float(theta) * (1 << THETA_SHIFT)))
    return min(max(p, 0), 1 << THETA_SHIFT)


def theta_accept_host(numer, denom, theta_p: int):
    """Saving ≥ θ̂ as the exact integer test. numer/denom < 2^31, so the
    products stay below 2^51."""
    numer = np.asarray(numer, dtype=np.int64)
    denom = np.asarray(denom, dtype=np.int64)
    return ((denom > 0) & (numer <= denom)
            & ((denom - numer) << THETA_SHIFT >= np.int64(theta_p) * denom))


def poss_pair_i(s, colsize):
    """min(s·colsize, C_CLAMP) in int64."""
    return np.minimum(np.asarray(s, dtype=np.int64)
                      * np.asarray(colsize, dtype=np.int64), C_CLAMP)


def poss_self_i(s):
    """min(s·(s−1)/2, C_CLAMP) in int64 (s·(s−1) is always even)."""
    s = np.asarray(s, dtype=np.int64)
    return np.minimum(s * (s - 1) // 2, C_CLAMP)


# ---------------------------------------------------------------------------
# Candidate ranking: quantized integer Jaccard keys (DESIGN.md §9)
# ---------------------------------------------------------------------------
_RANK_KEY_BITS = 15


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Elementwise bit length of non-negative ints < 2^31 (5-step binary
    search)."""
    b = np.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        t = v >> s
        big = t > 0
        b += np.where(big, s, 0)
        v = np.where(big, t, v)
    return b + (v > 0)


def rank_keys(inter: np.ndarray, deg_r, deg_c) -> np.ndarray:
    """Quantized-Jaccard integer ranking keys in ``[0, 2^15]``.

    Shift intersection and union down together until the union fits 15
    bits, then take the exact integer quotient — shift and integer-divide
    only, so every backend produces the SAME key for the same bitmaps (no
    float division whose rounding could differ across backends). Ranking is (key desc, column asc): the quantization
    only coarsens which near-equal candidates tie; the tie-break keeps the
    order total and deterministic, which is what the cross-backend
    bit-identity needs (DESIGN.md §9).
    """
    inter = inter.astype(np.int64)
    union = np.asarray(deg_r + deg_c - inter, dtype=np.int64)
    sh = np.maximum(0, _bit_length(union) - _RANK_KEY_BITS)
    return ((inter >> sh) << _RANK_KEY_BITS) // np.maximum(union >> sh, 1)


def _row_intersections(bits: np.ndarray, rb: np.ndarray,
                       rr: np.ndarray) -> np.ndarray:
    """(n, G) intersection popcounts of rows (rb[i], rr[i]) against every
    column row of their group, chunked so the (chunk, G, W) temp stays
    within the memory budget."""
    n = rb.size
    _, G, W = bits.shape
    out = np.empty((n, G), dtype=np.int64)
    chunk = max(1, int(_MEM_BUDGET // max(1, G * W * 8)))
    for s0 in range(0, n, chunk):
        gb = rb[s0:s0 + chunk]
        rows = bits[gb, rr[s0:s0 + chunk]]
        out[s0:s0 + chunk] = popcount(
            rows[:, None, :] & bits[gb]).sum(axis=-1, dtype=np.int64)
    return out


# ---------------------------------------------------------------------------
# Shard-local merge plans (DESIGN.md §8)
# ---------------------------------------------------------------------------
class MergePlan:
    """Ordered merge decisions of ONE candidate group, recorded shard-local.

    ``rounds[r] = (a_rows, z_rows)`` are disjoint local row pairs (indices
    into ``members0``, the row → global-root map at build time); a pair in
    round r+1 may reference a row merged in rounds ≤ r. Recording instead of
    mutating the global state is what makes partition-parallel sweeps safe:
    workspaces decide everything locally, and `apply_plans` replays all
    groups' rounds against `SluggerState` in ONE canonical order — so the
    minted parent ids (and therefore the summary) are bit-identical however
    the groups were sharded or scheduled.
    """

    __slots__ = ("members0", "rounds")

    def __init__(self, members0: np.ndarray):
        self.members0 = np.asarray(members0, dtype=np.int64)
        self.rounds: list = []

    def record(self, a_rows: np.ndarray, z_rows: np.ndarray):
        self.rounds.append((np.asarray(a_rows, dtype=np.int64).copy(),
                            np.asarray(z_rows, dtype=np.int64).copy()))

    @property
    def n_merges(self) -> int:
        return sum(a.size for a, _ in self.rounds)

    # -- checkpoint serialization (core/checkpoint.py) ---------------------
    def to_state(self) -> dict:
        """Plain-dict form for the plan-log checkpoint — decoupled from the
        class layout so the on-disk format is versioned independently."""
        return {"members0": self.members0,
                "rounds": [(a, z) for a, z in self.rounds]}

    @classmethod
    def from_state(cls, state: dict) -> "MergePlan":
        plan = cls(state["members0"])
        for a, z in state["rounds"]:
            plan.rounds.append((np.asarray(a, dtype=np.int64),
                                np.asarray(z, dtype=np.int64)))
        return plan


def apply_plans(state, plans: list, on_batch=None) -> int:
    """Exchange stage: replay recorded merge rounds in canonical order.

    Round r applies every group's r-th recorded round in plan-list order via
    ONE ``merge_batch`` — all pairs are disjoint (rounds are matchings and
    candidate groups partition the alive roots). Only the forward/root
    pointers and freshly minted parents flow back; the decisions themselves
    never re-read global state, so the replay is scheduling-independent.
    Returns the number of merges applied.

    ``on_batch(A, Z, M)`` (optional) observes each applied round: the
    global ids merged (A absorbs Z) and the minted parents M — the resident
    run context replays exactly these on the device
    (`core/resident.ResidentRunContext.advance`).
    """
    cur = [p.members0.copy() for p in plans]
    merges = 0
    r = 0
    while True:
        As, Zs, backrefs = [], [], []
        for gi, p in enumerate(plans):
            if r < len(p.rounds):
                a_rows, z_rows = p.rounds[r]
                As.append(cur[gi][a_rows])
                Zs.append(cur[gi][z_rows])
                backrefs.append((gi, a_rows))
        if not As:
            break
        A = np.concatenate(As)
        Z = np.concatenate(Zs)
        M = state.merge_batch(A, Z)
        if on_batch is not None:
            on_batch(A, Z, M)
        off = 0
        for gi, a_rows in backrefs:
            cur[gi][a_rows] = M[off:off + a_rows.size]
            off += a_rows.size
        merges += M.size
        r += 1
    return merges


def _mix64(seed: np.ndarray, round_no: int, rows: np.ndarray) -> np.ndarray:
    """Counter-based per-proposal priority: splitmix64 of (group seed, round,
    proposing row), with the row id appended in the low bits so priorities
    are UNIQUE within a group — randomized-priority matching then never ties,
    and the outcome is a pure function of (group, round, row), independent of
    how groups were chunked or sharded."""
    round_mix = np.uint64(((round_no + 1) * 0x9E3779B97F4A7C15) & (2**64 - 1))
    x = seed.astype(np.uint64) ^ round_mix
    x = x + rows.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x << np.uint64(8)) | rows.astype(np.uint64)  # rows < 256 = 2*G_max


class GroupWorkspace:
    """Dense group-local view: rows = group members, cols = neighbor roots.

    Construction is one `state.gather_rows` + `np.unique` — no Python loops
    over adjacency. Columns are the union of the members and their (resolved)
    neighbor roots, in sorted-id order; members always own a column.
    """

    def __init__(self, state, group, plan: MergePlan):
        self.state = state
        self.plan = plan  # decisions are recorded here, never applied
        members = np.asarray(group, dtype=np.int64)
        k = members.size
        self.members = members.tolist()  # global root ids (updated on merge)
        seg, nbr, cnt = state.gather_rows(members)
        ids = np.concatenate([members, nbr])
        uniq, inv = np.unique(ids, return_inverse=True)
        R = uniq.size
        self.col_gid = uniq.astype(np.int64)
        self.memcol = inv[:k].astype(np.int64)
        colidx = inv[k:].astype(np.int64)
        # exact edge counts, kept in int64
        self.CNT = np.zeros((k, R), dtype=np.int64)
        self.CNT[seg, colidx] = cnt
        self.s = state.size[members].astype(np.int64)
        self.colsize = state.size[self.col_gid].astype(np.int64)
        self.selfc = state.selfcnt[members].astype(np.int64)
        self.nd = state.ndesc[members].astype(np.int64)
        self.hgt = state.height[members].astype(np.int64)
        self.alive = np.ones(k, dtype=bool)
        # packed bitmaps over columns for Jaccard ranking
        W = (R + 63) // 64
        self.bits = np.zeros((k, max(W, 1)), dtype=np.uint64)
        if colidx.size:
            np.bitwise_or.at(
                self.bits, (seg, colidx >> 6),
                np.uint64(1) << (colidx & 63).astype(np.uint64),
            )
        self.cost_row = self._full_cost_rows()

    # -- cost bookkeeping --------------------------------------------------
    def _row_pair_costs(self, rows):
        cnt = self.CNT[rows]
        poss = self.s[rows, None] * self.colsize[None, :]
        c = _pair_cost(cnt, poss)
        # self/own columns never contribute (cnt to self column is 0 anyway)
        return c

    def _full_cost_rows(self):
        c = self._row_pair_costs(np.arange(len(self.members)))
        out = c.sum(axis=1)
        out += _pair_cost(self.selfc, self.s * (self.s - 1) // 2)
        out += self.nd
        return out

    def _recompute_row(self, i: int):
        c = _pair_cost(self.CNT[i], self.s[i] * self.colsize)
        poss_self = self.s[i] * (self.s[i] - 1) // 2
        self.cost_row[i] = c.sum() + _pair_cost(np.array([self.selfc[i]]), np.array([poss_self]))[0] + self.nd[i]

    # -- partner ranking -----------------------------------------------------
    def rank_to(self, a: int, cand: np.ndarray) -> np.ndarray:
        """Quantized integer Jaccard ranking keys of `cand` against row `a`
        (same `rank_keys` contract the batched rankers use — no
        float division anywhere in the decision path)."""
        inter = popcount(self.bits[a][None, :] & self.bits[cand]).sum(axis=1, dtype=np.int64)
        da = popcount(self.bits[a]).sum(dtype=np.int64)
        dz = popcount(self.bits[cand]).sum(axis=1, dtype=np.int64)
        return rank_keys(inter, da, dz)

    # -- exact Saving (Eq. 8) -------------------------------------------------
    def saving_terms(self, a: int, cand: np.ndarray, height_bound=None):
        """Integer Saving terms ``(numer, denom, valid)`` with
        ``Saving = 1 − numer/denom``: the sequential twin of
        `BatchedGroupWorkspace.saving_terms_rows`. Everything stays int64
        (no C_CLAMP here — the dense view never squares group sizes past
        the arena bound), so sweeps can compare Savings as exact rationals."""
        merged = self.CNT[a][None, :] + self.CNT[cand]
        s_m = self.s[a] + self.s[cand]
        poss = s_m[:, None] * self.colsize[None, :]
        cost_cols = _pair_cost(merged, poss)
        ca, cz = self.memcol[a], self.memcol[cand]
        # edges to A or Z become internal to the merged node
        total = cost_cols.sum(axis=1) - cost_cols[:, ca] - cost_cols[np.arange(len(cand)), cz]
        cab = self.CNT[a, cz]
        self_m = self.selfc[a] + self.selfc[cand] + cab
        poss_self = s_m * (s_m - 1) // 2
        total += _pair_cost(self_m, poss_self)
        numer = total + self.nd[a] + self.nd[cand] + 2
        pair_c = _pair_cost(cab, self.s[a] * self.s[cand])
        denom = self.cost_row[a] + self.cost_row[cand] - pair_c
        valid = denom > 0
        if height_bound is not None:
            new_h = np.maximum(self.hgt[a], self.hgt[cand]) + 1
            valid &= new_h <= height_bound
        return numer.astype(np.int64), denom.astype(np.int64), valid

    def savings(self, a: int, cand: np.ndarray, height_bound=None) -> np.ndarray:
        """Float VIEW of `saving_terms` (diagnostics and the approximate
        `distributed.summarize_jax` engine); no exact decision reads it."""
        numer, denom, valid = self.saving_terms(a, cand, height_bound)
        sav = np.where(  # lint: disable=INT-RANK-ONLY -- float view of the integer terms; exact sweeps compare saving_terms rationals instead
            valid, 1.0 - numer / np.maximum(denom, 1), -np.inf)
        return sav

    # -- merge ---------------------------------------------------------------
    def merge(self, a: int, z: int):
        """Record the merge of member z into member a and fold the local
        tensors; `apply_plans` applies it to the global state later."""
        ca, cz = int(self.memcol[a]), int(self.memcol[z])
        s_new = self.s[a] + self.s[z]
        # contributions of columns ca/cz to every row's cost, before update
        old_ca = _pair_cost(self.CNT[:, ca], self.s * self.colsize[ca])
        old_cz = _pair_cost(self.CNT[:, cz], self.s * self.colsize[cz])
        cab = self.CNT[a, cz]
        self.plan.record(np.array([a]), np.array([z]))
        self.members[a] = -1
        self.col_gid[ca] = -1
        # local rows
        self.CNT[a] += self.CNT[z]
        self.CNT[z] = 0
        # local columns
        self.CNT[:, ca] += self.CNT[:, cz]
        self.CNT[:, cz] = 0
        self.CNT[a, ca] = 0
        self.colsize[ca] = s_new
        self.colsize[cz] = 0
        self.selfc[a] = self.selfc[a] + self.selfc[z] + cab
        self.nd[a] = self.nd[a] + self.nd[z] + 2
        self.hgt[a] = max(self.hgt[a], self.hgt[z]) + 1
        self.s[a] = s_new
        self.alive[z] = False
        # bitmaps: fold column cz into ca, then OR rows
        wa, ba = ca >> 6, np.uint64(ca & 63)
        wz, bz = cz >> 6, np.uint64(cz & 63)
        zbit = (self.bits[:, wz] >> bz) & np.uint64(1)
        self.bits[:, wa] |= zbit << ba
        self.bits[:, wz] &= ~(np.uint64(1) << bz)
        self.bits[a] |= self.bits[z]
        self.bits[z] = 0
        # row a has no bit for its own column
        self.bits[a, wa] &= ~(np.uint64(1) << ba)
        # incremental cost updates for all rows (columns ca, cz changed)
        new_ca = _pair_cost(self.CNT[:, ca], self.s * self.colsize[ca])
        self.cost_row += new_ca - old_ca - old_cz
        self._recompute_row(a)


# ---------------------------------------------------------------------------
# Sequential engine
# ---------------------------------------------------------------------------
def _sweep_sequential(ws: GroupWorkspace, theta: float,
                      rng: np.random.Generator, top_j: int = 16,
                      height_bound=None) -> int:
    """Algorithm 2 over one built workspace. Returns the number of merges.

    Decisions are integer-exact end to end: candidates are ranked by the
    quantized `rank_keys`, the best partner is the exact-rational argmax of
    the `saving_terms` fractions (cross-product compare, strict `<` so ties
    keep the earlier-ranked candidate), and acceptance is the quantized
    θ̂ = P/2^THETA_SHIFT integer inequality — the same contract the batched
    sweep applies, so oversized groups that fall back to this path merge
    identically under every backend.
    """
    k = len(ws.members)
    queue = list(rng.permutation(k))
    theta_p = theta_to_p(theta)
    merges = 0
    while len(queue) > 1:
        a = queue.pop()
        if not ws.alive[a]:
            continue
        cand = np.array([q for q in queue if ws.alive[q]], dtype=np.int64)
        if cand.size == 0:
            break
        if cand.size > top_j:
            keys = ws.rank_to(a, cand)
            cand = cand[np.argsort(-keys, kind="stable")[:top_j]]
        numer, denom, valid = ws.saving_terms(a, cand,
                                              height_bound=height_bound)
        # exact rational argmax of 1 − n/d over the valid candidates:
        # Python ints, so the cross products can't overflow int64
        best = -1
        n_b = d_b = 0
        for j in range(cand.size):
            if not valid[j]:
                continue
            n_j, d_j = int(numer[j]), int(denom[j])
            if best < 0 or n_j * d_b < n_b * d_j:
                best, n_b, d_b = j, n_j, d_j
        if best >= 0 and n_b <= d_b and (
                (d_b - n_b) << THETA_SHIFT) >= theta_p * d_b:
            z = int(cand[best])
            ws.merge(a, z)
            queue = [q for q in queue if q != z]
            queue.insert(0, a)  # merged node rejoins Q (Alg. 2 line 8)
            merges += 1
    return merges


def process_group(
    state,
    group,
    theta: float,
    rng: np.random.Generator,
    top_j: int = 16,
    height_bound=None,
    plan: MergePlan | None = None,
) -> int:
    """Algorithm 2 over one candidate set. Returns the number of merges.

    With ``plan`` given the sweep records its decisions there (each as its
    own single-pair round) and leaves ``state`` alone; without one they are
    recorded into a fresh plan and applied to ``state`` at once
    (`apply_plans`), merge by merge in the sweep's order — the state the
    JAX package's live sweep leaves, parent ids included."""
    record = plan if plan is not None else MergePlan(group)
    ws = GroupWorkspace(state, group, plan=record)
    merges = _sweep_sequential(ws, theta, rng, top_j=top_j,
                               height_bound=height_bound)
    if plan is None:
        apply_plans(state, [record])
    return merges


# ---------------------------------------------------------------------------
# Batched group-merge engine
# ---------------------------------------------------------------------------
_MEM_BUDGET = 128 << 20  # bound on any (B, G, R)-shaped float64 temporary


class HostRankSource:
    """Per-round candidate ranking over the workspace's host-folded bitmaps.

    ``dispatch`` (optional) computes the (B, G, G) intersection tensor on a
    device — the CUDA kernel ops (`_default_intersections_dispatch`).
    Without it the intersections come from a chunked host popcount
    restricted to the dirty rows. Either way the integer intersections —
    and therefore the ranked order — are identical, so a dispatch failed by
    an injected fault (`faults.InjectedFault`) degrades (DESIGN.md §11):
    it is recorded as ``"rank.dispatch"`` and the source ranks on the host
    popcount for the rest of its life. Any other failure raises.
    """

    def __init__(self, dispatch=None):
        self.dispatch = dispatch

    def ranked(self, ws, rb, rr, j_max):
        if self.dispatch is not None:
            try:
                inter_all = self.dispatch(ws.bits.view(np.uint32))  # (B, G, G)
            except faults.InjectedFault as e:
                faults.DEGRADATIONS.record("rank.dispatch", e)
                logging.getLogger("repro_torch.engine").warning(
                    "rank dispatch failed, degrading to host popcount: %r", e)
                self.dispatch = None
        if self.dispatch is not None:
            deg = np.diagonal(inter_all, axis1=1, axis2=2)
            inter = inter_all[rb, rr]
        else:
            deg = popcount(ws.bits).sum(axis=-1, dtype=np.int64)
            inter = _row_intersections(ws.bits, rb, rr)
        keys = rank_keys(inter, deg[rb, rr][:, None], deg[rb])
        keys[~ws.alive[rb]] = -1                   # dead candidates last …
        keys[np.arange(rb.size), rr] = -1          # … along with self
        # deterministic total order: key desc, ties by asc column (stable)
        order = np.argsort(-keys, axis=1, kind="stable")
        return order[:, :j_max]

    def propose(self, ws, rb, rr, j_max, theta_p, height_bound):
        """Each dirty row's best proposal from host-ranked candidates: the
        exact rational argmax in ranked order (Saving_j > best ⟺
        numer_j·denom_best < numer_best·denom_j, strict, so ties keep the
        earlier-ranked candidate), then θ̂ acceptance. Each row sees at
        most ``alive − 1`` candidates of its own group."""
        part = self.ranked(ws, rb, rr, j_max)                      # (n, j)
        numer, denom, valid = ws.saving_terms_rows(
            rb, rr, part, height_bound=height_bound)
        j_row = np.minimum(j_max, ws.alive.sum(axis=1)[rb] - 1)
        valid &= ws.alive[rb[:, None], part] & (part != rr[:, None])
        valid &= np.arange(j_max)[None, :] < j_row[:, None]
        n_flat = rb.size
        has = np.zeros(n_flat, dtype=bool)
        n_b = np.ones(n_flat, dtype=np.int64)
        d_b = np.ones(n_flat, dtype=np.int64)
        best_z = np.zeros(n_flat, dtype=np.int64)
        for j in range(j_max):
            take = valid[:, j] & (
                ~has | (numer[:, j] * d_b < n_b * denom[:, j]))
            n_b = np.where(take, numer[:, j], n_b)
            d_b = np.where(take, denom[:, j], d_b)
            best_z = np.where(take, part[:, j], best_z)
            has |= take
        return has & theta_accept_host(n_b, d_b, theta_p), best_z

    def on_merges(self, ws, b, a, z):
        ws.fold_host(b, a, z)


class ResidentRankSource:
    """Fused device proposals from a resident arena (`core/resident.py`):
    ranking, exact integer Saving and θ̂ acceptance run in one device round
    over the arena's bitmaps AND count tensors, and the fold runs there
    too, so the workspace's host tensors go stale (the sweep never reads
    them again; only liveness and the plan stay on the host). Per round
    ``(accept, partner)`` per dirty row comes down and the accepted pairs
    go up. The arena ranks its own J = min(top_j, G − 1) columns, so
    ``j_max`` is not needed here."""

    def __init__(self, arena):
        self.arena = arena

    def propose(self, ws, rb, rr, j_max, theta_p, height_bound):
        return self.arena.propose_rows(rb, theta_p, height_bound)

    def on_merges(self, ws, b, a, z):
        self.arena.fold_counts(b, a, z)


class BatchedGroupWorkspace:
    """All groups of a size bucket as one set of padded tensors.

    B groups of ≤ G members become ``CNT (B, G, R)``, ``bits (B, G, W)``,
    ``cost_row (B, G)`` … where R is the widest per-group column universe in
    the batch. Construction is ONE `state.gather_rows` over every member of
    every group plus one keyed `np.unique` — per-group column spaces are the
    segments of the sorted (group, id) key stream. Merging applies a whole
    round of disjoint pairs at once: local tensors fold with fancy-indexed
    array ops and the global state applies `merge_batch` (DESIGN.md §3).

    A ``shell`` workspace (the resident bank path) keeps ``R`` as the
    logical column width but allocates the per-column tensors zero-wide:
    the device arena extracts them from the adjacency bank.
    """

    def __init__(self, state, B: int, G: int, R: int, shell: bool = False):
        self.state = state
        self.B, self.G, self.R = B, G, R
        self.shell = shell
        Rw = 0 if shell else R
        self.plans: list = []  # per-local-group MergePlan targets
        self.gseed = np.zeros(B, dtype=np.uint64)  # per-group priority seeds
        self.memcol = np.zeros((B, G), dtype=np.int64)
        self.members = np.full((B, G), -1, dtype=np.int64)
        # CNT holds exact subedge counts in int32; the scalar per-row stats
        # are int64 so host cross-products in the Saving comparison stay
        # exact without widening casts.
        self.CNT = np.zeros((B, G, Rw), dtype=np.int32)
        self.col_gid = np.full((B, Rw), -1, dtype=np.int64)
        self.colsize = np.zeros((B, Rw), dtype=np.int64)
        self.s = np.zeros((B, G), dtype=np.int64)
        self.selfc = np.zeros((B, G), dtype=np.int64)
        self.nd = np.zeros((B, G), dtype=np.int64)
        self.hgt = np.zeros((B, G), dtype=np.int64)
        self.alive = np.zeros((B, G), dtype=bool)
        self.bits = np.zeros((B, G, max((Rw + 63) // 64, 1)),
                             dtype=np.uint64)
        self.cost_row = np.zeros((B, G), dtype=np.int64)

    def _fill(self, mb, mr, mc, gids, eb, er, ec, ecnt, cb, cc, cgid):
        """Populate the tensors from (member, entry, column) index streams."""
        st = self.state
        self.memcol[mb, mr] = mc
        self.members[mb, mr] = gids
        self.s[mb, mr] = st.size[gids]
        self.selfc[mb, mr] = st.selfcnt[gids]
        self.nd[mb, mr] = st.ndesc[gids]
        self.hgt[mb, mr] = st.height[gids]
        self.alive[mb, mr] = True
        if self.shell:
            # the bank extraction builds CNT/bits/colsize/cost on the
            # device; the bank's conservation bound subsumes the guards
            return
        if ecnt.size and int(ecnt.max()) >= np.iinfo(np.int32).max:
            raise OverflowError(
                f"subedge count {int(ecnt.max())} exceeds the int32 CNT "
                f"tensor; the batched workspaces cannot represent this graph")
        self.CNT[eb, er, ec] = ecnt
        self.col_gid[cb, cc] = cgid
        self.colsize[cb, cc] = st.size[cgid]
        if ec.size:
            np.bitwise_or.at(
                self.bits, (eb, er, ec >> 6),
                np.uint64(1) << (ec & 63).astype(np.uint64),
            )
        # flat 2-level cost of every row (padding rows cost 0 → proposal
        # invalid), with the CLAMPED possible-pair terms of the integer
        # Saving contract
        cnt64 = self.CNT.astype(np.int64)
        cost = _pair_cost(cnt64, poss_pair_i(self.s[:, :, None],
                                             self.colsize[:, None, :])).sum(axis=-1)
        cost += _pair_cost(self.selfc, poss_self_i(self.s))
        cost += self.nd
        cost[~self.alive] = 0
        # guard the clamp: exactness of the Saving needs real costs well
        # below it
        if cost.size and int(cost.max()) >= C_CLAMP:
            raise OverflowError(
                f"row cost {int(cost.max())} reached the integer-Saving "
                f"clamp C_CLAMP=2^30; the exact-Saving contract no longer "
                f"holds for this graph")
        self.cost_row = cost

    @staticmethod
    def build_bucket(state, groups: list, G: int, plans: list,
                     group_seeds, shell: bool = False) -> list:
        """One gather + keyed unique for ALL groups of a size bucket, then
        workspaces chunked so column universes within a chunk are within 2×
        of each other and the (B, G, R) tensors respect the memory budget —
        a narrow group never pays a wide group's padding.

        ``plans``/``group_seeds`` (aligned with ``groups``) receive each
        group's decisions and seed its deterministic priorities."""
        B = len(groups)
        ks = np.array([len(g) for g in groups], dtype=np.int64)
        members_flat = np.concatenate([np.asarray(g, dtype=np.int64) for g in groups])
        grp_of_member = np.repeat(np.arange(B), ks)
        row_in_group = np.arange(members_flat.size) - np.repeat(np.cumsum(ks) - ks, ks)
        seg, nbr, cnt = state.gather_rows(members_flat)
        # per-group column universes: segments of the sorted (group, id) keys
        big = np.int64(state.n_ids + 1)
        keys = np.concatenate([
            grp_of_member * big + members_flat,
            grp_of_member[seg] * big + nbr,
        ])
        uniq, inv = np.unique(keys, return_inverse=True)
        col_grp = (uniq // big).astype(np.int64)
        col_bounds = np.searchsorted(col_grp, np.arange(B + 1))
        R_b = np.diff(col_bounds)
        colidx = inv - col_bounds[col_grp[inv]]
        nm = members_flat.size

        # chunk groups into R-homogeneous, memory-bounded classes
        chunk_of_group = np.zeros(B, dtype=np.int64)
        newb_of_group = np.zeros(B, dtype=np.int64)
        chunks: list = []  # (group_count, Rmax)
        cur_n = cur_first = cur_max = 0
        for g in np.argsort(R_b, kind="stable"):
            r = int(R_b[g])
            if cur_n and ((cur_n + 1) * G * max(cur_max, r) * 8 > _MEM_BUDGET
                          or r > 2 * max(cur_first, 32)):
                chunks.append((cur_n, cur_max))
                cur_n = cur_max = 0
            if cur_n == 0:
                cur_first = r
            chunk_of_group[g] = len(chunks)
            newb_of_group[g] = cur_n
            cur_n += 1
            cur_max = max(cur_max, r)
        if cur_n:
            chunks.append((cur_n, cur_max))

        mem_chunk = chunk_of_group[grp_of_member]
        ent_grp = grp_of_member[seg]
        ent_chunk = chunk_of_group[ent_grp]
        col_chunk = chunk_of_group[col_grp]
        col_pos = np.arange(uniq.size) - col_bounds[col_grp]
        out: list = []
        for ci, (bc, rc) in enumerate(chunks):
            ws = BatchedGroupWorkspace(state, bc, G, max(int(rc), 1),
                                       shell=shell)
            msel = mem_chunk == ci
            esel = ent_chunk == ci
            csel = col_chunk == ci
            ws._fill(
                newb_of_group[grp_of_member[msel]], row_in_group[msel],
                colidx[:nm][msel], members_flat[msel],
                newb_of_group[ent_grp[esel]], row_in_group[seg[esel]],
                colidx[nm:][esel], cnt[esel],
                newb_of_group[col_grp[csel]], col_pos[csel], (uniq % big)[csel],
            )
            gsel = np.flatnonzero(chunk_of_group == ci)
            ws.gseed[newb_of_group[gsel]] = np.asarray(
                group_seeds, dtype=np.uint64)[gsel]
            pl = [None] * bc
            for gidx in gsel:
                pl[int(newb_of_group[gidx])] = plans[int(gidx)]
            ws.plans = pl
            out.append(ws)
        return out

    # -- exact Saving (Eq. 8), every alive row's top-J in one op -----------
    def saving_terms_rows(self, rb: np.ndarray, rr: np.ndarray,
                          cands: np.ndarray, height_bound=None):
        """Integer Saving terms of merging row (rb[i], rr[i]) with members
        ``cands[i, j]``: ``(numer, denom, valid)`` int64/(bool), each (n, J),
        where Saving = 1 − numer/denom and ``valid`` masks defined terms
        (denom > 0, height bound respected).

        Rows are flat (alive rows only, across all groups of the batch);
        chunked so the (chunk, J, R) temps stay bounded.
        """
        R = self.R
        n, J = cands.shape
        numer_o = np.empty((n, J), dtype=np.int64)
        denom_o = np.empty((n, J), dtype=np.int64)
        valid_o = np.empty((n, J), dtype=bool)
        chunk = max(1, int(_MEM_BUDGET // max(1, J * R * 8 * 4)))
        for s0 in range(0, n, chunk):
            b = rb[s0:s0 + chunk]
            r = rr[s0:s0 + chunk]
            c = cands[s0:s0 + chunk]
            bj = b[:, None]
            cnt_r = self.CNT[b, r].astype(np.int64)                # (m, R)
            merged = cnt_r[:, None, :] + self.CNT[bj, c]           # (m, J, R)
            s_r = self.s[b, r]
            s_c = self.s[bj, c]                                    # (m, J)
            s_m = s_r[:, None] + s_c
            poss = poss_pair_i(s_m[..., None], self.colsize[b][:, None, :])
            cost_cols = _pair_cost(merged, poss)
            ca = self.memcol[b, r]                                 # (m,)
            cz = self.memcol[bj, c]                                # (m, J)
            total = cost_cols.sum(axis=-1)
            total -= np.take_along_axis(
                cost_cols, np.broadcast_to(ca[:, None, None], (b.size, J, 1)), axis=2)[..., 0]
            total -= np.take_along_axis(cost_cols, cz[..., None], axis=2)[..., 0]
            cab = np.take_along_axis(cnt_r, cz, axis=1)            # (m, J)
            self_m = self.selfc[b, r][:, None] + self.selfc[bj, c] + cab
            total += _pair_cost(self_m, poss_self_i(s_m))
            numer = total + self.nd[b, r][:, None] + self.nd[bj, c] + 2
            pair_c = _pair_cost(cab, poss_pair_i(s_r[:, None], s_c))
            denom = self.cost_row[b, r][:, None] + self.cost_row[bj, c] - pair_c
            valid = denom > 0
            if height_bound is not None:
                new_h = np.maximum(self.hgt[b, r][:, None], self.hgt[bj, c]) + 1
                valid &= new_h <= height_bound
            numer_o[s0:s0 + chunk] = numer
            denom_o[s0:s0 + chunk] = denom
            valid_o[s0:s0 + chunk] = valid
        return numer_o, denom_o, valid_o

    def savings_rows(self, rb: np.ndarray, rr: np.ndarray, cands: np.ndarray,
                     height_bound=None) -> np.ndarray:
        """Float view of `saving_terms_rows` (benchmark/diagnostic use; the
        sweep itself compares the integer terms exactly)."""
        numer, denom, valid = self.saving_terms_rows(
            rb, rr, cands, height_bound=height_bound)
        return np.where(  # lint: disable=INT-RANK-ONLY -- float view of the integer terms; the sweep compares saving_terms_rows rationals instead
            valid, 1.0 - numer / np.maximum(denom, 1), -np.inf)

    # -- batched merge application -----------------------------------------
    def apply_merges(self, b: np.ndarray, a: np.ndarray, z: np.ndarray):
        """Record a round of disjoint pairs (row z into row a of group b)
        and its liveness. The rank source folds the tensors (`on_merges`):
        `fold_host` here, or the device arena of the resident backend —
        a shell workspace has none to fold."""
        if b.size == 0:
            return
        # one recorded round per group (b arrives sorted ascending); the
        # global state applies it later in `apply_plans`
        head = np.concatenate([[0], np.flatnonzero(b[1:] != b[:-1]) + 1,
                               [b.size]])
        for s0, e0 in zip(head[:-1], head[1:]):
            self.plans[int(b[s0])].record(a[s0:e0], z[s0:e0])
        self.members[b, a] = -1
        self.members[b, z] = -1
        self.alive[b, z] = False

    def fold_host(self, b: np.ndarray, a: np.ndarray, z: np.ndarray):
        """Fold row z into row a of group b in the host count tensors and
        bitmaps, for a round of disjoint pairs."""
        if b.size == 0:
            return
        G = self.G
        ca = self.memcol[b, a]
        cz = self.memcol[b, z]
        s_new = self.s[b, a] + self.s[b, z]
        old_ca = _pair_cost(self.CNT[b, :, ca],
                            poss_pair_i(self.s[b], self.colsize[b, ca][:, None]))
        old_cz = _pair_cost(self.CNT[b, :, cz],
                            poss_pair_i(self.s[b], self.colsize[b, cz][:, None]))
        cab = self.CNT[b, a, cz].astype(np.int64)
        self.col_gid[b, ca] = -1
        self.col_gid[b, cz] = -1
        # rows fold, then columns fold
        self.CNT[b, a] += self.CNT[b, z]
        self.CNT[b, z] = 0
        self.CNT[b, :, ca] += self.CNT[b, :, cz]
        self.CNT[b, :, cz] = 0
        self.CNT[b, a, ca] = 0
        self.colsize[b, ca] = s_new
        self.colsize[b, cz] = 0
        self.selfc[b, a] += self.selfc[b, z] + cab
        self.nd[b, a] += self.nd[b, z] + 2
        self.hgt[b, a] = np.maximum(self.hgt[b, a], self.hgt[b, z]) + 1
        self.s[b, a] = s_new
        # bitmaps: fold column cz into ca for all rows, then OR rows.
        # Two pairs of the SAME group can fold columns living in the
        # same 64-bit word, so the word-level updates must be unbuffered
        # (.at) — plain fancy `|=`/`&=` would clobber one fold with the
        # other.
        one = np.uint64(1)
        wa, ba = (ca >> 6), (ca & 63).astype(np.uint64)
        wz, bz = (cz >> 6), (cz & 63).astype(np.uint64)
        rows = np.broadcast_to(np.arange(G), (b.size, G))
        bcol = np.broadcast_to(b[:, None], (b.size, G))
        zbit = (self.bits[b, :, wz] >> bz[:, None]) & one
        np.bitwise_or.at(
            self.bits,
            (bcol, rows, np.broadcast_to(wa[:, None], (b.size, G))),
            zbit << ba[:, None])
        np.bitwise_and.at(
            self.bits,
            (bcol, rows, np.broadcast_to(wz[:, None], (b.size, G))),
            np.broadcast_to((~(one << bz))[:, None], (b.size, G)))
        np.bitwise_or.at(self.bits, (b, a), self.bits[b, z])
        self.bits[b, z] = 0
        # row a has no bit for its own column
        self.bits[b, a, wa] &= ~(one << ba)
        # incremental cost update for all rows (columns ca, cz changed) …
        new_ca = _pair_cost(self.CNT[b, :, ca],
                            poss_pair_i(self.s[b], self.colsize[b, ca][:, None]))
        np.add.at(self.cost_row, (b,), new_ca - old_ca - old_cz)
        # … and exact recomputation for the merged rows (absorbed rows die)
        crow = _pair_cost(self.CNT[b, a].astype(np.int64),
                          poss_pair_i(self.s[b, a][:, None], self.colsize[b])).sum(axis=-1)
        crow += _pair_cost(self.selfc[b, a], poss_self_i(self.s[b, a]))
        self.cost_row[b, a] = crow + self.nd[b, a]
        self.cost_row[b, z] = 0

    # -- the sweep ---------------------------------------------------------
    def sweep(self, theta: float, ranker, top_j: int = 16,
              height_bound=None) -> int:
        """Vectorized Algorithm-2 rounds over the whole batch.

        Per round: every DIRTY row's ranked top-J partners — by quantized
        integer Jaccard key over the CURRENT bitmaps, via ``ranker``
        (`HostRankSource` on the host bitmaps, or `ResidentRankSource`,
        which proposes from its device arena) — are scored
        with the exact Saving in one array op; the proposals are thinned to
        a conflict-free set by randomized-priority matching (a proposal
        wins iff it holds the minimum priority at both endpoints — the
        global minimum always wins, so rounds make progress) and applied in
        one batched fold. The dirty set mirrors the sequential queue: every
        row starts dirty, a row whose best Saving falls below θ leaves it
        for good, a merged survivor re-enters it ("merged node rejoins Q"),
        and a row that lost the matching retries next round.

        Every random choice is a counter-based hash of (group seed, round,
        row), and the candidate ranking is a per-row total order (key desc,
        column asc, dead/self last) recomputed from the round's bitmap
        state, so a group's outcome is a pure function of its own tensors —
        independent of which chunk or rank source swept it.
        """
        B, G = self.B, self.G
        merges = 0
        dirty = self.alive.copy()
        alive_cnt = self.alive.sum(axis=1)
        theta_p = theta_to_p(theta)
        round_no = 0
        while G > 1 and dirty.any():
            # J adapts to the largest alive group for array sizing; each row
            # is masked to its OWN group's alive count below, so the chunk
            # composition never leaks into a group's candidate set
            j_max = min(top_j, int(alive_cnt.max()) - 1)
            if j_max < 1:
                break
            rb, rr = np.nonzero(dirty)
            prop, best_z = ranker.propose(self, rb, rr, j_max, theta_p,
                                          height_bound)
            dirty[rb[~prop], rr[~prop]] = False
            if not prop.any():
                break
            gb, ar, zr = rb[prop], rr[prop], best_z[prop]
            # randomized-priority conflict resolution over node keys: a
            # proposal wins iff it holds the min priority at both endpoints;
            # priorities are row-unique, so there are never ties
            p = _mix64(self.gseed[gb], round_no, ar)
            a_key = gb * G + ar
            z_key = gb * G + zr
            winner = np.full(B * G, np.iinfo(np.uint64).max, dtype=np.uint64)
            np.minimum.at(winner, a_key, p)
            np.minimum.at(winner, z_key, p)
            acc = (winner[a_key] == p) & (winner[z_key] == p)
            ab, am, az = gb[acc], ar[acc], zr[acc]
            self.apply_merges(ab, am, az)
            ranker.on_merges(self, ab, am, az)
            # survivors rejoin the queue, absorbed rows leave it; losers of
            # the matching stayed dirty and retry next round
            dirty[ab, az] = False
            dirty[ab, am] = True
            np.subtract.at(alive_cnt, ab, 1)
            merges += ab.size
            round_no += 1
        return merges


_BATCH_MAX_GROUP = 128  # larger groups amortize row-level vectorization alone


def _default_intersections_dispatch(device):
    """The device path of ``backend="batched"``: the CUDA intersection
    kernel ops on ``device`` (the kernel's plain version when it is the
    CPU). It never falls back itself: a failure raises to
    `HostRankSource.ranked`, which degrades to the host popcount on an
    injected fault and re-raises anything else."""
    from repro_torch.kernels.bitset_jaccard.ops import (
        batched_pairwise_intersections)
    return functools.partial(batched_pairwise_intersections, device=device)


def build_merge_work(
    state,
    groups: list,
    theta: float,
    *,
    group_seeds: np.ndarray,
    rng_of=None,
    top_j: int = 16,
    height_bound=None,
    backend: str = "numpy",
    device=None,
    rank_dispatch=None,
    resident_factory=None,
    shell_workspaces: bool = False,
):
    """Build record-mode workspaces for one iteration's candidate groups.

    Returns ``(plans, thunks)``: ``plans[i]`` is group i's `MergePlan`;
    each thunk runs one workspace chunk's (or one large group's) ranking +
    sweep entirely against local tensors and returns its merge count.
    Workspaces are built HERE, against the current state snapshot — builds
    stay serial because `gather_rows` compacts arena rows in place — while
    the returned thunks touch no shared state and may run on any schedule.

    ``group_seeds`` are per-group uint64 priority seeds; ``rng_of(i)``
    supplies the queue-permutation generator for groups swept sequentially
    (``backend="loop"`` and oversized groups). ``device`` is where
    ``backend="batched"`` ranks and ``backend="resident"`` keeps its arenas
    (a ``torch.device``). ``rank_dispatch`` overrides the batched
    intersection dispatch (the engine's sharded one under a mesh,
    `core/distributed.batched_intersections_mesh`).
    ``resident_factory(ws)`` builds a chunk's
    `ResidentBitmapArena` for ``backend="resident"``; ``shell_workspaces`` builds the batched chunks as shape-only shells —
    same chunking and member layout, no per-column tensors — for a factory
    that extracts them on the device from the adjacency bank. Oversized
    groups keep their host `GroupWorkspace` sweep either way.
    """
    groups = [np.asarray(g, dtype=np.int64) for g in groups]
    group_seeds = np.asarray(group_seeds, dtype=np.uint64)
    plans = [MergePlan(g) for g in groups]
    if rng_of is None:
        def rng_of(i):
            return np.random.default_rng(group_seeds[i])
    thunks: list = []
    dispatch = None
    if backend == "batched":
        dispatch = rank_dispatch or _default_intersections_dispatch(device)

    def _seq_thunk(ws, rng):
        return lambda: _sweep_sequential(ws, theta, rng, top_j=top_j,
                                         height_bound=height_bound)

    def _batch_thunk(ws):
        def run():
            # the ranker is built at RUN time: a resident arena's upload or
            # extraction belongs to the merge_round stage, not to pack
            ranker = (ResidentRankSource(resident_factory(ws))
                      if backend == "resident" else HostRankSource(dispatch))
            return ws.sweep(theta, ranker, top_j=top_j,
                            height_bound=height_bound)
        return run

    buckets: dict = {}
    for i, grp in enumerate(groups):
        if backend == "loop" or grp.size > _BATCH_MAX_GROUP:
            ws = GroupWorkspace(state, grp, plan=plans[i])
            thunks.append(_seq_thunk(ws, rng_of(i)))
            continue
        buckets.setdefault(1 << max(3, int(grp.size - 1).bit_length()),
                           []).append(i)
    for G in sorted(buckets):
        idxs = buckets[G]
        for ws in BatchedGroupWorkspace.build_bucket(
                state, [groups[i] for i in idxs], G,
                plans=[plans[i] for i in idxs],
                group_seeds=group_seeds[idxs], shell=shell_workspaces):
            thunks.append(_batch_thunk(ws))
    return plans, thunks


def process_groups(
    state,
    groups: list,
    theta: float,
    rng: np.random.Generator,
    top_j: int = 16,
    height_bound=None,
    backend: str = "numpy",
    device=None,
) -> int:
    """Batched engine: all groups of one iteration, bucketed by size
    (`build_merge_work`), every workspace against the state before any of
    this iteration's merges, then the recorded plans replayed in canonical
    order (`apply_plans`). Groups up to ``_BATCH_MAX_GROUP`` members sweep
    in (B, G, ·) batches, larger ones (and every group under ``backend=
    "loop"``) sequentially, drawing their queue orders from ``rng``.
    ``device``: where ``backend="batched"`` ranks (the intersection
    kernel on the card, its plain version on the CPU). Returns the number
    of merges."""
    group_seeds = rng.integers(0, np.iinfo(np.int64).max,
                               size=max(len(groups), 1)).astype(np.uint64)
    plans, thunks = build_merge_work(
        state, groups, theta, group_seeds=group_seeds,
        rng_of=lambda i: rng, top_j=top_j, height_bound=height_bound,
        backend=backend, device=device)
    for thunk in thunks:
        thunk()
    return apply_plans(state, plans)
