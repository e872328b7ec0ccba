"""Flat graph-summarization baselines the paper compares against (Sect. IV-A).

All three produce the *previous* model G̃ = (S, P, C⁺, C⁻) — the height-≤1
special case of our model — and are evaluated with Eq. (11):
(|P| + |C⁺| + |C⁻| + |H*|) / |E| where |H*| counts root→subnode membership
edges of non-singleton supernodes.

  RANDOMIZED  (Navlakha et al., SIGMOD'08): random node, best 2-hop partner
              by flat saving, merge while positive.
  SWEG        (Shin et al., WWW'19): min-hash candidate groups; within each
              group pick a random node, choose the partner by Jaccard
              similarity, merge when SavingFlat ≥ θ(t) = 1/(1+t).
  SAGS-like   (Khan et al.): pure LSH — merge pairs whose signatures collide,
              no saving evaluation (fastest, least concise).

MoSSo (KDD'20) is a *streaming* algorithm; its offline compression rates are
comparable to SWEG's, so SWEG stands in as the strongest flat competitor here.

The flat summary is represented directly with our `Summary` class (height-1
forest), so Eq. (11) == Eq. (10) and all lossless checks reuse the same code.

This is the JAX package's `core/baselines.py` on the port's host modules:
host numpy and Python sets and dicts, iterated in the same order, so each
summary equals the JAX package's bit for bit. SWEG's candidate groups use
the Mersenne-prime shingle (`core.minhash.root_shingles`).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.minhash import candidate_groups, root_shingles
from repro_torch.core.summary import Summary
from repro_torch.graphs.csr import Graph


class _FlatState:
    """Disjoint supernodes over V with root-level counts (flat model)."""

    def __init__(self, g: Graph):
        self.g = g
        n = g.n
        self.root_of = np.arange(n, dtype=np.int64)
        self.members: dict = {u: [u] for u in range(n)}
        self.adj: dict = {u: {int(v): 1 for v in g.neighbors(u)} for u in range(n)}
        self.selfcnt: dict = {u: 0 for u in range(n)}
        self.size: dict = {u: 1 for u in range(n)}
        self.alive: set = set(range(n))

    def cost_of(self, a: int) -> float:
        s = self.size[a]
        c = sum(
            min(v, s * self.size[b] - v + 1) for b, v in self.adj[a].items()
        )
        sc = self.selfcnt[a]
        if sc:
            c += min(sc, s * (s - 1) // 2 - sc + 1)
        return c

    def pair_cost(self, a: int, b: int) -> float:
        v = self.adj[a].get(b, 0)
        return min(v, self.size[a] * self.size[b] - v + 1) if v else 0

    def merged_cost(self, a: int, b: int) -> float:
        sa, sb = self.size[a], self.size[b]
        s = sa + sb
        cnts: dict = dict(self.adj[a])
        for c, v in self.adj[b].items():
            cnts[c] = cnts.get(c, 0) + v
        cnts.pop(a, None)
        cnts.pop(b, None)
        cost = sum(min(v, s * self.size[c] - v + 1) for c, v in cnts.items() if v)
        sc = self.selfcnt[a] + self.selfcnt[b] + self.adj[a].get(b, 0)
        if sc:
            cost += min(sc, s * (s - 1) // 2 - sc + 1)
        return cost

    def saving(self, a: int, b: int) -> float:
        denom = self.cost_of(a) + self.cost_of(b) - self.pair_cost(a, b)
        if denom <= 0:
            return -np.inf
        return 1.0 - self.merged_cost(a, b) / denom

    def merge(self, a: int, b: int) -> int:
        """Absorb b into a (flat: no new supernode id)."""
        self.members[a].extend(self.members.pop(b))
        self.root_of[np.asarray(self.members[a])] = a
        na, nb = self.adj[a], self.adj.pop(b)
        cab = na.pop(b, 0)
        nb.pop(a, None)
        for c, v in nb.items():
            na[c] = na.get(c, 0) + v
        for c in list(na):
            d = self.adj[c]
            d.pop(b, None)
            d[a] = na[c]
        self.selfcnt[a] = self.selfcnt[a] + self.selfcnt.pop(b) + cab
        self.size[a] = self.size[a] + self.size.pop(b)
        self.alive.discard(b)
        return a

    # ---- flat encoding → Summary ------------------------------------------
    def to_summary(self) -> Summary:
        g = self.g
        n = g.n
        next_id = n
        parent = np.full(n, -1, dtype=np.int64)
        sn_of: dict = {}
        extra_parents: list = []
        for r in self.alive:
            if self.size[r] > 1:
                sid = next_id + len(extra_parents)
                extra_parents.append(-1)
                sn_of[r] = sid
                parent[np.asarray(self.members[r])] = sid
        parent = np.concatenate([parent, np.array(extra_parents, dtype=np.int64)])

        def sid_of(r):
            return sn_of.get(r, r)

        rows = []
        el = g.edge_list()
        ra, rb = self.root_of[el[:, 0]], self.root_of[el[:, 1]]
        # per root pair: choose p-edge + negative corrections, or positives only
        key_pairs: dict = {}
        for (u, v), A, B in zip(el, ra, rb):
            k = (int(min(A, B)), int(max(A, B)))
            key_pairs.setdefault(k, []).append((int(u), int(v)))
        for (A, B), uv in key_pairs.items():
            cnt = len(uv)
            if A == B:
                poss = self.size[A] * (self.size[A] - 1) // 2
            else:
                poss = self.size[A] * self.size[B]
            if poss - cnt + 1 < cnt:  # p-edge + n-corrections
                rows.append((sid_of(A), sid_of(B), 1))
                present = {(min(u, v), max(u, v)) for u, v in uv}
                mem_a, mem_b = self.members[A], self.members[B]
                if A == B:
                    for i, u in enumerate(mem_a):
                        for v in mem_a[i + 1 :]:
                            if (min(u, v), max(u, v)) not in present:
                                rows.append((u, v, -1))
                else:
                    for u in mem_a:
                        for v in mem_b:
                            if (min(u, v), max(u, v)) not in present:
                                rows.append((u, v, -1))
            else:  # positive corrections only
                rows.extend((u, v, 1) for u, v in uv)
        edges = np.array(
            [(min(x, y), max(x, y), s) for x, y, s in rows], dtype=np.int64
        ) if rows else np.zeros((0, 3), dtype=np.int64)
        return Summary(n_leaves=n, parent=parent, edges=edges)


def randomized(g: Graph, seed: int = 0, max_steps=None) -> Summary:
    """RANDOMIZED [12]: repeat {random u; best 2-hop partner; merge if saving>0}."""
    st = _FlatState(g)
    rng = np.random.default_rng(seed)
    unfinished = set(st.alive)
    steps = 0
    limit = max_steps if max_steps is not None else 10 * g.n
    while unfinished and steps < limit:
        steps += 1
        u = int(rng.choice(np.fromiter(unfinished, dtype=np.int64)))
        if u not in st.alive:
            unfinished.discard(u)
            continue
        hop2: set = set()
        for v in st.adj[u]:
            hop2.add(v)
            hop2.update(st.adj[v])
        hop2.discard(u)
        best, best_s = None, 0.0
        for v in hop2:
            s = st.saving(u, v)
            if s > best_s:
                best, best_s = v, s
        if best is None:
            unfinished.discard(u)
        else:
            m = st.merge(u, best)
            unfinished.discard(best)
            unfinished.add(m)
    return st.to_summary()


def sweg(g: Graph, T: int = 20, seed: int = 0, max_group: int = 500) -> Summary:
    """SWEG [2] (ε=0, lossless): minhash groups + Jaccard partner selection."""
    st = _FlatState(g)
    rng = np.random.default_rng(seed)
    for t in range(1, T + 1):
        theta = 0.0 if t == T else 1.0 / (1 + t)
        alive = np.fromiter(st.alive, dtype=np.int64)
        root_of = st.root_of
        groups = candidate_groups(
            g, root_of, alive, seed * 104729 + t,
            lambda sub_seed, n_ids: root_shingles(g, root_of, sub_seed, n_ids),
            max_group=max_group)
        for grp in groups:
            queue = list(rng.permutation(np.asarray(grp)))
            while len(queue) > 1:
                a = int(queue.pop())
                if a not in st.alive:
                    continue
                cand = [int(z) for z in queue if int(z) in st.alive and int(z) != a]
                if not cand:
                    break
                # Jaccard over neighbor-root sets
                na = set(st.adj[a])
                best, best_j = None, -1.0
                for z in cand:
                    nz = set(st.adj[z])
                    inter = len(na & nz)
                    uni = len(na | nz)
                    j = inter / uni if uni else 0.0
                    if j > best_j:
                        best, best_j = z, j
                if best is None:
                    continue
                if st.saving(a, best) >= theta:
                    m = st.merge(a, best)
                    queue = [q for q in queue if int(q) != best]
                    queue.insert(0, m)
    return st.to_summary()


def sags_like(g: Graph, h: int = 30, b: int = 10, p: float = 0.3, seed: int = 0) -> Summary:
    """SAGS-like [27]: LSH banding without saving evaluation — merge signature
    collisions directly (fast, least concise — matches the paper's finding)."""
    st = _FlatState(g)
    rng = np.random.default_rng(seed)
    bands = max(1, h // b)
    for band in range(bands):
        hv = rng.permutation(g.n).astype(np.int64)
        sig = np.full(g.n, np.iinfo(np.int64).max, dtype=np.int64)
        src = np.repeat(np.arange(g.n), np.diff(g.indptr))
        np.minimum.at(sig, src, hv[g.indices])
        buckets: dict = {}
        for r in list(st.alive):
            mem = st.members[r]
            key = int(min(sig[m] for m in mem))
            buckets.setdefault(key, []).append(r)
        for grp in buckets.values():
            grp = [r for r in grp if r in st.alive]
            rng.shuffle(grp)
            for i in range(0, len(grp) - 1, 2):
                if rng.random() < p:
                    st.merge(grp[i], grp[i + 1])
    return st.to_summary()
