"""Candidate generation via min-hash shingles (Sect. III-B2).

Roots whose (subnode-level) neighborhoods share their minimum hash value land
in the same candidate set — a 1-permutation min-hash that groups roots within
graph distance ≤ 2 with high probability (mergers at distance ≥ 3 always
increase cost, Lemma 1). Oversized groups are re-shingled with fresh seeds up
to ``max_rehash`` times (paper: 10) and finally split randomly to ≤
``max_group`` (paper: 500).

The engine shingles every backend with the unified u32 family, so numpy
and batched runs group identically. The Mersenne-prime family (`_hash`,
`node_level_min`, `root_shingles`) is `candidate_groups`' shingle for direct
callers, such as the flat baselines (`core/baselines.py`). Everything is
O(|E|) segment array work on the host (argsort/reduceat).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph

_P = (1 << 61) - 1  # Mersenne prime for universal hashing


def _hash(x: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = int(rng.integers(1, _P))
    b = int(rng.integers(0, _P))
    return (a * x.astype(np.int64) + b) % _P


def node_level_min(g: Graph, seed: int) -> np.ndarray:
    """min(h(u), min_{w ∈ N(u)} h(w)) per subnode — one O(|E|) pass."""
    h = _hash(np.arange(g.n), seed)
    nm = h.copy()
    if g.indices.size:
        src = np.repeat(np.arange(g.n), np.diff(g.indptr))
        np.minimum.at(nm, src, h[g.indices])
    return nm


def rootwise_min(values: np.ndarray, root_of: np.ndarray, n_ids: int,
                 sentinel_base: int) -> np.ndarray:
    """Segment-min of per-leaf ``values`` over root ids, with ids owning no
    leaves set to the unique sentinel ``sentinel_base + id`` — outside the
    hash range, so leafless roots never spuriously group."""
    out = np.full(n_ids, -1, dtype=np.int64)
    if root_of.size:
        order = np.argsort(root_of, kind="stable")
        sorted_roots = root_of[order]
        sorted_vals = np.asarray(values, dtype=np.int64)[order]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(sorted_roots)) + 1])
        out[sorted_roots[starts]] = np.minimum.reduceat(sorted_vals, starts)
    missing = np.flatnonzero(out < 0)
    out[missing] = sentinel_base + missing
    return out


def root_shingles(g: Graph, root_of: np.ndarray, seed: int, n_ids=None) -> np.ndarray:
    """shingle(A) = min over leaves u ∈ A of node_level_min(u), indexed by
    root id (size ``n_ids``); ids owning no leaves get ``_P + id``, outside
    the hash range [0, _P)."""
    if n_ids is None:
        n_ids = int(root_of.max()) + 1 if root_of.size else 0
    nm = node_level_min(g, seed)
    return rootwise_min(nm, root_of, n_ids, _P)


def u32_seed_consts(sub_seed: int):
    """The (a, b) uint32 hash constants every path derives from a seed."""
    a = np.uint32((2654435761 * (int(sub_seed) | 1)) & 0xFFFFFFFF)
    b = np.uint32((int(sub_seed) * 0x9E3779B9) & 0xFFFFFFFF)
    return a, b


def hash_u32(x: np.ndarray, a, b) -> np.ndarray:
    """The u32 affine + xorshift-multiply mix."""
    h = x.astype(np.uint32) * np.uint32(a) + np.uint32(b)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    return h


def node_shingles_u32(g: Graph, sub_seed: int) -> np.ndarray:
    """Per-subnode u32 shingle: min(h(u), min over neighbors h(w))."""
    a, b = u32_seed_consts(sub_seed)
    h_self = hash_u32(np.arange(g.n, dtype=np.uint32), a, b)
    seg = np.full(g.n, 0xFFFFFFFF, dtype=np.uint32)
    if g.indices.size:
        src = np.repeat(np.arange(g.n), np.diff(g.indptr))
        np.minimum.at(seg, src, hash_u32(
            np.asarray(g.indices, dtype=np.uint32), a, b))
    return np.minimum(h_self, seg)


def host_shingle_provider(g: Graph):
    """Engine hook: ``for_roots(root_of) -> shingle_fn(sub_seed, n_ids)``,
    per-root u32 shingles with the ``2^32 + id`` leafless-root sentinel."""

    def for_roots(root_of: np.ndarray):
        root_of = np.asarray(root_of, dtype=np.int64)

        def shingle_fn(sub_seed: int, n_ids: int) -> np.ndarray:
            node_sh = node_shingles_u32(g, sub_seed)
            return rootwise_min(node_sh.astype(np.int64), root_of, n_ids,
                                1 << 32)

        return shingle_fn

    return for_roots


def _split_groups(roots: np.ndarray, keys: np.ndarray, sub_keys=None) -> list:
    """Partition ``roots`` by key (optionally refined by ``sub_keys``),
    dropping singletons. Returns a list of int64 arrays."""
    if roots.size < 2:
        return []
    if sub_keys is None:
        order = np.argsort(keys, kind="stable")
        k = keys[order]
        head = np.empty(k.size, dtype=bool)
        head[0] = True
        np.not_equal(k[1:], k[:-1], out=head[1:])
    else:
        order = np.lexsort((sub_keys, keys))
        k, sk = keys[order], sub_keys[order]
        head = np.empty(k.size, dtype=bool)
        head[0] = True
        head[1:] = (k[1:] != k[:-1]) | (sk[1:] != sk[:-1])
    sorted_roots = roots[order]
    bounds = np.flatnonzero(head)
    sizes = np.diff(np.concatenate([bounds, [roots.size]]))
    pieces = np.split(sorted_roots, bounds[1:])
    return [p for p, sz in zip(pieces, sizes) if sz > 1]


def shingle_seed_streams(seed, max_rehash: int):
    """Per-rehash shingle seeds + the split RNG, from spawned children of
    ``seed`` (an int or a ``np.random.SeedSequence``), so distinct (outer
    seed, iteration) pairs can never alias."""
    ss = (seed if isinstance(seed, np.random.SeedSequence)
          else np.random.SeedSequence(seed))
    children = ss.spawn(max_rehash + 2)
    seeds = [int(c.generate_state(1, dtype=np.uint64)[0]) for c in children[:-1]]
    return seeds, np.random.default_rng(children[-1])


def candidate_groups(
    g: Graph,
    root_of: np.ndarray,
    alive_roots: np.ndarray,
    seed,
    shingle_fn,
    max_group: int = 500,
    max_rehash: int = 10,
) -> list:
    """Partition alive roots into candidate sets of size ≤ max_group.

    ``seed`` is an int or a ``SeedSequence`` (engine iterations pass spawned
    streams). ``shingle_fn(sub_seed, n_ids) -> (n_ids,) int64`` computes the
    per-root shingles — `host_shingle_provider` builds the engine's.
    """
    alive_roots = np.asarray(alive_roots, dtype=np.int64)
    if alive_roots.size < 2:
        return []
    n_ids = int(max(int(root_of.max()) if root_of.size else 0, int(alive_roots.max()))) + 1
    seeds, rng = shingle_seed_streams(seed, max_rehash)
    sh = shingle_fn(seeds[0], n_ids)
    pending = _split_groups(alive_roots, sh[alive_roots])

    groups: list = []
    rehash = 0
    while pending:
        oversized = [grp for grp in pending if grp.size > max_group]
        groups.extend(grp for grp in pending if grp.size <= max_group)
        if not oversized:
            break
        rehash += 1
        members = np.concatenate(oversized)
        if rehash > max_rehash:
            # random split to max_group
            gidx = np.repeat(np.arange(len(oversized)), [o.size for o in oversized])
            perm = rng.permutation(members.size)
            members, gidx = members[perm], gidx[perm]
            order = np.argsort(gidx, kind="stable")
            members, gidx = members[order], gidx[order]
            bounds = np.concatenate([[0], np.flatnonzero(np.diff(gidx)) + 1, [gidx.size]])
            for s, e in zip(bounds[:-1], bounds[1:]):
                for i in range(s, e, max_group):
                    chunk = members[i : min(i + max_group, e)]
                    if chunk.size > 1:
                        groups.append(chunk)
            break
        sh2 = shingle_fn(seeds[rehash], n_ids)
        gidx = np.repeat(np.arange(len(oversized)), [o.size for o in oversized])
        pending = _split_groups(members, gidx, sh2[members])
    return groups
