"""Deterministic synthetic graph generators.

The paper evaluates on 16 downloaded web-scale graphs; offline we mirror their
*regimes* (social / hyperlink / collaboration / PPI) with seeded generators so
every benchmark is reproducible bit-for-bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    # sample via geometric skipping over the upper-triangle index space
    max_pairs = n * (n - 1) // 2
    expected = int(max_pairs * p)
    # oversample then dedupe (fine for the sparse regimes we use)
    k = int(expected * 1.2) + 16
    u = rng.integers(0, n, size=k, dtype=np.int64)
    v = rng.integers(0, n, size=k, dtype=np.int64)
    return Graph.from_edges(n, np.stack([u, v], axis=1))


def barabasi_albert(n: int, m: int, seed: int = 0) -> Graph:
    """Preferential attachment: heavy-tailed degree like social networks."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated = []  # nodes repeated by degree
    edges = []
    for v in range(m, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        # next targets: sample m distinct from `repeated`
        targets = set()
        while len(targets) < m:
            targets.add(repeated[rng.integers(0, len(repeated))])
        targets = list(targets)
    return Graph.from_edges(n, np.array(edges, dtype=np.int64))


def rmat(scale: int, edge_factor: int = 8, a=0.57, b=0.19, c=0.19, seed: int = 0) -> Graph:
    """R-MAT / Kronecker-style generator (hyperlink-like, scale-free, communities)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    d = 1.0 - a - b - c
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(m)
        # quadrant probabilities: (0,0)=a, (0,1)=b, (1,0)=c, (1,1)=d
        bit_src = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        p_right = np.where(bit_src == 0, b / (a + b), d / (c + d))
        bit_dst = (r2 < p_right).astype(np.int64)
        src = src * 2 + bit_src
        dst = dst * 2 + bit_dst
    return Graph.from_edges(n, np.stack([src, dst], axis=1))


def planted_hierarchy(
    branching: tuple = (4, 4, 4),
    leaf_size: int = 8,
    densities: tuple = (0.02, 0.12, 0.5, 0.95),
    seed: int = 0,
) -> Graph:
    """Recursive planted partition: the regime SLUGGER is designed for.

    ``branching=(b1,..,bk)`` builds a k-level community tree; two leaves at
    lowest-common-ancestor level L are connected with prob ``densities[L]``
    (level 0 = root, level k = same leaf-community). ``densities`` must be
    increasing: deeper common ancestor => denser, i.e. students of the same
    advisor are more connected than students of the same university.
    """
    rng = np.random.default_rng(seed)
    n_groups = int(np.prod(branching))
    n = n_groups * leaf_size
    # community path of each node, as digits
    labels = np.zeros((n, len(branching)), dtype=np.int64)
    g = np.arange(n) // leaf_size
    for i in range(len(branching) - 1, -1, -1):
        labels[:, i] = g % branching[i]
        g = g // branching[i]
    edges = []
    # sample block-wise: iterate over pairs of groups (n_groups is small)
    group_labels = labels[::leaf_size]
    for gi in range(n_groups):
        for gj in range(gi, n_groups):
            lca = 0
            for lev in range(len(branching)):
                if group_labels[gi, lev] == group_labels[gj, lev]:
                    lca += 1
                else:
                    break
            p = densities[lca if gi != gj else len(branching)]
            if p <= 0:
                continue
            if gi == gj:
                pairs = [(u, v) for u in range(leaf_size) for v in range(u + 1, leaf_size)]
            else:
                pairs = [(u, v) for u in range(leaf_size) for v in range(leaf_size)]
            mask = rng.random(len(pairs)) < p
            base_i, base_j = gi * leaf_size, gj * leaf_size
            for (u, v), keep in zip(pairs, mask):
                if keep:
                    edges.append((base_i + u, base_j + v))
    return Graph.from_edges(n, np.array(edges, dtype=np.int64) if edges else np.zeros((0, 2)))


def caveman(n_cliques: int, clique_size: int, rewire: float = 0.05, seed: int = 0) -> Graph:
    """Connected caveman graph: cliques + sparse rewiring (collaboration-like)."""
    rng = np.random.default_rng(seed)
    n = n_cliques * clique_size
    edges = []
    for c in range(n_cliques):
        base = c * clique_size
        for u in range(clique_size):
            for v in range(u + 1, clique_size):
                edges.append((base + u, base + v))
    edges = np.array(edges, dtype=np.int64)
    k = int(len(edges) * rewire)
    if k:
        idx = rng.choice(len(edges), size=k, replace=False)
        edges[idx, 1] = rng.integers(0, n, size=k)
    return Graph.from_edges(n, edges)


def star_of_cliques(n_hubs: int, sat_per_hub: int, seed: int = 0) -> Graph:
    """Hub-and-spoke (internet-topology-like)."""
    rng = np.random.default_rng(seed)
    edges = []
    node = n_hubs
    for h in range(n_hubs):
        for _ in range(sat_per_hub):
            edges.append((h, node))
            node += 1
        if h:
            edges.append((h, rng.integers(0, h)))
    return Graph.from_edges(node, np.array(edges, dtype=np.int64))


def bipartite_nested(n_left: int, n_right: int, levels: int = 3, seed: int = 0) -> Graph:
    """Nested (hierarchically complete) bipartite graph — the Theorem-1 regime
    where hierarchical encodings are asymptotically smaller than flat ones."""
    edges = []
    # right node j at "depth" d(j) connects to the left prefix [0, n_left >> d(j));
    # prefixes are nested, so the hierarchical model encodes each right-depth
    # class with O(1) p-edges while the flat model needs per-node corrections.
    for j in range(n_right):
        depth = min(levels - 1, int(np.log2(j + 1)))
        for u in range(n_left >> depth):
            edges.append((u, n_left + j))
    return Graph.from_edges(n_left + n_right, np.array(edges, dtype=np.int64))


# Named serving-scale graphs, the same presets the JAX package's serving
# launcher uses. Keys name the edge count.
SERVING_GRAPHS = {
    "smoke": lambda: caveman(40, 8, 0.05, seed=0),
    "55k": lambda: caveman(1000, 11, 0.03, seed=0),
    "220k": lambda: caveman(4000, 11, 0.03, seed=0),
}


def sample_subgraph(g: Graph, n_nodes: int, seed: int = 0) -> Graph:
    """Random induced subgraph (used for the Fig. 1(b) scalability series)."""
    rng = np.random.default_rng(seed)
    nodes = rng.choice(g.n, size=min(n_nodes, g.n), replace=False)
    return g.subgraph(np.sort(nodes))


# ---------------------------------------------------------------------------
# Streamed emission (bounded-memory ingestion, DESIGN.md §8)
# ---------------------------------------------------------------------------
def as_chunks(edges: np.ndarray, chunk_edges: int = 1 << 18):
    """Yield an in-memory (m, 2) edge array in bounded chunks — the adapter
    that lets any eager generator feed `PartitionedGraph.from_edge_stream`."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    for s in range(0, edges.shape[0], chunk_edges):
        yield edges[s:s + chunk_edges]


def stream_edges(g: Graph, chunk_edges: int = 1 << 18):
    """Yield a built graph's undirected edge list in chunks (tests/replay)."""
    yield from as_chunks(g.edge_list(), chunk_edges)


def rmat_stream(scale: int, edge_factor: int = 8, a=0.57, b=0.19, c=0.19,
                seed: int = 0, chunk_edges: int = 1 << 18):
    """Streamed R-MAT: emit the edge list in bounded chunks without ever
    materializing it whole. Each chunk draws from its own `SeedSequence`
    child, so the stream is deterministic per (seed, chunk_edges) and chunks
    can in principle be generated independently (out-of-core / parallel
    ingestion). Dedup/symmetrization is the consumer's job —
    `PartitionedGraph.from_edge_stream` applies the same cleaning as
    `Graph.from_edges`.
    """
    n = 1 << scale
    m = n * edge_factor
    d = 1.0 - a - b - c
    n_chunks = (m + chunk_edges - 1) // chunk_edges
    children = np.random.SeedSequence(seed).spawn(max(n_chunks, 1))
    for ci in range(n_chunks):
        k = min(chunk_edges, m - ci * chunk_edges)
        rng = np.random.default_rng(children[ci])
        src = np.zeros(k, dtype=np.int64)
        dst = np.zeros(k, dtype=np.int64)
        for _ in range(scale):
            r = rng.random(k)
            bit_src = (r >= a + b).astype(np.int64)
            r2 = rng.random(k)
            p_right = np.where(bit_src == 0, b / (a + b), d / (c + d))
            bit_dst = (r2 < p_right).astype(np.int64)
            src = src * 2 + bit_src
            dst = dst * 2 + bit_dst
        yield np.stack([src, dst], axis=1)
