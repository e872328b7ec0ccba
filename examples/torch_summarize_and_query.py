"""Graph algorithms ON the compressed representation (paper §VIII-C), on
the PyTorch/CUDA port: BFS and PageRank access the graph only via
neighbor queries, which the hierarchical summary answers directly
(partial decompression).

  PYTHONPATH=src python examples/torch_summarize_and_query.py [--device cpu]

The summary is built on the CUDA card (the default) or, with ``--device
cpu``, by the kernels' plain versions; the queries run on the host.
"""
import argparse
import time
from collections import deque

import numpy as np

from repro_torch.core import summarize
from repro_torch.graphs import datasets


def bfs_on_summary(summary, src):
    seen = {src}
    q = deque([src])
    order = []
    while q:
        u = q.popleft()
        order.append(u)
        for v in summary.neighbors(u):
            if int(v) not in seen:
                seen.add(int(v))
                q.append(int(v))
    return order


def pagerank_on_summary(summary, n, iters=10, d=0.85):
    r = np.full(n, 1.0 / n)
    nbrs = [summary.neighbors(u) for u in range(n)]
    deg = np.array([max(len(x), 1) for x in nbrs])
    for _ in range(iters):
        new = np.zeros(n)
        for u in range(n):
            new[nbrs[u]] += r[u] / deg[u]
        r = d * new + (1 - d) / n
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    g = datasets.load("PR")  # protein-like stand-in: SLUGGER's best regime
    print(f"dataset PR: {g.n} nodes, {g.m} edges")
    s = summarize(g, T=10, seed=0, device=args.device)
    print(f"summary cost {s.cost()} (relative {s.relative_size(g):.3f}), "
          f"lossless={s.validate_lossless(g)}")

    t0 = time.perf_counter()
    order = bfs_on_summary(s, 0)
    print(f"BFS on the summary reached {len(order)} nodes in "
          f"{time.perf_counter() - t0:.3f}s")

    t0 = time.perf_counter()
    pr = pagerank_on_summary(s, g.n)
    print(f"PageRank on the summary: {time.perf_counter() - t0:.2f}s; "
          f"top-5 nodes: {np.argsort(-pr)[:5].tolist()}")
    return s, order, pr


if __name__ == "__main__":
    main()
