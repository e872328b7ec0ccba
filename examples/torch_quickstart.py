"""Quickstart on the PyTorch/CUDA port: summarize a graph with SLUGGER,
verify losslessness, inspect.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The merge engine's kernels run on the CUDA card (the default); ``--device
cpu`` runs their plain PyTorch versions instead.
"""
import argparse

from repro_torch.core import baselines, summarize
from repro_torch.graphs import generators as GG


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    # a hierarchically-structured graph (communities in communities)
    g = GG.planted_hierarchy((4, 4), 10, (0.01, 0.35, 0.95), seed=7)
    print(f"input graph: {g.n} nodes, {g.m} edges")

    summary = summarize(g, T=20, seed=0, verbose=True, device=args.device)

    print("\nlossless:", summary.validate_lossless(g))
    st = summary.stats(g)
    print(f"encoding cost |P+|+|P-|+|H| = {st['cost']}  (relative size "
          f"{st['relative_size']:.3f})")
    print(f"composition: {summary.composition()}")
    print(f"hierarchy: max height {st['max_height']}, avg leaf depth "
          f"{st['avg_leaf_depth']:.2f}")

    # compare with the flat state-of-the-art (SWEG), on the host
    sw = baselines.sweg(g, T=20, seed=0)
    print(f"\nSWEG (flat) relative size: {sw.relative_size(g):.3f}  "
          f"→ SLUGGER is "
          f"{100 * (1 - st['relative_size'] / sw.relative_size(g)):.1f}% "
          f"smaller")

    # partial decompression: neighbors straight off the summary (Algorithm 4)
    u = 3
    print(f"\nneighbors({u}) via partial decompression:",
          summary.neighbors(u)[:12], "...")
    if set(summary.neighbors(u)) != set(int(v) for v in g.neighbors(u)):
        raise RuntimeError(f"neighbors({u}) differ from the input graph's")
    print("matches the input graph exactly.")
    return summary


if __name__ == "__main__":
    main()
