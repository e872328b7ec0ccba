"""Where the paper's technique legitimately touches the LM pillar
(DESIGN.md §Arch-applicability), on the PyTorch/CUDA port: expert
CO-ACTIVATION graphs from MoE router logs are real-world hierarchical
graphs (experts specialize in nested topic clusters) — SLUGGER compresses
them losslessly for storage/analysis.

  PYTHONPATH=src python examples/torch_moe_routing_graph.py [--device cpu]

The router and the summary run on the CUDA card (the default) or, with
``--device cpu``, on the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import summarize
from repro_torch.core.engine import resolve_device
from repro_torch.graphs.csr import Graph
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api


def router_top_experts(params, cfg, toks) -> np.ndarray:
    """Layer 0's router on the tokens ``toks`` (b, s): f32 logits of the
    embedded tokens, softmax, top-k. Returns the (b·s, k) expert ids, most
    probable first."""
    x = params["embed"][toks]
    layer0 = T.layer(params["layers"], 0)
    top_e = MOE.route(layer0["moe"], cfg, x).top_e
    return top_e.reshape(-1, cfg.moe.top_k).cpu().numpy()


def coactivation_graph(top_e: np.ndarray, n_experts: int) -> Graph:
    """Experts co-activated on the same token, one edge a pair."""
    edges = set()
    for row in top_e:
        for i in range(len(row)):
            for j in range(i + 1, len(row)):
                a, b = int(row[i]), int(row[j])
                if a != b:
                    edges.add((min(a, b), max(a, b)))
    return Graph.from_edge_set(n_experts, edges)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    params = get_api(cfg).init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)

    # run the router over a synthetic batch and log expert co-activations
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(8, 64))).to(
        device)
    with torch.no_grad():
        top_e = router_top_experts(params, cfg, toks)
    g = coactivation_graph(top_e, cfg.moe.n_experts)
    print(f"expert co-activation graph: {g.n} experts, {g.m} co-activation "
          f"edges")

    s = summarize(g, T=10, seed=0, device=device)
    print(f"SLUGGER summary: cost {s.cost()} (relative "
          f"{s.relative_size(g):.3f}), lossless={s.validate_lossless(g)}")
    print("NOTE: this is offline analysis/storage — the MoE compute path "
          "itself is untouched (the technique is not a neural-network "
          "layer).")
    return top_e, g, s


if __name__ == "__main__":
    main()
