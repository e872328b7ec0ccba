"""Carry a graph or a summary across from plain arrays.

SLUGGER learns no parameters: the graph and the summary are its state, and
these two constructors play the role weight conversion plays for a model.
They take plain NumPy arrays — never objects of another package — so a
summary written by the JAX package decompresses here, and the other way
round.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.summary import Summary
from repro_torch.graphs.csr import Graph


def graph_from_arrays(n: int, indptr, indices) -> Graph:
    """A `Graph` from CSR arrays (symmetric, sorted rows, no self-loops)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    if indptr.shape != (int(n) + 1,) or int(indptr[-1]) != indices.size:
        raise ValueError(f"indptr of shape {indptr.shape} does not describe "
                         f"{indices.size} entries over {n} nodes")
    return Graph(int(n), indptr, indices)


def summary_from_arrays(n_leaves: int, parent, edges) -> Summary:
    """A `Summary` from its parent array and (k, 3) signed edge rows."""
    parent = np.asarray(parent, dtype=np.int64).copy()
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 3).copy()
    if parent.shape[0] < int(n_leaves):
        raise ValueError("parent array shorter than the leaf count")
    return Summary(n_leaves=int(n_leaves), parent=parent, edges=edges)
