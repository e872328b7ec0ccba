"""Carry a graph, a summary or LM weights across from plain arrays.

SLUGGER learns no parameters: the graph and the summary are its state, and
the first two constructors play the role weight conversion plays for a
model; `params_from_arrays` carries the LM substrate's weights. All take
plain NumPy arrays — never objects of another package — so a summary or a
model written by the JAX package runs here, and the other way round.
"""
from __future__ import annotations

import numpy as np
import torch

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


def _tensor(a, device) -> torch.Tensor:
    """One array as a tensor. A bfloat16 array (numpy's extension dtype
    named ``bfloat16``, which `torch.from_numpy` refuses) travels as its
    16-bit pattern and is reinterpreted on the torch side."""
    a = np.array(a)  # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_arrays(cfg, tree, device=None) -> dict:
    """The port's LM parameters from the nested dict of arrays that the
    reference's ``init_params`` gives (``np.asarray`` of each leaf, layers
    stacked on a leading L axis), for every ported family (the
    encoder-decoder's tree too): same tree, same shapes, same values and
    dtypes (an SSM's ``A_log``, ``D`` and ``dt_bias`` stay float32 in a
    bf16 model, as the MoE router does), on ``device`` (``None``: the
    CUDA card, which must exist). Raises when the tree does not have the
    shapes ``cfg`` implies."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.models.api import param_shapes

    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def carry(spec, node, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"{sorted(spec)}")
            return {k: carry(spec[k], node[k], f"{path}/{k}") for k in spec}
        t = _tensor(node, dev)
        if tuple(t.shape) != spec:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {spec}")
        return t

    return carry(shapes, tree, "")
