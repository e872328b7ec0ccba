"""Carry a graph, a summary or LM weights across from plain arrays.

SLUGGER learns no parameters: the graph and the summary are its state, and
the first two constructors play the role weight conversion plays for a
model; `params_from_arrays` carries the LM substrate's weights and
`train_state_from_arrays` a whole train state (weights, AdamW moments and
step count). All take plain NumPy arrays — never objects of another
package — so a summary, a model or a training run written by the JAX
package continues here, and the other way round.
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


def params_from_arrays(cfg, tree, device=None, mesh=None,
                       dp_axes=("data",), coords=None) -> dict:
    """The port's LM parameters from the nested dict of arrays that the
    reference's ``init_params`` gives (``np.asarray`` of each leaf, layers
    stacked on a leading L axis), for every ported family (the
    encoder-decoder's tree too): same tree, same shapes, same values and
    dtypes (an SSM's ``A_log``, ``D`` and ``dt_bias`` stay float32 in a
    bf16 model, as the MoE router does), on ``device`` (``None``: the
    CUDA card, which must exist). With a ``mesh`` (a `DeviceMesh`, or a
    ``{axis: size}`` mapping with the rank's ``coords``), only the rank's
    block of each leaf (`models.sharding.param_pspecs`) is carried.
    Raises when the tree does not have the shapes ``cfg`` implies."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import param_shapes

    shapes = param_shapes(cfg)
    blocks = None
    if mesh is not None:
        coords = SH.mesh_coords(mesh) if coords is None else coords
        sizes = SH.mesh_sizes(mesh)
        specs = SH.param_pspecs(cfg, shapes, sizes, dp_axes)
        blocks = SH._map_with_path(
            lambda path, shape: SH.local_block(
                shape, SH.at(specs, path), sizes, coords), shapes)
    return _carry(shapes, tree, resolve_device(device), "params", blocks)


def _carry(spec, node, dev, path, blocks=None):
    """``node``'s arrays as tensors on ``dev`` in the tree of shapes
    ``spec`` (each cut to its slices in ``blocks`` where given); raises
    where the keys or a shape differ."""
    if isinstance(spec, dict):
        if not isinstance(node, dict) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, dict) else type(node)
            raise ValueError(f"{path}: keys {got} != {sorted(spec)}")
        return {k: _carry(spec[k], node[k], dev, f"{path}/{k}",
                          None if blocks is None else blocks[k])
                for k in spec}
    shape = tuple(np.shape(node))
    if shape != spec:
        raise ValueError(f"{path}: shape {shape} != {spec}")
    return _tensor(node if blocks is None else np.asarray(node)[blocks], dev)


def train_state_from_arrays(cfg, tree, device=None) -> dict:
    """The port's train state (`train.train_step.init_state`'s tree) from
    the reference's, as numpy: ``{"params": ..., "opt": {"m": ..., "v":
    ..., "step": ()}}``, the moments in their own dtype (float32, or
    bfloat16 under ``moment_dtype="bfloat16"``) and the step count int32,
    on ``device`` (``None``: the CUDA card, which must exist). Raises
    where a tree's keys or a shape differ from ``cfg``'s parameters."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.models.api import param_shapes

    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    opt = tree["opt"]
    step = _tensor(opt["step"], dev)
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"opt/step: {step.dtype} {tuple(step.shape)} is "
                         f"not an int32 scalar")
    return {"params": params_from_arrays(cfg, tree["params"], device=dev),
            "opt": {"m": _carry(shapes, opt["m"], dev, "opt/m"),
                    "v": _carry(shapes, opt["v"], dev, "opt/v"),
                    "step": step}}
