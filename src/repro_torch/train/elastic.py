"""Elastic scaling: move a live state onto a different mesh (the JAX
package's `train/elastic.py`).

When the rank pool changes (a node lost, or added back), the caller builds
a mesh over the ranks that remain (`make_mesh_for`), derives the specs
against it — the divisibility guards adapt: a dim that split 4 ways may
replicate on 3 — and `remesh_state` moves every leaf onto its new spec
with its values unchanged. Data-pipeline determinism makes the transition
exact: ``batch(step)`` is pure in (seed, step) whatever the mesh. A train
state under a model axis moves the same way, as `Placed` leaves under
`train.train_step.state_specs` — its parameters' model blocks and its
moments' ZeRO-1 slices are blocks under their specs — between meshes
with different model axes.

A leaf placed on a mesh is a `Placed`: this rank's block of the global
tensor under its spec (None on a rank outside the mesh), with the global
shape beside it — what a jax array on a ``NamedSharding`` is to its
devices. Every rank of the world runs `make_mesh_for` and `remesh_state`
alike (SPMD), members of the meshes or not: building a mesh creates
process groups, and the move broadcasts each block from the first rank
that holds it, on the rank's device (`launch.mesh.rank_device`: its card
under NCCL, the CPU under gloo), as the reference's ``device_put`` leaves
the blocks on the new mesh's devices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_device_type, mesh_sizes, rank_device


class Placed(NamedTuple):
    """A leaf on ``mesh`` under ``spec``: ``local`` is this rank's block
    (None off the mesh); ``shape`` and ``dtype`` are the global tensor's."""
    local: Optional[torch.Tensor]
    spec: tuple
    mesh: object
    shape: tuple
    dtype: torch.dtype


def make_mesh_for(ranks, model_parallel: int, axis_names=("data", "model")):
    """A ``(data, model)`` `DeviceMesh` over ``ranks``: the model axis as
    large as ``model_parallel`` allows while dividing the rank count, the
    data axis what is left; surplus ranks stay out. Every rank of the
    world must call it."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(ranks)
    n = len(ranks)
    model = min(model_parallel, n)
    while n % model:
        model -= 1
    data = n // model
    grid = torch.tensor(ranks[: data * model]).view(data, model)
    return DeviceMesh(mesh_device_type(), grid, mesh_dim_names=axis_names)


def _coords(mesh, rank: int) -> Optional[dict]:
    """``{axis: index}`` of ``rank`` in ``mesh``, or None off it."""
    hit = (mesh.mesh == rank).nonzero()
    if hit.numel() == 0:
        return None
    return dict(zip(mesh.mesh_dim_names, hit[0].tolist()))


def _blocks(spec: tuple, shape: tuple, mesh, coords: dict) -> tuple:
    """The slices of ``shape`` that the rank at ``coords`` holds under
    ``spec`` (`models.sharding.local_block`)."""
    from repro_torch.models.sharding import local_block

    return local_block(shape, spec, mesh_sizes(mesh), coords)


def place(full: torch.Tensor, spec: tuple, mesh) -> Placed:
    """``full`` (the same on every rank) placed on ``mesh`` under
    ``spec``: each member keeps its block."""
    coords = _coords(mesh, dist.get_rank())
    local = (None if coords is None else
             full[_blocks(spec, tuple(full.shape), mesh, coords)].clone())
    return Placed(local, tuple(spec), mesh, tuple(full.shape), full.dtype)


def gather_full(leaf: Placed, device=None) -> torch.Tensor:
    """The global tensor of ``leaf`` on every rank of the world, on
    ``device`` (default: the rank's device on ``leaf.mesh``,
    `rank_device`): each distinct block is broadcast from the first rank
    of the mesh holding it."""
    device = rank_device(leaf.mesh, device)
    full = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    me = dist.get_rank()
    seen = set()
    for r in leaf.mesh.mesh.flatten().tolist():
        blk = _blocks(leaf.spec, leaf.shape, leaf.mesh,
                      _coords(leaf.mesh, r))
        key = tuple((s.start, s.stop) for s in blk)
        if key in seen:
            continue
        seen.add(key)
        buf = (leaf.local.contiguous() if me == r else
               torch.empty([s.stop - s.start for s in blk],
                           dtype=leaf.dtype, device=device))
        dist.broadcast(buf, src=r)
        full[blk] = buf
    return full


def remesh_state(state, new_mesh, spec_fn, device=None):
    """``spec_fn(state, mesh)`` gives a spec tree for ``new_mesh`` (it may
    read each leaf's ``.shape``); every leaf of ``state`` — a `Placed`, or
    a tensor every rank holds whole — comes back a `Placed` on
    ``new_mesh`` under its spec, values unchanged. Collective over the
    world. ``device`` is where the blocks travel and stay: by default the
    rank's device on ``new_mesh`` (`rank_device`: the current card under
    NCCL, the CPU under gloo). A device the group cannot carry raises."""
    specs = spec_fn(state, new_mesh)
    device = rank_device(new_mesh, device)

    def move(leaf, spec):
        if isinstance(leaf, dict):
            return {k: move(leaf[k], spec[k]) for k in sorted(leaf)}
        full = (gather_full(leaf, device) if isinstance(leaf, Placed)
                else leaf.to(device))
        return place(full, spec, new_mesh)

    return move(state, specs)
