"""Device meshes over a `torch.distributed` process group (the JAX
package's `launch/mesh.py`).

A mesh is PyTorch's own `DeviceMesh` with named dims — ``("data",)`` or
``("data", "model")`` — the counterpart of a jax ``Mesh`` with axis names.
Execution is SPMD: one process a device, every rank running the same host
program; host decisions are deterministic, so every rank takes the same
ones, and collectives go through the mesh's sub-groups
(`dp_group`). The package never starts a process group itself: the caller
does (``torchrun``, the tests, ``chip_smoke.py``) with NCCL on the card or
gloo on the CPU, and the mesh's device type follows the group's backend.
Building a mesh without a process group raises.

The model axis (slice E6a: tensor- and expert-parallel serving) runs
over `model_group`. ``make_production_mesh`` (the TPU pod shapes, with
two data axes) waits for slice E6b, with training under a model axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialized: start one "
            "(torchrun, or init_process_group with NCCL on the card, gloo "
            "on the CPU) before building a mesh")


def mesh_device_type() -> str:
    """``"cuda"`` under an NCCL group, ``"cpu"`` under gloo."""
    _require_group()
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _make_mesh(shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n).view(*shape)
    return DeviceMesh(mesh_device_type(), ranks, mesh_dim_names=names)


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a `DeviceMesh`, or of a plain mapping (the
    spec functions take either)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes_of(mesh) -> tuple:
    """All non-'model' axes act as data parallelism."""
    return tuple(a for a in mesh_sizes(mesh) if a != "model")


def make_host_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` mesh over the first ``data · model`` ranks of the
    world, both clamped to the world size as the reference clamps them to
    its devices."""
    _require_group()
    n = dist.get_world_size()
    model = min(model, n)
    data = max(1, min(data, n // model))
    return _make_mesh((data, model), ("data", "model"))


def make_data_mesh():
    """A pure data-parallel mesh over every rank — what the summarization
    engine's sharded shingle, intersection and arena paths shard over
    (`core/engine.SummarizerEngine`)."""
    _require_group()
    return _make_mesh((dist.get_world_size(),), ("data",))


def dp_group(mesh, axes=None):
    """The process group of ``mesh``'s data axes (`dp_axes_of` by
    default). One data axis only: several (the production mesh's
    ``("pod", "data")``) wait for slice E6b."""
    axes = tuple(axes) if axes is not None else dp_axes_of(mesh)
    if len(axes) != 1:
        raise NotImplementedError(
            f"data axes {axes}: a group over several mesh axes is slice E6b")
    return mesh.get_group(axes[0])


def dp_size(mesh, axes=None) -> int:
    """The number of data-parallel shards of ``mesh`` (its data axes'
    product)."""
    sizes = mesh_sizes(mesh)
    axes = tuple(axes) if axes is not None else dp_axes_of(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def dp_rank(mesh, axes=None) -> int:
    """This process's shard index along the data axes: its rank in
    `dp_group`, the order `all_gather` concatenates in."""
    return dist.get_rank(dp_group(mesh, axes))


def model_group(mesh):
    """The process group of ``mesh``'s ``"model"`` axis: the ranks that
    hold one batch shard's blocks of the parameters and the cache."""
    return mesh.get_group("model")


def model_size(mesh) -> int:
    """The model axis' size (1 on a mesh without one)."""
    return mesh_sizes(mesh).get("model", 1)


def model_rank(mesh) -> int:
    """This process's index along the model axis: its rank in
    `model_group`, the block of every model-sharded dim it holds."""
    return mesh.get_local_rank("model") if model_size(mesh) > 1 else 0


def block(size: int, rank: int, world: int) -> slice:
    """The contiguous block of ``size`` rows (a multiple of ``world``) that
    shard ``rank`` holds — the row split of every sharded array here."""
    per = size // world
    return slice(rank * per, (rank + 1) * per)


def all_gather_rows(out, local, group) -> None:
    """Every rank's ``local`` into ``out`` along dim 0, in group-rank
    order (`all_gather_single` where the installed torch has it, else its
    older name)."""
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(out, local, group=group)
