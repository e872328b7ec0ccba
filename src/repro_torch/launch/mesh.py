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

The model axis (tensor and expert parallelism, for serving and
training) runs over `model_group`. Several data axes — the production
meshes' ``("pod", "data")`` (`make_production_mesh`) — act as one data
group (`dp_group`, built by `axes_group`), in the reference's row-major
rank order.
"""
from __future__ import annotations

import math

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


def rank_device(mesh, device=None) -> torch.device:
    """Where this rank's tensors of ``mesh`` live and travel: ``device``
    if given, else the current card when the mesh's device type is
    ``"cuda"`` (NCCL), the CPU under gloo."""
    if device is not None:
        return torch.device(device)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(shape: tuple, names: tuple):
    """A mesh of ``shape`` with axes ``names`` over the first ``prod(
    shape)`` ranks of the world, laid out row-major (the last axis
    fastest). Raises when the world holds fewer."""
    from torch.distributed.device_mesh import DeviceMesh

    _require_group()
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the world "
                         f"holds {dist.get_world_size()}")
    ranks = torch.arange(n).view(*shape)
    return DeviceMesh(mesh_device_type(), ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes: ``(16, 16)`` over ``("data",
    "model")``, or with ``multi_pod`` ``(2, 16, 16)`` over ``("pod",
    "data", "model")``. The world must hold exactly that many ranks:
    nothing is clamped."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    _require_group()
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{math.prod(shape)} ranks; this one holds "
                         f"{dist.get_world_size()}")
    return make_mesh(shape, names)


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
    return make_mesh((data, model), ("data", "model"))


def make_data_mesh():
    """A pure data-parallel mesh over every rank — what the summarization
    engine's sharded shingle, intersection and arena paths shard over
    (`core/engine.SummarizerEngine`)."""
    _require_group()
    return make_mesh((dist.get_world_size(),), ("data",))


def axes_group(mesh, axes):
    """The process group over ``axes`` of ``mesh`` that holds this rank:
    the ranks sharing its index on every other axis, their group ranks in
    row-major order over ``axes`` (taken in the mesh's order). One axis is
    the mesh's own group; the whole mesh over the whole world is the
    world's. Several axes build a group for every cell of the other axes
    the first time, so every rank of the world calls this alike; the
    groups are kept on the mesh."""
    names = tuple(mesh.mesh_dim_names)
    want = set(axes)
    if not want <= set(names):
        raise ValueError(f"axes {tuple(axes)} are not all axes of a mesh "
                         f"over {names}")
    axes = tuple(a for a in names if a in want)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        flat = mesh.mesh.flatten().tolist()
        if axes == names and flat == list(range(dist.get_world_size())):
            cache[axes] = dist.group.WORLD
        else:
            rest = [i for i, a in enumerate(names) if a not in want]
            inner = [names.index(a) for a in axes]
            rows = mesh.mesh.permute(*rest, *inner).reshape(
                -1, math.prod(mesh.mesh.shape[i] for i in inner))
            me = dist.get_rank()
            cache[axes] = None                     # a rank off the mesh
            for row in rows.tolist():
                if row != sorted(row):
                    raise ValueError(f"mesh ranks {row} are not in row-major "
                                     f"order over {axes}")
                group = dist.new_group(row)
                if me in row:
                    cache[axes] = group
    return cache[axes]


def dp_group(mesh, axes=None):
    """The process group of ``mesh``'s data axes (`dp_axes_of` by
    default): one group over all of them (`axes_group`), so the
    production mesh's ``("pod", "data")`` is one data group."""
    axes = tuple(axes) if axes is not None else dp_axes_of(mesh)
    return axes_group(mesh, axes)


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
