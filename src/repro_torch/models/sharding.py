"""Sharding rules and the model axis (the JAX package's
`models/sharding.py`): parameter and cache specs, the rank's blocks, and
the collectives that tensor- and expert-parallel serving and training
need.

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names, or ``None`` (replicated) — what a jax ``PartitionSpec`` holds.
The spec functions are pure: they read a parameter tree's shapes (tensors
or shape tuples) and a mesh's ``{name: size}`` (`launch.mesh.mesh_sizes`:
a `DeviceMesh` or a plain mapping), and give the reference's tables.

Axis roles: ``dp`` = the data-parallel axes, ``model`` = tensor and expert
parallelism. A thread-local context (`mesh_context`) carries the active
layout, so model code stays mesh-agnostic: under it each rank holds the
block of every parameter that `param_pspecs` gives it (`shard_params`)
and of every cache leaf that `cache_pspecs` gives it (`shard_cache`), and
the model code communicates explicitly where GSPMD would: `Axis.sum`
(row blocks' partial sums, the vocab-parallel lookup), `Axis.gather`
(projections whose column block cuts through a head or a packed
projection, the vocab-parallel logits, ``cfg.fsdp``'s weights) and
`Axis.max` (the softmax statistics of attention over a time-sharded
cache). `constrain`, the reference's activation constraint, is the
identity on the local tensor: the layout is explicit. Each collective is
the identity on an axis of one rank, so a model axis of 1 runs the
single-device code unchanged.

**Gradients** (training under a model axis, `train.train_step`). Every
collective is an autograd function with its exact adjoint: `Axis.sum`'s
backward is a SUM over the axis, `Axis.gather`'s a reduce-scatter (the
SUM, then the rank's block), and `Axis.max` has none (it raises: only
decode uses it). The convention that follows, and the only one here: the
gradient a rank holds of a replicated activation is its partial, and the
axis' SUM of the ranks' partials is the true gradient. So each rank of a
model group seeds its backward with 1/m of the (replicated) loss, a
collective's backward turns partials into the true gradient of its input,
a block's gradient is the rank's own, and the gradient of EVERY leaf
replicated over an axis is SUMmed over that axis — no list of names. A
leaf's data blocks under ``cfg.fsdp`` arrive SUMmed over the data group
already (the data gather's reduce-scatter).

A per-rank body runs without a process group under `rank_context`, on
any `Axis` it is given: `launch.local_ranks.run_ranks` gives it axes over
the ranks of one process — how ``chip_smoke.py`` and the CPU tests run a
model axis on one device.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (axes_group, dp_group, dp_size,
                                     mesh_sizes, model_group, model_size)

_CTX = threading.local()


# --------------------------------------------------------------------------
# Axes: one mesh axis as the model code sees it
# --------------------------------------------------------------------------
def _records(x) -> bool:
    """Whether autograd records an op on ``x``."""
    return torch.is_grad_enabled() and getattr(x, "requires_grad", False)


class _Sum(torch.autograd.Function):
    """SUM all-reduce; its adjoint is the SUM of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis._sum(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis._sum(grad), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; its adjoint is a reduce-scatter: the SUM
    of the ranks' gradients of the whole, then this rank's block."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis._gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis._reduce_scatter(grad, ctx.dim, ctx.n), None, None


class _Max(torch.autograd.Function):
    """MAX all-reduce, which training never differentiates."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._max(x)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "Axis.max has no backward: only decode over a time-sharded "
            "cache uses it, and training never decodes")


class Axis:
    """One mesh axis: its ``size``, this rank's index along it and the
    collectives over its group. This base class is the axis of one rank,
    where every collective is the identity (and records nothing).
    Subclasses over groups of ranks implement `_sum`, `_max` and
    `_gather` (and may `_reduce_scatter`); the public collectives wrap
    them in autograd functions wherever autograd records, so every kind
    of axis has the same backward (module docstring)."""

    size = 1
    rank = 0
    identity = True   # every collective returns its input

    def _sum(self, x):
        return x

    def _max(self, x):
        return x

    def _gather(self, x, dim):
        return x

    def _reduce_scatter(self, x, dim: int, n: int):
        """The SUM over the axis of ``x``, then this rank's block of ``n``
        entries along ``dim``."""
        return self._sum(x).narrow(dim, self.rank * n, n)

    def _autograd(self, x) -> bool:
        return not self.identity and _records(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """SUM all-reduce: the same tensor on every rank of the axis."""
        return _Sum.apply(x, self) if self._autograd(x) else self._sum(x)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """MAX all-reduce (no backward)."""
        return _Max.apply(x, self) if self._autograd(x) else self._max(x)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather: every rank's ``x`` concatenated along ``dim`` in
        rank order."""
        if self._autograd(x):
            return _Gather.apply(x, self, dim % x.dim())
        return self._gather(x, dim)

    def sum_all(self, *xs: torch.Tensor) -> list:
        """SUM all-reduce of several tensors in one collective: packed
        flat in float32 (or wider), returned in their own dtypes."""
        if self.size == 1:
            return list(xs)
        acc = torch.promote_types(xs[0].dtype, torch.float32)
        flat = self.sum(torch.cat([x.reshape(-1).to(acc) for x in xs]))
        out, at = [], 0
        for x in xs:
            out.append(flat[at:at + x.numel()].view(x.shape).to(x.dtype))
            at += x.numel()
        return out


SOLO = Axis()


class GroupAxis(Axis):
    """An axis over a `torch.distributed` process group: NCCL for tensors
    on the card (a CUDA tensor under a gloo group raises), gloo on the
    CPU."""

    identity = False

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)

    def _check(self, x):
        if x.is_cuda and self.backend != "nccl":
            raise RuntimeError(
                f"a CUDA tensor on a {self.backend} group: the model axis "
                f"on the card needs an NCCL process group")
        return x

    def _sum(self, x):
        out = self._check(x).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def _max(self, x):
        out = self._check(x).clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def _gather(self, x, dim):
        x = self._check(x).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def _reduce_scatter(self, x, dim, n):
        if self.backend != "nccl":
            return super()._reduce_scatter(x, dim, n)
        xt = self._check(x).movedim(dim, 0).contiguous()
        out = xt.new_empty((n, *xt.shape[1:]))
        dist.reduce_scatter_tensor(out, xt, group=self.group)
        return out.movedim(0, dim)


class _Unbound(Axis):
    """An axis above one rank with no process group behind it (a plain
    mapping as the mesh): its rank and collectives raise."""

    identity = False

    def __init__(self, name, size):
        self.name, self.size = name, size

    def _raise(self, *_):
        raise RuntimeError(
            f"a {self.name} axis of {self.size} needs a process group: pass "
            f"a DeviceMesh (launch.mesh.make_host_mesh) to mesh_context, or "
            f"run the per-rank bodies under rank_context")

    rank = property(_raise)
    _sum = _max = _raise

    def _gather(self, x, dim):
        self._raise()


# --------------------------------------------------------------------------
# The layout context
# --------------------------------------------------------------------------
@dataclass
class Layout:
    """What the model code reads of the active mesh: the axis sizes, the
    data axes' names, the model and data `Axis`, the global batch rows
    (``batch``, where the cache specs need it), the cache's spec tree
    (``cache``, `cache_pspecs`'s; set by the serve step), and whether the
    parameters are the rank's blocks (``blocks``; the data-parallel train
    step holds them whole)."""
    mesh: object
    dp: tuple
    sizes: dict
    model: Axis = SOLO
    data: Axis = SOLO
    batch: int = None
    cache: dict = None
    blocks: bool = True
    specs: dict = field(default_factory=dict)  # cfg -> param spec tree
    axes: dict = field(default_factory=dict)   # axis names -> `Axis`

    def axis(self, names) -> Axis:
        """The `Axis` over the mesh axes ``names``: the model or the data
        axis, or (on a `DeviceMesh`) the group of any other set of axes,
        such as one of several data axes."""
        names = frozenset(names if isinstance(names, tuple) else (names,))
        if names == {"model"}:
            return self.model
        if names == set(self.dp):
            return self.data
        if math.prod(self.sizes[a] for a in names) == 1:
            return SOLO
        if isinstance(self.mesh, dict):
            raise RuntimeError(f"an axis over {sorted(names)} needs a "
                               f"DeviceMesh")
        if names not in self.axes:
            self.axes[names] = GroupAxis(axes_group(self.mesh, names))
        return self.axes[names]

    def coords(self) -> dict:
        """``{axis name: this rank's index}`` over the mesh's axes; the
        data group's rank split row-major over the data axes."""
        out = {a: 0 for a in self.sizes}
        if self.sizes.get("model", 1) > 1:
            out["model"] = self.model.rank
        if self.data.size > 1:
            r = self.data.rank
            for a in reversed(self.dp):
                r, out[a] = divmod(r, self.sizes[a])
        return out


def _axes_of(mesh, dp):
    """The model and data `Axis` of ``mesh``: over its process groups for
    a `DeviceMesh`, unbound (raising where used) for a plain mapping."""
    m, d = model_size(mesh), dp_size(mesh, dp)
    bound = not isinstance(mesh, dict)
    model = (SOLO if m == 1 else GroupAxis(model_group(mesh)) if bound
             else _Unbound("model", m))
    data = (SOLO if d == 1 else GroupAxis(dp_group(mesh, dp)) if bound
            else _Unbound("data", d))
    return model, data


@contextmanager
def _enter(layout):
    prev = getattr(_CTX, "v", None)
    _CTX.v = layout
    try:
        yield layout
    finally:
        _CTX.v = prev


@contextmanager
def mesh_context(mesh, dp_axes, batch=None, cache=None, blocks=True):
    """Run model code SPMD on ``mesh`` (a `DeviceMesh`, or a plain
    ``{axis: size}`` mapping, whose axes above one rank raise where the
    model code communicates). ``dp_axes``: the mesh axes acting as data
    parallelism; ``batch``: the global batch rows; ``cache``: the cache's
    spec tree (`cache_pspecs`); ``blocks``: the parameters are the rank's
    blocks (`shard_params`), not whole."""
    dp = tuple(dp_axes)
    model, data = _axes_of(mesh, dp)
    with _enter(Layout(mesh, dp, mesh_sizes(mesh), model, data, batch,
                       cache, blocks)):
        yield


@contextmanager
def rank_context(sizes: dict, dp_axes, model: Axis = SOLO, data: Axis = SOLO,
                 batch=None, cache=None):
    """`mesh_context` for a per-rank body: the mesh's ``{axis: size}``
    and the rank's axes (`launch.local_ranks.run_ranks`'s, or any
    `Axis`)."""
    with _enter(Layout(dict(sizes), tuple(dp_axes), dict(sizes), model, data,
                       batch, cache)):
        yield


def current():
    """The active `Layout`, or None outside every context."""
    return getattr(_CTX, "v", None)


_NONE = Layout(None, ("data",), {})


def layout() -> Layout:
    """The active `Layout`, or that of one device."""
    return getattr(_CTX, "v", None) or _NONE


def constrain(x, symbolic_spec):
    """The reference's activation constraint. The layout here is explicit
    (each rank holds its blocks, and the model code communicates where
    GSPMD would), so it is the identity on the local tensor."""
    return x


def data_group():
    """The data-parallel process group of the active mesh context, or None
    when there is none or it holds one rank."""
    lay = current()
    if lay is None or lay.data.size <= 1:
        return None
    return getattr(lay.data, "group", None)


# --------------------------------------------------------------------------
# Blocks and collectives of the model axis
# --------------------------------------------------------------------------
def model_axis() -> Axis:
    return layout().model


def data_axis() -> Axis:
    return layout().data


def split(n: int) -> bool:
    """Whether a dim of ``n`` that a spec puts on ``"model"`` is split:
    `_guard` replicates it where the model axis does not divide it."""
    m = model_axis().size
    return m > 1 and n % m == 0


def col_block(n: int) -> slice:
    """The rank's block of a dim of ``n`` on ``"model"``: its share where
    `split`, else all of it."""
    if not split(n):
        return slice(0, n)
    ax = model_axis()
    per = n // ax.size
    return slice(ax.rank * per, (ax.rank + 1) * per)


def heads(h: int) -> tuple:
    """``(h0, h1)``: the heads this rank computes — its block where the
    model axis divides ``h``, else all of them."""
    blk = col_block(h)
    return blk.start, blk.stop


def take(y: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of a projection whose ``n`` output columns sit
    on ``"model"`` (a weight's columns, or its output), given this rank's
    ``y`` (its `col_block`): a view where the block holds them, else the
    gathered whole, sliced."""
    blk = col_block(n)
    if blk.start <= lo and hi <= blk.stop:
        if hi - lo == y.shape[-1]:
            return y
        return y[..., lo - blk.start:hi - blk.start]
    return model_axis().gather(y, -1)[..., lo:hi]


def row_partial(y: torch.Tensor, w: torch.Tensor, n: int, lo: int):
    """``(y' @ w, partial?)`` for a row block ``w`` of an ``(n, d)``
    weight on ``"model"``: ``y`` holds input columns ``[lo, lo +
    y.shape[-1])``, and ``y'`` the rank's rows of them. ``partial``: the
    product is this rank's share of a sum over the model axis."""
    blk = col_block(n)
    a, b = blk.start - lo, blk.stop - lo
    if a < 0 or b > y.shape[-1]:
        raise ValueError(f"input columns [{lo}, {lo + y.shape[-1]}) do not "
                         f"cover the row block [{blk.start}, {blk.stop})")
    if a or b != y.shape[-1]:
        y = y[..., a:b]
    return y @ w, split(n)


def rows(y: torch.Tensor, w: torch.Tensor, n: int, lo: int = 0):
    """A row-block product summed over the model axis (`row_partial`):
    one SUM all-reduce where the block is a share."""
    out, partial = row_partial(y, w, n, lo)
    return model_axis().sum(out) if partial else out


def gather_spec(tree, specs, model: bool = False):
    """``tree``'s blocks all-gathered along every dim whose spec puts a
    data axis on it (and the model axis, with ``model``), over that axis'
    group: under ``cfg.fsdp`` with a data axis above 1, one layer's
    weights just before use."""
    lay = layout()
    dp = set(lay.dp)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        for dim, ax in enumerate(s):
            names = set(ax if isinstance(ax, tuple) else (ax,))
            if ax is None:
                continue
            if names <= dp or (model and names == {"model"}):
                t = lay.axis(tuple(names)).gather(t, dim)
        return t

    return walk(tree, specs)


def layer_specs(cfg, *path, stacked=True):
    """The spec tree (`param_pspecs`) of the parameters at ``path`` under
    the active layout, the layer axis dropped where ``stacked``; memoised
    a layout."""
    from repro_torch.models.api import param_shapes

    lay = layout()
    key = cfg
    if key not in lay.specs:
        lay.specs[key] = param_pspecs(cfg, param_shapes(cfg), lay.sizes,
                                      lay.dp)
    t = at(lay.specs[key], path)
    if not stacked:
        return t

    def drop(s):
        return ({k: drop(v) for k, v in s.items()} if isinstance(s, dict)
                else tuple(s[1:]))

    return drop(t)


def fsdp_layer(lp, cfg, *path, stacked=True):
    """`gather_spec` of one layer's parameters ``lp`` at ``path``, where
    they are the rank's blocks."""
    lay = layout()
    if not cfg.fsdp or lay.data.size == 1 or not lay.blocks:
        return lp
    return gather_spec(lp, layer_specs(cfg, *path, stacked=stacked))


def time_axis(spec) -> Axis:
    """The `Axis` that a cache spec's time entry (``spec[2]`` of an
    L-stacked leaf) puts the time on: model, data, or none."""
    lay = layout()
    ax = spec[2] if spec is not None else None
    if ax is None:
        return SOLO
    names = ax if isinstance(ax, tuple) else (ax,)
    if names == ("model",):
        return lay.model
    if set(names) <= set(lay.dp):
        return lay.data
    raise NotImplementedError(f"a cache time axis over {names}")


def cache_spec(*path):
    """The spec of the cache leaf at ``path`` in the active layout's cache
    spec tree, or None (nothing sharded) where there is none. A model or
    data axis above 1 needs it (the serve step sets it)."""
    lay = layout()
    if lay.cache is None:
        if lay.model.size > 1 or lay.data.size > 1:
            raise RuntimeError(
                "a decode step under a mesh needs the cache's specs: use "
                "train_step.build_serve_step, or mesh_context(..., cache="
                "cache_pspecs(...))")
        return None
    return at(lay.cache, path)


def at(tree, path):
    """The node of a nested dict at ``path`` (its keys in order)."""
    for k in path:
        tree = tree[k]
    return tree


def local_block(shape, spec, sizes: dict, coords: dict) -> tuple:
    """The slices of ``shape`` that the rank at ``coords`` (``{axis:
    index}``) holds under ``spec`` over a mesh of ``sizes``; the axes of
    one entry split the dim major to minor."""
    sizes = mesh_sizes(sizes)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        parts, idx = 1, 0
        for a in names:
            parts, idx = parts * sizes[a], idx * sizes[a] + coords[a]
        per = dim // parts
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


def mesh_coords(mesh) -> dict:
    """``{axis: this rank's index}`` on a `DeviceMesh`."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def _cut(tree, specs, sizes, coords):
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        blk = local_block(tuple(t.shape), s, sizes, coords)
        return t[blk].clone()
    return walk(tree, specs)


def gather_blocks(tree, specs, mesh, device=None) -> dict:
    """The whole tensors of ``tree``, this rank's blocks under ``specs``
    on the `DeviceMesh` ``mesh`` (every rank of it calls this): each dim
    all-gathered over the group of the axes its spec entry names
    (`launch.mesh.axes_group`, row-major), leaf by leaf, each whole leaf
    moved to ``device`` (default: where it is) before the next."""
    sizes = mesh_sizes(mesh)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        for dim, entry in enumerate(s):
            names = tuple(a for a in (entry if isinstance(entry, tuple)
                                      else (entry,))
                          if a is not None and sizes[a] > 1)
            if names:
                t = GroupAxis(axes_group(mesh, names))._gather(t, dim)
        return t if device is None else t.to(device)

    return walk(tree, specs)


def shard_params(cfg, tree, mesh, dp_axes, coords=None) -> dict:
    """``tree`` (every parameter whole) cut to the rank's blocks under
    `param_pspecs`: copies, so the whole tree can be dropped. ``coords``:
    the rank's ``{axis: index}`` (default: this process's on a
    `DeviceMesh`)."""
    coords = mesh_coords(mesh) if coords is None else coords
    specs = param_pspecs(cfg, tree, mesh, dp_axes)
    return _cut(tree, specs, mesh_sizes(mesh), coords)


def shard_cache(cfg, tree, mesh, dp_axes, batch: int, coords=None) -> dict:
    """A whole cache tree cut to the rank's blocks under `cache_pspecs`
    at ``batch`` global rows."""
    coords = mesh_coords(mesh) if coords is None else coords
    specs = cache_pspecs(cfg, tree, mesh, dp_axes, batch)
    return _cut(tree, specs, mesh_sizes(mesh), coords)


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------
def _prod(sizes: dict, names) -> int:
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def _divisible(dim: int, mesh, axis) -> bool:
    """Non-divisible dims replicate (vocab is pre-padded in the config so
    the big tables shard)."""
    if axis is None:
        return True
    names = axis if isinstance(axis, tuple) else (axis,)
    return dim % _prod(mesh_sizes(mesh), names) == 0


def _guard(spec: tuple, shape: tuple, mesh) -> tuple:
    return tuple(ax if _divisible(dim, mesh, ax) else None
                 for dim, ax in zip(shape, spec))


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree; paths are key names
    and list indices as strings, as the reference's tree paths."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_pspecs(cfg, params_tree, mesh, dp_axes):
    """A spec tree matching ``params_tree`` (tensors or shape tuples).

    Rules (path-name driven):
      embed (V,d)->(model,None); lm_head (d,V)->(None,model)
      wq/wk/wv/wkv_b (…,d,H)->(None,model); wo/w_down/out_proj (…,H,d)->(model,None)
      w_gate/w_up/in_proj (…,d,f)->(None,model)
      experts we_* (L,E,…)->(model on E [, data on d if cfg.fsdp])
      conv_w (C,K)->(model,None);  1-D params replicated
    """
    fsdp_ax = dp_axes[-1] if cfg.fsdp else None

    def rule(path, leaf):
        shape = _shape(leaf)
        name = path[-1] if path else ""
        nd = len(shape)
        stacked = (name not in ("embed", "lm_head", "final_norm")
                   and "shared_attn" not in path
                   and "encoder_embed" not in path)

        def with_l(spec):  # leading L axis for stacked layer params
            return ((None,) + spec) if (stacked and "layers" in path) else spec

        if name == "embed":
            return _guard(("model", None), shape, mesh)
        if name == "lm_head":
            return _guard((None, "model"), shape, mesh)
        if nd <= 1 + (1 if ("layers" in path and stacked) else 0):
            return (None,) * nd  # norms, biases, scalars
        if name in ("we_gate", "we_up", "we_down"):
            spec = ["model", None, None]  # (E, d, f) / (E, f, d)
            if cfg.fsdp:
                spec[1] = fsdp_ax
            return _guard(tuple(with_l(tuple(spec))), shape, mesh)
        if name == "router":
            return _guard(with_l((None, None)), shape, mesh)
        if name in ("wq", "wk", "wv", "wkv_b", "w_gate", "w_up", "in_proj",
                    "ws_gate", "ws_up", "wkv_a"):
            spec = (fsdp_ax, "model") if cfg.fsdp else (None, "model")
            return _guard(with_l(spec), shape, mesh)
        if name in ("wo", "w_down", "out_proj", "ws_down"):
            spec = ("model", fsdp_ax) if cfg.fsdp else ("model", None)
            return _guard(with_l(spec), shape, mesh)
        if name == "conv_w":
            return _guard(with_l(("model", None)), shape, mesh)
        return (None,) * nd

    return _map_with_path(rule, params_tree)


def _dp_entry(dp: tuple):
    return dp if len(dp) > 1 else dp[0]


def cache_pspecs(cfg, cache_tree, mesh, dp_axes, batch: int):
    """KV/state cache specs: batch over dp when divisible; heads/latent
    over model; batch==1 long-context attention caches shard the TIME axis
    over dp (sequence parallelism for the cache)."""
    dp = tuple(dp_axes)
    sizes = mesh_sizes(mesh)
    dp_total = _prod(sizes, dp)
    batch_ax = (_dp_entry(dp) if batch % dp_total == 0 and batch >= dp_total
                else None)

    def rule(path, leaf):
        shape = _shape(leaf)
        name = path[-1]
        nd = len(shape)
        if name in ("k", "v"):  # (L|G, b, S, hkv, hd)
            head_ax = "model" if _divisible(shape[3], mesh, "model") else None
            # few-KV-head archs: shard the TIME axis over "model" instead
            time_ax = ("model" if head_ax is None
                       and _divisible(shape[2], mesh, "model") else None)
            if batch_ax is None and time_ax is None and _divisible(
                    shape[2], mesh, _dp_entry(dp)):
                # batch-1 long-context: sequence-parallel cache over dp
                time_ax = _dp_entry(dp)
            if batch_ax is None and head_ax is None and time_ax is None:
                return _guard((None, None, _dp_entry(dp), None, None), shape,
                              mesh)
            return _guard((None, batch_ax, time_ax, head_ax, None), shape,
                          mesh)
        if name in ("ckv", "krope"):  # (L, b, S, r): time over "model"
            time_ax = "model" if _divisible(shape[2], mesh, "model") else None
            if batch_ax is None and time_ax is None:
                return _guard((None, None, _dp_entry(dp), None), shape, mesh)
            return _guard((None, batch_ax, time_ax, None), shape, mesh)
        if name == "state":  # (L, b, nh, hp, ds)
            return _guard((None, batch_ax, "model", None, None), shape, mesh)
        if name == "conv":  # (L, b, K-1, conv_dim)
            return _guard((None, batch_ax, None, "model"), shape, mesh)
        return (None,) * nd

    return _map_with_path(rule, cache_tree)


def batch_pspec(mesh, dp_axes, batch: int) -> tuple:
    dp = tuple(dp_axes)
    dp_total = _prod(mesh_sizes(mesh), dp)
    if batch % dp_total == 0 and batch >= dp_total:
        return (_dp_entry(dp), None)
    return (None, None)


def zero1_spec(param_spec: tuple, shape: tuple, mesh, dp_axes) -> tuple:
    """ZeRO-1: shard optimizer moments over the dp axes on the first
    divisible unsharded dim. Only dp axes NOT already used by the param spec
    are added (fsdp params already consume one dp axis); falls back to the
    param spec when nothing further shards."""
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = set()
    for ax in entries:
        if ax is None:
            continue
        used.update(ax if isinstance(ax, tuple) else (ax,))
    free = tuple(a for a in dp_axes if a not in used)
    if not free:
        return tuple(entries)
    total = _prod(mesh_sizes(mesh), free)
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None and dim % total == 0 and dim >= total:
            entries[i] = _dp_entry(free)
            return tuple(entries)
    return tuple(entries)
