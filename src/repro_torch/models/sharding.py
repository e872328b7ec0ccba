"""Sharding rules: parameter specs and activation constraints (the JAX
package's `models/sharding.py`).

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names, or ``None`` (replicated) — what a jax ``PartitionSpec`` holds.
The spec functions are pure: they read a parameter tree's shapes (tensors
or shape tuples) and a mesh's ``{name: size}`` (`launch.mesh.mesh_sizes`:
a `DeviceMesh` or a plain mapping), and give the reference's tables.

Axis roles: ``dp`` = the data-parallel axes, ``model`` = tensor and expert
parallelism. A thread-local context carries the active mesh, so model
code stays mesh-agnostic. The data axis needs no activation constraint in
SPMD: each rank's batch rows are already its shard. A model axis above 1
(tensor- and expert-parallel forward passes) is slice E6, and `constrain`
raises under one.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from repro_torch.launch.mesh import dp_group, dp_size, mesh_sizes

_CTX = threading.local()


@contextmanager
def mesh_context(mesh, dp_axes):
    """dp_axes: tuple of mesh axis names acting as data parallelism."""
    prev = getattr(_CTX, "v", None)
    _CTX.v = (mesh, tuple(dp_axes))
    try:
        yield
    finally:
        _CTX.v = prev


def current():
    return getattr(_CTX, "v", None)


def constrain(x, symbolic_spec):
    """The activation constraint of the reference: the identity with no
    mesh context or a model axis of 1; raises under a larger model axis."""
    ctx = current()
    if ctx is None:
        return x
    if mesh_sizes(ctx[0]).get("model", 1) > 1:
        raise NotImplementedError(
            f"a model axis above 1 ({symbolic_spec}): tensor and expert "
            f"parallelism is slice E6")
    return x


def data_group():
    """The data-parallel process group of the active mesh context, or None
    when there is none or it holds one rank — what cross-rank statistics
    (the MoE load-balancing loss) reduce over."""
    ctx = current()
    if ctx is None:
        return None
    mesh, dp = ctx
    if dp_size(mesh, dp) <= 1:
        return None
    return dp_group(mesh, dp)


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
