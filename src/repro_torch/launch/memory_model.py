"""Analytic per-device memory of every (arch × shape × mesh) cell (the JAX
package's `launch/memory_model.py`, on the port's spec tables).

What one card must hold for the step:

  params(shard) + optimizer moments(shard) + gradients(shard, f32)
  + remat-saved layer-boundary activations (bf16)
  + peak single-layer recompute working set
  + CE-chunk logits (f32) / KV-cache shards for serving.

Shard factors come from the SAME spec trees the real step uses
(`models.sharding.param_pspecs`, `cache_pspecs`, `zero1_spec`), so a
sharding fault shows up as an analytic-vs-expected mismatch in tests. The
mesh is a `DeviceMesh` or a plain ``{axis: size}`` mapping
(`launch.mesh.mesh_sizes`): nothing here needs devices or ranks. The dry
run (`launch/dryrun.py`) reports this beside the peak of the storages its
traced step held.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import sharding as SH
from repro_torch.models.api import abstract_params, get_api


def _shard_factor(spec, shape, mesh) -> int:
    sizes = mesh_sizes(mesh)
    f = 1
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                        - len(tuple(spec)))):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        k = math.prod(sizes[n] for n in names)
        if dim % k == 0:
            f *= k
    return f


def _pairs(tree, specs):
    """(leaf, spec) pairs of a tensor tree and its spec tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, list):
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)
    else:
        yield tree, specs


def _tree_bytes(tree, specs, mesh, dtype_bytes=None) -> float:
    total = 0.0
    for leaf, spec in _pairs(tree, specs):
        nbytes = leaf.numel() * (dtype_bytes or leaf.element_size())
        total += nbytes / _shard_factor(spec, tuple(leaf.shape), mesh)
    return total


def analytic_hbm(cfg: ModelConfig, shape: ShapeConfig, mesh, dp_axes,
                 microbatch=None, opt_bytes_per_param: int = 8) -> dict:
    """Returns a per-device byte breakdown dict (floats)."""
    sizes = mesh_sizes(mesh)
    params_abs = abstract_params(cfg)
    pspecs = SH.param_pspecs(cfg, params_abs, sizes, dp_axes)
    p_bytes = _tree_bytes(params_abs, pspecs, sizes)
    dp_total = math.prod(sizes[a] for a in dp_axes)
    out = {"params": p_bytes}
    d, S = cfg.d_model, shape.seq_len
    dt = 2  # bf16 activations

    if shape.kind == "train":
        # optimizer moments: ZeRO-1 sharded over the free dp axes
        out["opt_moments"] = sum(
            l.numel() * opt_bytes_per_param / _shard_factor(
                SH.zero1_spec(s, tuple(l.shape), sizes, dp_axes),
                tuple(l.shape), sizes)
            for l, s in _pairs(params_abs, pspecs))
        # gradients accumulate in f32 with the param sharding
        out["grads_f32"] = _tree_bytes(params_abs, pspecs, sizes,
                                       dtype_bytes=4)
        mb = microbatch or cfg.train_microbatch or shape.global_batch
        b_local = max(1, mb // dp_total)
        units = cfg.n_layers + cfg.encoder_layers
        if cfg.attn_every:
            units = cfg.n_layers + (cfg.n_layers + cfg.attn_every - 1) \
                // cfg.attn_every
        # remat=full saves one (b_local, S, d) residual per layer unit
        out["saved_residuals"] = float(units * b_local * S * d * dt)
        # live recompute: one layer's working set ≈ qkv+ffn intermediates
        ff = cfg.d_ff or (cfg.ssm.expand * d if cfg.ssm else d)
        if cfg.moe:
            ff = cfg.moe.top_k * cfg.moe.d_expert * cfg.moe.capacity_factor
        out["recompute_peak"] = float(b_local * S * (4 * d + 2 * ff) * 4)
        # chunked-CE logits: one (B, C, V/model) f32 chunk (+1 in flight)
        C = max(1, min(S, 32_768 // max(shape.global_batch, 1)))
        model_k = sizes.get("model", 1)
        out["ce_chunk"] = float(2 * b_local * C
                                * (cfg.padded_vocab // model_k) * 4)
    else:
        cache_abs = get_api(cfg).init_cache(cfg, shape.global_batch, S,
                                            device="meta")
        cspecs = SH.cache_pspecs(cfg, cache_abs, sizes, dp_axes,
                                 shape.global_batch)
        out["kv_cache"] = _tree_bytes(cache_abs, cspecs, sizes)
        if shape.kind == "prefill":
            b_local = max(1, shape.global_batch // dp_total)
            out["live_activations"] = float(8 * b_local * S * d * dt)
        else:
            out["kv_cache"] *= 2  # in+out copies unless donation aliases
    out["total"] = float(sum(out.values()))
    return out
