"""Decoder-only LM: the dense, MoE, SSM, hybrid and VLM families, with GQA
or MLA attention (the JAX package's `models/transformer.py`).

Parameters are a plain dict of tensors in the reference's tree and
layout: weights ``(d_in, d_out)`` so ``x @ w`` mirrors its einsums, and the
layers stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
``(L, d, hq·hd)``), so `interop.params_from_arrays` carries the
reference's weights over as they are. ``lax.scan`` over the layers becomes
a Python loop over views of that stack (one ``unbind`` a leaf, so
autograd hands the stacked leaf its gradient in one stack). Where autograd
records, each layer body runs under ``cfg.remat`` (`remat`), as the
reference's ``_maybe_remat`` wraps its scan bodies. ``sharding.constrain``
sits where the reference's does, the identity on the local tensor.

Under a mesh context (tensor- and expert-parallel serving and training)
each rank holds its blocks of the parameters (`sharding.shard_params`)
and of the cache, and the code communicates where GSPMD would: the
vocab-parallel `embed_tokens` and `_logits`, column-then-row blocks with
one SUM all-reduce (`swiglu_ffn`, attention, the MoE and Mamba2 blocks),
and ``cfg.fsdp``'s data-sharded weights gathered a layer at a time
(`sharding.fsdp_layer`). The collectives carry their own backward
passes, so autograd differentiates the same code (`models.sharding`).

The SSM family stacks Mamba2 blocks (``layers = {"ln", "mamba"}``); a
hybrid (``attn_every``, Zamba2-style) follows each group of
``attn_every`` of them with ONE shared attention block, ``shared_attn``,
unstacked: the same tensors at every application. A VLM (``n_patches``)
is the dense decoder behind a prefix of ``n_patches`` patch embeddings
(``embeds``, from a vision frontend the reference stubs out): they take
positions 0..n_patches−1, so a served cache holds ``n_patches`` + text +
generated positions, and decode starts at ``n_patches + text_len``. The
encoder-decoder lives in `models/encdec.py`.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import sharding as SH
from repro_torch.models.layers import init_linear, rms_norm
from repro_torch.models.sharding import constrain

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ModelConfig):
    """Raise `NotImplementedError` unless ``cfg``'s family is ported:
    dense, MoE (GQA or MLA), SSM, hybrid, VLM or encoder-decoder."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  f"not ported")


def is_ssm(cfg: ModelConfig) -> bool:
    """Mamba2 layers: the SSM family or a hybrid."""
    return cfg.family == "ssm" or bool(cfg.attn_every)


# ----------------------------------------------------------------- init
def ffn_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (*lead, d, f), "w_up": (*lead, d, f),
            "w_down": (*lead, f, d)}


def attn_block_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_attn_block``'s tree: ``attn`` is GQA's or MLA's, and ``moe``
    takes the place of ``ffn`` in the MoE family."""
    d = cfg.d_model
    attn = (A.mla_param_shapes(cfg, lead) if cfg.mla is not None
            else A.gqa_param_shapes(cfg, lead))
    p = {"ln1": (*lead, d), "ln2": (*lead, d), "attn": attn}
    if cfg.moe is not None:
        p["moe"] = MOE.param_shapes(cfg, lead)
    else:
        p["ffn"] = ffn_shapes(cfg, lead)
    return p


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's tree, layers stacked
    on a leading L axis): attention blocks, or Mamba2 blocks and, in a
    hybrid, the one unstacked ``shared_attn`` block."""
    check_supported(cfg)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    p = {"embed": (V, d), "final_norm": (d,)}
    if is_ssm(cfg):
        p["layers"] = {"ln": (L, d), "mamba": SSM.param_shapes(cfg, (L,))}
        if cfg.attn_every:
            p["shared_attn"] = attn_block_shapes(cfg)
    else:
        p["layers"] = attn_block_shapes(cfg, (L,))
    if not cfg.tie_embeddings:
        p["lm_head"] = (d, V)
    return p


ONES = ("ln", "ln1", "ln2", "lnx", "final_norm", "enc_norm", "kv_norm",
        "norm_w", "D")
ZEROS = ("bq", "bk", "bv", "conv_b", "A_log", "dt_bias")


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype of the leaf ``name``: float32 for the MoE router and the
    Mamba2 ``A_log``, ``D`` and ``dt_bias``, else ``cfg.dtype``."""
    if name == "router" or name in SSM.F32_PARAMS:
        return torch.float32
    return DTYPES[cfg.dtype]


def build_params(spec: dict, cfg: ModelConfig, generator=None, device=None,
                 mesh=None, dp_axes=("data",), coords=None):
    """Random weights on ``device`` (``None``: the CUDA card, which must
    exist) in the tree ``spec`` of shapes, drawn from ``generator``
    (default: seed 0 on that device) with the reference's distributions:
    embedding N(0, 0.02²), linears and experts N(0, 1/d_in), a Mamba2
    conv N(0, 1)·0.1, norms and the skip ``D`` 1, biases, ``A_log`` and
    ``dt_bias`` 0; the MoE router and ``A_log``, ``D``, ``dt_bias`` in
    float32 whatever ``cfg.dtype``.

    With a ``mesh`` of more than one rank (a `DeviceMesh`, or a ``{axis:
    size}`` mapping with the rank's ``coords``) only the rank's block of
    each leaf (`sharding.param_pspecs`) is drawn, leaf by leaf and a
    stacked leaf layer by layer, so no whole leaf (nor one block's f32
    draw) is ever held: each part from its own generator, seeded by one
    draw of ``generator``, the leaf, the block's index and the layer, so
    the ranks that hold one block (the data axis' replicas, every rank
    for a replicated leaf) draw the same numbers. Those numbers differ
    from the one-device draw's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw "
                         f"weights for {dev}")
    dtype = DTYPES[cfg.dtype]

    def draw(name, shape, gen, full):
        dt = param_dtype(cfg, name)
        if name in ONES:
            return torch.ones(shape, dtype=dt, device=dev)
        if name in ZEROS:
            return torch.zeros(shape, dtype=dt, device=dev)
        if name == "embed":
            return init_linear(gen, *shape, dtype, scale=0.02)
        if name == "conv_w":  # the reference casts, then scales
            return torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype) * 0.1
        return init_linear(gen, *shape[-2:], dt, lead=shape[:-2],
                           scale=1.0 / math.sqrt(full[-2]))

    sizes = mesh_sizes(mesh) if mesh is not None else {}
    if math.prod(sizes.values()) <= 1:
        def build(spec):
            return {k: build(v) if isinstance(v, dict)
                    else draw(k, v, generator, v) for k, v in spec.items()}
        return build(spec)

    from repro_torch.models import sharding as SH

    coords = SH.mesh_coords(mesh) if coords is None else coords
    specs = SH.param_pspecs(cfg, spec, sizes, dp_axes)
    base = int(torch.randint(0, 1 << 40, (1,), generator=generator,
                             device=dev))
    counter = iter(range(1 << 30))

    def block(path, full):
        i = next(counter)
        blk = SH.local_block(full, SH.at(specs, path), sizes, coords)
        shape = tuple(b.stop - b.start for b in blk)
        index = tuple(b.start for b in blk)

        def gen(part):
            seed = hash((base, i, index, part)) & ((1 << 62) - 1)
            return torch.Generator(device=dev).manual_seed(seed)

        if len(shape) < 3:
            return draw(path[-1], shape, gen(-1), full)
        # a stacked leaf a layer at a time: one layer's f32 draw at once
        first = draw(path[-1], shape[1:], gen(0), full)
        out = first.new_empty(shape)
        out[0] = first
        for j in range(1, shape[0]):
            out[j] = draw(path[-1], shape[1:], gen(j), full)
        return out

    return SH._map_with_path(block, spec)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, mesh=None, dp_axes=("data",), coords=None):
    """Random weights in the tree of `param_shapes` (`build_params`; with
    a ``mesh``, the rank's blocks). The reference's ``jax.random`` stream
    is not reproduced; carry its weights with `interop.params_from_arrays`
    where the same numbers are needed."""
    return build_params(param_shapes(cfg), cfg, generator, device, mesh,
                        dp_axes, coords)


def layer(tree, i: int):
    """Layer ``i``'s parameters (or cache): views into the L-stacked tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def layers(tree) -> list:
    """Every layer's parameters, ``[layer(tree, i) for i in range(L)]``,
    by one ``unbind`` a leaf. Autograd then gives a stacked leaf its
    gradient in one stack, where indexing it once a layer would build a
    full-size zero tensor a layer."""
    if isinstance(tree, dict):
        per = {k: layers(v) for k, v in tree.items()}
        return [dict(zip(per, lp)) for lp in zip(*per.values())]
    return tree.unbind(0)


# aten ops whose outputs the ``"dots"`` policy saves: the matmuls
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def remat(fn, cfg: ModelConfig, x: torch.Tensor):
    """``fn`` under ``cfg.remat``, the reference's ``_maybe_remat``, where
    autograd records ``x`` (grad enabled, ``x`` requiring grad), else
    ``fn`` itself, so serving runs unchanged: ``"full"`` keeps the layer's
    inputs and recomputes the rest in the backward pass
    (`torch.utils.checkpoint`), ``"dots"`` also keeps the matmul outputs
    (selective checkpointing of ``aten.mm``/``bmm``/``addmm``), ``"none"``
    keeps everything. Loss and gradients are the same under all three:
    no layer draws random numbers."""
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat {cfg.remat!r}; use 'full', 'dots' "
                         f"or 'none'")
    if cfg.remat == "none" or not (torch.is_grad_enabled()
                                   and x.requires_grad):
        return fn
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _DOTS))
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ----------------------------------------------------------- block bodies
def swiglu_ffn(f, cfg: ModelConfig, x):
    """The SwiGLU FFN ``f`` on the rank's blocks: ``w_gate`` and ``w_up``
    column blocks, ``w_down`` a row block, one SUM all-reduce over the
    model axis (`layers.swiglu` on one device)."""
    blk = SH.col_block(cfg.d_ff)
    h = F.silu(x @ f["w_gate"]) * (x @ f["w_up"])
    return SH.rows(h, f["w_down"], cfg.d_ff, blk.start)


def _ffn(p, cfg: ModelConfig, h2):
    """The block's FFN: (out, aux loss), the dense SwiGLU's aux 0."""
    if cfg.moe is not None:
        return MOE.moe_ffn(p["moe"], cfg, h2)
    return swiglu_ffn(p["ffn"], cfg, h2), 0.0


def attn_block_full(p, cfg: ModelConfig, x, positions):
    full = A.mla_full if cfg.mla is not None else A.gqa_full
    with tracing.span("layer.attn"):
        h, cache = full(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                        positions)
        x = constrain(x + h, ("dp", None, None))
    with tracing.span("layer.ffn"):
        f, aux = _ffn(p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
        return constrain(x + f, ("dp", None, None)), cache, aux


def attn_block_decode(p, cfg: ModelConfig, x, cache, pos):
    """One token through one block. MLA decodes with `mla_decode`, or with
    `mla_decode_absorbed` when ``cfg._absorbed_mla`` is set (the
    reference's switch, set with ``object.__setattr__``)."""
    if cfg.mla is not None:
        step = (A.mla_decode_absorbed if getattr(cfg, "_absorbed_mla", False)
                else A.mla_decode)
    else:
        step = A.gqa_decode
    h, cache = step(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                    cache, pos)
    x = x + h
    f, _ = _ffn(p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + f, cache


def ssm_block_full(p, cfg: ModelConfig, x, conv_state=None, h0=None):
    with tracing.span("layer.ssm"):
        h, cache = SSM.mamba2_full(p["mamba"], cfg,
                                   rms_norm(x, p["ln"], cfg.norm_eps),
                                   conv_state, h0)
        return constrain(x + h, ("dp", None, None)), cache


def ssm_block_decode(p, cfg: ModelConfig, x, cache):
    """One token through one Mamba2 block; ``cache`` updated IN PLACE."""
    h, cache = SSM.mamba2_decode(p["mamba"], cfg,
                                 rms_norm(x, p["ln"], cfg.norm_eps), cache)
    return x + h, cache


# --------------------------------------------------------------- forward
def embed_tokens(embed, cfg: ModelConfig, tokens):
    """Rows of ``embed`` (V, d) for ``tokens``. Where the model axis
    splits V, a vocab-parallel lookup: ids outside the rank's rows read
    zeros, then one SUM all-reduce (exact: one rank adds its row to
    zeros)."""
    V = cfg.padded_vocab
    if not SH.split(V):
        return embed[tokens]
    blk = SH.col_block(V)
    t = tokens - blk.start
    mine = (t >= 0) & (t < blk.stop - blk.start)
    x = torch.where(mine[..., None],
                    embed[t.clamp(0, blk.stop - blk.start - 1)], 0.0)
    return SH.model_axis().sum(x)


def _embed(params, cfg, tokens, embeds):
    x = embed_tokens(params["embed"], cfg, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return constrain(x, ("dp", None, None))


def _logits(params, cfg, x):
    """The final norm and the vocabulary projection: the rank's columns
    of ``lm_head`` (or rows of a tied ``embed``), gathered over the model
    axis where it splits V — only what the caller passes in (the last
    position in prefill, one row in decode)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    V = cfg.padded_vocab
    if cfg.tie_embeddings:
        return SH.take(x @ params["embed"].t(), V, 0, V)
    return SH.take(x @ params["lm_head"], V, 0, V)


def _hybrid_groups(cfg):
    """[(start, len)] Mamba2-layer groups, each followed by the shared
    block; the last group holds what is left (81 = 13·6 + 3)."""
    out, i = [], 0
    while i < cfg.n_layers:
        out.append((i, min(cfg.attn_every, cfg.n_layers - i)))
        i += cfg.attn_every
    return out


def _ssm_groups(cfg):
    """[(start, len, shared block after?)] over the Mamba2 layers: the
    hybrid's groups, or the SSM family's one group with no attention."""
    if cfg.attn_every:
        return [(s, n, True) for s, n in _hybrid_groups(cfg)]
    return [(0, cfg.n_layers, False)]


def forward(params, cfg: ModelConfig, tokens, embeds=None, return_caches=False,
            return_hidden=False):
    """Full-sequence forward. Returns (logits|hidden, aux, caches|None):
    ``aux`` is the MoE load-balancing loss summed over the layers (0.0 in
    a dense, SSM or hybrid model). Caches are stacked: ``{"attn": ...}``
    on L, GQA's ``{"k", "v"}`` each ``(L, b, s, hkv, hd)``, MLA's
    ``{"ckv": (L, b, s, r), "krope": (L, b, s, rd)}``; an SSM's
    ``{"mamba": {"state": (L, b, nh, hp, ds), "conv": (L, b, K-1,
    conv_dim)}}``, and a hybrid's shared-block ``"attn"`` on its
    ``n_attn`` applications."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    kept = {"mamba": {}, "attn": {}}

    def keep(kind, cache):
        if return_caches:
            for name, t in cache.items():
                kept[kind].setdefault(name, []).append(t)

    aux = 0.0
    lps = layers(params["layers"])
    if is_ssm(cfg):
        # the reference remats its Mamba2 scan body, not the shared block
        for start, n, shared in _ssm_groups(cfg):
            for i in range(start, start + n):
                lp = SH.fsdp_layer(lps[i], cfg, "layers")
                x, cache = remat(ssm_block_full, cfg, x)(lp, cfg, x)
                keep("mamba", cache)
            if shared:
                x, cache, _ = attn_block_full(_shared(params, cfg), cfg, x,
                                              positions)
                keep("attn", cache)
    else:
        for i in range(cfg.n_layers):
            lp = SH.fsdp_layer(lps[i], cfg, "layers")
            x, cache, a = remat(attn_block_full, cfg, x)(lp, cfg, x,
                                                         positions)
            aux = aux + a
            keep("attn", cache)
    caches = ({kind: {name: torch.stack(ts) for name, ts in by.items()}
               for kind, by in kept.items() if by}
              if return_caches else None)
    if return_hidden:
        return x, aux, caches
    return _logits(params, cfg, x), aux, caches


def _shared(params, cfg):
    """A hybrid's shared attention block, its data-sharded weights
    gathered (`sharding.fsdp_layer`)."""
    return SH.fsdp_layer(params["shared_attn"], cfg, "shared_attn",
                         stacked=False)


# ----------------------------------------------------------------- serve
def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """The shapes of `init_cache`'s tree (whole, on one device)."""
    check_supported(cfg)
    L = cfg.n_layers
    out = {}
    if is_ssm(cfg):
        s = cfg.ssm
        _, nh, conv_dim, _ = SSM.dims(cfg)
        out["mamba"] = {"state": (L, batch, nh, s.head_dim, s.d_state),
                        "conv": (L, batch, s.conv_kernel - 1, conv_dim)}
        if not cfg.attn_every:
            return out
        L = len(_hybrid_groups(cfg))
    if cfg.mla is not None:
        m = cfg.mla
        out["attn"] = {"ckv": (L, batch, cache_len, m.kv_lora_rank),
                       "krope": (L, batch, cache_len, m.qk_rope_head_dim)}
    else:
        eff = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
               else cache_len)
        shape = (L, batch, eff, cfg.n_kv_heads, cfg.resolved_head_dim)
        out["attn"] = {"k": shape, "v": shape}
    return out


def cache_specs(cfg: ModelConfig, shapes: dict, batch: int):
    """The active layout's spec tree (`sharding.cache_pspecs`) of a cache
    of ``shapes`` at ``batch`` global rows; None on one device."""
    lay = SH.layout()
    if lay.mesh is None:
        return None
    return SH.cache_pspecs(cfg, shapes, lay.sizes, lay.dp, batch)


def zero_cache(shapes: dict, specs, dtype, device):
    """Zeroed tensors of ``shapes`` (a whole cache tree), or of the
    rank's blocks of them under ``specs``. The Mamba2 state is float32."""
    dev = resolve_device(device)
    lay = SH.layout()
    coords = lay.coords()

    def make(path, shape):
        if specs is not None:
            shape = tuple(b.stop - b.start for b in SH.local_block(
                shape, SH.at(specs, path), lay.sizes, coords))
        dt = torch.float32 if path[-1] == "state" else dtype
        return torch.zeros(shape, dtype=dt, device=dev)

    return SH._map_with_path(make, shapes)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device=None):
    """Zeroed cache: GQA's ``{"attn": {"k", "v"}}`` of ``(L, batch, S,
    hkv, hd)``, S = ``cache_len`` or, with a sliding window, at most the
    window; MLA's latent ``{"attn": {"ckv": (L, batch, cache_len, r),
    "krope": (L, batch, cache_len, rd)}}``. An SSM's ``{"mamba":
    {"state": (L, batch, nh, hp, ds) f32, "conv": (L, batch, K-1,
    conv_dim)}}``, and in a hybrid GQA's ``"attn"`` over ``n_attn``
    shared-block applications in place of L. Under a mesh context,
    ``batch`` counts global rows and each leaf is the rank's block."""
    shapes = cache_shapes(cfg, batch, cache_len)
    return zero_cache(shapes, cache_specs(cfg, shapes, batch),
                      dtype or DTYPES[cfg.dtype], device)


def global_batch(local_rows: int) -> int:
    """The global batch rows of the active layout: its ``batch``, or the
    local rows where the data axis holds one rank."""
    lay = SH.layout()
    if lay.batch is not None:
        return lay.batch
    if lay.data.size > 1:
        raise RuntimeError("under a data axis above 1 the global batch is "
                           "ambiguous: pass batch= to mesh_context")
    return local_rows


def fit(dst, src):
    """``src``'s time axis (2) into ``dst``'s S slots: the last S entries
    of a longer one (ring semantics, the reference's ``fit``), a shorter
    one into slots 0..T-1."""
    S, T = dst.shape[2], src.shape[2]
    if T >= S:
        dst.copy_(src[:, :, T - S:])
    else:
        dst[:, :, :T] = src


def store(dst, src, spec):
    """`fit` of ``src`` into the rank's block ``dst`` of a cache leaf:
    where ``spec`` spreads the time over an axis, the block of the whole
    fitted to every rank's slots."""
    ax = SH.time_axis(spec)
    if ax.size == 1:
        fit(dst, src)
        return
    S_l = dst.shape[2]
    whole = src.new_zeros((*src.shape[:2], S_l * ax.size, *src.shape[3:]))
    fit(whole, src)
    dst.copy_(whole[:, :, ax.rank * S_l:(ax.rank + 1) * S_l])


def fill_cache(out: dict, caches: dict, specs) -> dict:
    """A prefill's stacked caches (the rank's rows and heads, every
    position) into the rank's blocks ``out`` under ``specs``: attention
    caches fitted to their slots, Mamba2 caches copied whole."""
    for kind, by in out.items():
        for name, dst in by.items():
            src = caches[kind][name]
            if kind == "mamba":
                dst.copy_(src)
            else:
                store(dst, src, None if specs is None else specs[kind][name])
    return out


def prefill(params, cfg: ModelConfig, tokens, embeds=None,
            cache_len: Optional[int] = None):
    """Forward + cache extraction. Logits for the LAST position only, (b,
    1, V). Attention caches are padded or clipped to ``cache_len`` slots
    (`fit`); the Mamba2 caches are copied whole. Under a mesh context
    the cache is the rank's blocks (`sharding.cache_pspecs`) and the
    logits the rank's rows, every vocabulary column."""
    with tracing.span("prefill.forward"):
        x, _, caches = forward(params, cfg, tokens, embeds=embeds,
                               return_caches=True, return_hidden=True)
    with tracing.span("prefill.logits"):
        logits = _logits(params, cfg, x[:, -1:])
    with tracing.span("prefill.cache_fill"):
        batch = global_batch(tokens.shape[0])
        shapes = cache_shapes(cfg, batch, cache_len or x.shape[1])
        specs = cache_specs(cfg, shapes, batch)
        out = zero_cache(shapes, specs, DTYPES[cfg.dtype], x.device)
        return logits, fill_cache(out, caches, specs)


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token: (b, 1) ints; pos: absolute position of the token. Updates the
    cache IN PLACE (each attention layer's ring slot ``pos % S``, each
    Mamba2 layer's state and conv history) and returns ``(logits (b, 1,
    V), cache)``. Under a mesh context ``cache`` holds the rank's blocks
    and the context the cache's specs (`train_step.build_serve_step`)."""
    check_supported(cfg)
    x = embed_tokens(params["embed"], cfg, token)
    if is_ssm(cfg):
        for gi, (start, n, shared) in enumerate(_ssm_groups(cfg)):
            for i in range(start, start + n):
                lp = SH.fsdp_layer(layer(params["layers"], i), cfg, "layers")
                x, _ = ssm_block_decode(lp, cfg, x, layer(cache["mamba"], i))
            if shared:
                x, _ = attn_block_decode(_shared(params, cfg), cfg, x,
                                         layer(cache["attn"], gi), pos)
    else:
        for i in range(cfg.n_layers):
            lp = SH.fsdp_layer(layer(params["layers"], i), cfg, "layers")
            x, _ = attn_block_decode(lp, cfg, x, layer(cache["attn"], i), pos)
    return _logits(params, cfg, x), cache
