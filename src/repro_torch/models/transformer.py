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
sits where the reference's does: the identity on a data axis, raising
under a model axis above 1 (slice E6).

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
from typing import Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import init_linear, rms_norm, swiglu
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


def build_params(spec: dict, cfg: ModelConfig, generator=None, device=None):
    """Random weights on ``device`` (``None``: the CUDA card, which must
    exist) in the tree ``spec`` of shapes, drawn from ``generator``
    (default: seed 0 on that device) with the reference's distributions:
    embedding N(0, 0.02²), linears and experts N(0, 1/d_in), a Mamba2
    conv N(0, 1)·0.1, norms and the skip ``D`` 1, biases, ``A_log`` and
    ``dt_bias`` 0; the MoE router and ``A_log``, ``D``, ``dt_bias`` in
    float32 whatever ``cfg.dtype``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw "
                         f"weights for {dev}")
    dtype = DTYPES[cfg.dtype]

    def draw(name, shape):
        dt = (torch.float32 if name == "router" or name in SSM.F32_PARAMS
              else dtype)
        if name in ONES:
            return torch.ones(shape, dtype=dt, device=dev)
        if name in ZEROS:
            return torch.zeros(shape, dtype=dt, device=dev)
        if name == "embed":
            return init_linear(generator, *shape, dtype, scale=0.02)
        if name == "conv_w":  # the reference casts, then scales
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=torch.float32).to(dtype) * 0.1
        return init_linear(generator, *shape[-2:], dt, lead=shape[:-2])

    def build(spec):
        return {k: build(v) if isinstance(v, dict) else draw(k, v)
                for k, v in spec.items()}

    return build(spec)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random weights in the tree of `param_shapes` (`build_params`). The
    reference's ``jax.random`` stream is not reproduced; carry its
    weights with `interop.params_from_arrays` where the same numbers are
    needed."""
    return build_params(param_shapes(cfg), cfg, generator, device)


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
def _ffn(p, cfg: ModelConfig, h2):
    """The block's FFN: (out, aux loss), the dense SwiGLU's aux 0."""
    if cfg.moe is not None:
        return MOE.moe_ffn(p["moe"], cfg, h2)
    return swiglu(h2, p["ffn"]["w_gate"], p["ffn"]["w_up"],
                  p["ffn"]["w_down"]), 0.0


def attn_block_full(p, cfg: ModelConfig, x, positions):
    full = A.mla_full if cfg.mla is not None else A.gqa_full
    h, cache = full(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                    positions)
    x = constrain(x + h, ("dp", None, None))
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
def _embed(params, cfg, tokens, embeds):
    x = params["embed"][tokens]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return constrain(x, ("dp", None, None))


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


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
                x, cache = remat(ssm_block_full, cfg, x)(lps[i], cfg, x)
                keep("mamba", cache)
            if shared:
                x, cache, _ = attn_block_full(params["shared_attn"], cfg, x,
                                              positions)
                keep("attn", cache)
    else:
        for i in range(cfg.n_layers):
            x, cache, a = remat(attn_block_full, cfg, x)(lps[i], cfg, x,
                                                         positions)
            aux = aux + a
            keep("attn", cache)
    caches = ({kind: {name: torch.stack(ts) for name, ts in by.items()}
               for kind, by in kept.items() if by}
              if return_caches else None)
    if return_hidden:
        return x, aux, caches
    return _logits(params, cfg, x), aux, caches


# ----------------------------------------------------------------- serve
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device=None):
    """Zeroed cache: GQA's ``{"attn": {"k", "v"}}`` of ``(L, batch, S,
    hkv, hd)``, S = ``cache_len`` or, with a sliding window, at most the
    window; MLA's latent ``{"attn": {"ckv": (L, batch, cache_len, r),
    "krope": (L, batch, cache_len, rd)}}``. An SSM's ``{"mamba":
    {"state": (L, batch, nh, hp, ds) f32, "conv": (L, batch, K-1,
    conv_dim)}}``, and in a hybrid GQA's ``"attn"`` over ``n_attn``
    shared-block applications in place of L."""
    check_supported(cfg)
    dtype = dtype or DTYPES[cfg.dtype]
    dev = resolve_device(device)
    L = cfg.n_layers
    out = {}
    if is_ssm(cfg):
        s = cfg.ssm
        _, nh, conv_dim, _ = SSM.dims(cfg)
        out["mamba"] = {
            "state": torch.zeros((L, batch, nh, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=dev),
            "conv": torch.zeros((L, batch, s.conv_kernel - 1, conv_dim),
                                dtype=dtype, device=dev)}
        if not cfg.attn_every:
            return out
        L = len(_hybrid_groups(cfg))
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"ckv": (L, batch, cache_len, m.kv_lora_rank),
                  "krope": (L, batch, cache_len, m.qk_rope_head_dim)}
    else:
        eff = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
               else cache_len)
        shape = (L, batch, eff, cfg.n_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": shape, "v": shape}
    out["attn"] = {name: torch.zeros(shape, dtype=dtype, device=dev)
                   for name, shape in shapes.items()}
    return out


def fit(dst, src):
    """``src``'s time axis (2) into ``dst``'s S slots: the last S entries
    of a longer one (ring semantics, the reference's ``fit``), a shorter
    one into slots 0..T-1."""
    S, T = dst.shape[2], src.shape[2]
    if T >= S:
        dst.copy_(src[:, :, T - S:])
    else:
        dst[:, :, :T] = src


def prefill(params, cfg: ModelConfig, tokens, embeds=None,
            cache_len: Optional[int] = None):
    """Forward + cache extraction. Logits for the LAST position only, (b,
    1, V). Attention caches are padded or clipped to ``cache_len`` slots
    (`fit`); the Mamba2 caches are copied whole."""
    x, _, caches = forward(params, cfg, tokens, embeds=embeds,
                           return_caches=True, return_hidden=True)
    logits = _logits(params, cfg, x[:, -1:])
    b, s_total = tokens.shape[0], x.shape[1]
    out = init_cache(cfg, b, cache_len or s_total, device=x.device)
    for name, dst in out.get("attn", {}).items():
        fit(dst, caches["attn"][name])
    for name, dst in out.get("mamba", {}).items():
        dst.copy_(caches["mamba"][name])
    return logits, out


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token: (b, 1) ints; pos: absolute position of the token. Updates the
    cache IN PLACE (each attention layer's ring slot ``pos % S``, each
    Mamba2 layer's state and conv history) and returns ``(logits (b, 1,
    V), cache)``."""
    check_supported(cfg)
    x = params["embed"][token]
    if is_ssm(cfg):
        for gi, (start, n, shared) in enumerate(_ssm_groups(cfg)):
            for i in range(start, start + n):
                x, _ = ssm_block_decode(layer(params["layers"], i), cfg, x,
                                        layer(cache["mamba"], i))
            if shared:
                x, _ = attn_block_decode(params["shared_attn"], cfg, x,
                                         layer(cache["attn"], gi), pos)
    else:
        for i in range(cfg.n_layers):
            x, _ = attn_block_decode(layer(params["layers"], i), cfg, x,
                                     layer(cache["attn"], i), pos)
    return _logits(params, cfg, x), cache
