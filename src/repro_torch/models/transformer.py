"""Decoder-only LM, the dense and MoE families with GQA or MLA attention
(the JAX package's `models/transformer.py`, forward and serving only).

Parameters are a plain dict of tensors in the reference's tree and
layout: weights ``(d_in, d_out)`` so ``x @ w`` mirrors its einsums, and the
layers stacked on a leading L axis (``params["layers"]["attn"]["wq"]`` is
``(L, d, hq·hd)``), so `interop.params_from_arrays` carries the
reference's weights over as they are. ``lax.scan`` over the layers becomes
a Python loop over views of that stack. ``sharding.constrain`` is the
identity on one device and is left out.

The SSM and hybrid families and the encoder-decoder and VLM configs
raise `NotImplementedError` naming the slice that ports them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.layers import init_linear, rms_norm, swiglu

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ModelConfig):
    """Raise `NotImplementedError` unless ``cfg`` is a decoder-only model
    of the dense or MoE family, with GQA or MLA attention."""
    if cfg.family in ("ssm", "hybrid") or cfg.ssm is not None \
            or cfg.attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the SSM and hybrid families are not ported yet "
            f"(slice F4)")
    if cfg.encoder_layers or cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(slice F5)")
    if cfg.n_patches or cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: vision-language models are not ported yet "
            f"(slice F6)")
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  f"not ported")


# ----------------------------------------------------------------- init
def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's tree, layers stacked
    on a leading L axis): ``attn`` is GQA's or MLA's, and ``moe`` takes
    the place of ``ffn`` in the MoE family."""
    check_supported(cfg)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim
    hq, hkv, V = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.padded_vocab
    if cfg.mla is not None:
        attn = A.mla_param_shapes(cfg, (L,))
    else:
        attn = {"wq": (L, d, hq), "wk": (L, d, hkv), "wv": (L, d, hkv),
                "wo": (L, hq, d)}
        if cfg.qkv_bias:
            attn.update(bq=(L, hq), bk=(L, hkv), bv=(L, hkv))
    layers = {"ln1": (L, d), "ln2": (L, d), "attn": attn}
    if cfg.moe is not None:
        layers["moe"] = MOE.param_shapes(cfg, (L,))
    else:
        layers["ffn"] = {"w_gate": (L, d, cfg.d_ff), "w_up": (L, d, cfg.d_ff),
                         "w_down": (L, cfg.d_ff, d)}
    p = {"embed": (V, d), "final_norm": (d,), "layers": layers}
    if not cfg.tie_embeddings:
        p["lm_head"] = (d, V)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random weights on ``device`` (``None``: the CUDA card, which must
    exist) in the tree of `param_shapes`, drawn from ``generator``
    (default: seed 0 on that device) with the reference's distributions:
    embedding N(0, 0.02²), linears and experts N(0, 1/d_in), norms
    (``kv_norm`` too) 1, biases 0; the MoE router in float32 whatever
    ``cfg.dtype``. The reference's ``jax.random`` stream is not
    reproduced; carry its weights with `interop.params_from_arrays` where
    the same numbers are needed."""
    spec = param_shapes(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot draw "
                         f"weights for {dev}")
    dtype = DTYPES[cfg.dtype]

    def draw(name, shape):
        if name in ("ln1", "ln2", "final_norm", "kv_norm"):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name in ("bq", "bk", "bv"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        if name == "embed":
            return init_linear(generator, *shape, dtype, scale=0.02)
        # the MoE router is float32 in every model, as in the reference
        dt = torch.float32 if name == "router" else dtype
        return init_linear(generator, *shape[-2:], dt, lead=shape[:-2])

    def build(spec):
        return {k: build(v) if isinstance(v, dict) else draw(k, v)
                for k, v in spec.items()}

    return build(spec)


def layer(tree, i: int):
    """Layer ``i``'s parameters (or cache): views into the L-stacked tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


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
    x = x + h
    f, aux = _ffn(p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + f, cache, aux


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


# --------------------------------------------------------------- forward
def _embed(params, cfg, tokens, embeds):
    x = params["embed"][tokens]
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].t()
    return x @ params["lm_head"]


def forward(params, cfg: ModelConfig, tokens, embeds=None, return_caches=False,
            return_hidden=False):
    """Full-sequence forward. Returns (logits|hidden, aux, caches|None):
    ``aux`` is the MoE load-balancing loss summed over the layers (0.0 in
    a dense model); caches are ``{"attn": ...}`` stacked on L, GQA's
    ``{"k", "v"}`` each ``(L, b, s, hkv, hd)``, MLA's ``{"ckv": (L, b, s,
    r), "krope": (L, b, s, rd)}``."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    kept = {}
    aux = 0.0
    for i in range(cfg.n_layers):
        x, cache, a = attn_block_full(layer(params["layers"], i), cfg, x,
                                      positions)
        aux = aux + a
        if return_caches:
            for name, t in cache.items():
                kept.setdefault(name, []).append(t)
    caches = ({"attn": {name: torch.stack(ts) for name, ts in kept.items()}}
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
    "krope": (L, batch, cache_len, rd)}}``."""
    check_supported(cfg)
    dtype = dtype or DTYPES[cfg.dtype]
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"ckv": (L, batch, cache_len, m.kv_lora_rank),
                  "krope": (L, batch, cache_len, m.qk_rope_head_dim)}
    else:
        eff = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
               else cache_len)
        shape = (L, batch, eff, cfg.n_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": shape, "v": shape}
    return {"attn": {name: torch.zeros(shape, dtype=dtype, device=dev)
                     for name, shape in shapes.items()}}


def prefill(params, cfg: ModelConfig, tokens, embeds=None,
            cache_len: Optional[int] = None):
    """Forward + cache extraction, padded or clipped to ``cache_len``
    slots. Logits for the LAST position only, (b, 1, V). A prompt longer
    than the cache keeps its last S entries in slots 0..S-1, as the
    reference's ``fit`` does."""
    x, _, caches = forward(params, cfg, tokens, embeds=embeds,
                           return_caches=True, return_hidden=True)
    logits = _logits(params, cfg, x[:, -1:])
    b, s_total = tokens.shape[0], x.shape[1]
    out = init_cache(cfg, b, cache_len or s_total, device=x.device)
    for name, dst in out["attn"].items():
        src = caches["attn"][name]
        S, T = dst.shape[2], src.shape[2]
        if T >= S:  # keep the last S entries (ring semantics)
            dst.copy_(src[:, :, T - S:])
        else:
            dst[:, :, :T] = src
    return logits, out


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token: (b, 1) ints; pos: absolute position of the token. Updates the
    cache IN PLACE (each layer's ring slot ``pos % S``) and returns
    ``(logits (b, 1, V), cache)``."""
    check_supported(cfg)
    x = params["embed"][token]
    for i in range(cfg.n_layers):
        x, _ = attn_block_decode(layer(params["layers"], i), cfg, x,
                                 layer(cache["attn"], i), pos)
    return _logits(params, cfg, x), cache
