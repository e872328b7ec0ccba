"""Encoder-decoder LM (Whisper-small backbone), as in the JAX package's
`models/encdec.py`. The audio frontend is a stub: the encoder reads
precomputed frame embeddings (b, s_enc, d) through one learned linear
projection. Blocks are RMSNorm, SwiGLU and GQA; the encoder attends
non-causal and without RoPE, the decoder causal with RoPE, then across to
the encoder's keys (`attention.cross_full`).

Parameters are the reference's tree with the layers stacked on a leading
axis (``enc_layers`` on ``encoder_layers``, ``layers`` on ``n_layers``),
so `interop.params_from_arrays` carries its weights as they are. Where
autograd records, each encoder and decoder layer runs under ``cfg.remat``
(`transformer.remat`), as the reference's scan bodies do. Under a mesh
context (tensor- and expert-parallel serving and training) every block
runs on the rank's heads and FFN columns as the decoder-only families'
do, the cross K/V cache holds the rank's heads, and ``frontend`` is
replicated.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models import sharding as SH
from repro_torch.models.layers import rms_norm
from repro_torch.models.sharding import constrain


def param_shapes(cfg: ModelConfig) -> dict:
    """``init_params``'s tree: ``init_enc_layer`` stacked on the encoder
    layers, ``init_dec_layer`` (its ``xattn`` ``init_cross``'s) on the
    decoder layers."""
    T.check_supported(cfg)
    d, E, L, V = cfg.d_model, cfg.encoder_layers, cfg.n_layers, \
        cfg.padded_vocab
    enc = {"ln1": (E, d), "attn": A.gqa_param_shapes(cfg, (E,)),
           "ln2": (E, d), "ffn": T.ffn_shapes(cfg, (E,))}
    dec = {"ln1": (L, d), "attn": A.gqa_param_shapes(cfg, (L,)),
           "lnx": (L, d), "xattn": A.cross_param_shapes(cfg, (L,)),
           "ln2": (L, d), "ffn": T.ffn_shapes(cfg, (L,))}
    return {"frontend": (d, d), "embed": (V, d), "enc_layers": enc,
            "enc_norm": (d,), "layers": dec, "final_norm": (d,),
            "lm_head": (d, V)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, mesh=None, dp_axes=("data",), coords=None):
    """Random weights in the tree of `param_shapes`, with the reference's
    distributions (`transformer.build_params`; with a ``mesh``, the
    rank's blocks)."""
    return T.build_params(param_shapes(cfg), cfg, generator, device, mesh,
                          dp_axes, coords)


def _ffn(lp, cfg, x):
    return T.swiglu_ffn(lp["ffn"], cfg, rms_norm(x, lp["ln2"], cfg.norm_eps))


def encode(params, cfg: ModelConfig, frames):
    """frames (b, s, d) -> the encoder's normed output (b, s, d)."""
    x = constrain(frames.to(params["frontend"].dtype) @ params["frontend"],
                  ("dp", None, None))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    lps = T.layers(_encoder_blocks(params, cfg))
    for i in range(cfg.encoder_layers):
        x = T.remat(_enc_layer, cfg, x)(lps[i], cfg, x, positions)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _encoder_blocks(params, cfg):
    """``enc_layers`` as the rank's tensor-parallel blocks of stacked
    layers. The spec table (the reference's) gives ``enc_layers`` no
    layer axis — its path holds no ``"layers"`` — so a rank holds blocks
    of other dims (``wq``'s d, ``wo``'s layers): they are gathered whole
    over the axes they sit on, then cut as a stacked layer's are. In
    training the gathers' backward (a reduce-scatter) returns every
    rank's gradient of the whole to the blocks of the table's cut."""
    lay = SH.layout()
    if lay.mesh is None or not lay.blocks or (
            lay.model.size == 1 and lay.data.size == 1):
        return params["enc_layers"]
    table = SH.layer_specs(cfg, "enc_layers", stacked=False)
    whole = SH.gather_spec(params["enc_layers"], table, model=True)
    proper = SH.param_pspecs(cfg, {"layers": whole}, lay.sizes,
                             lay.dp)["layers"]
    coords = {a: 0 for a in lay.sizes}
    coords["model"] = lay.model.rank if lay.model.size > 1 else 0
    return SH._map_with_path(lambda path, t: t[SH.local_block(
        tuple(t.shape), _model_only(SH.at(proper, path)), lay.sizes,
        coords)],
        whole)


def _model_only(spec):
    return tuple(ax if ax == "model" else None for ax in spec)


def _enc_layer(lp, cfg, x, positions):
    h, _ = A.gqa_full(lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
                      positions, causal=False)
    x = x + h
    return constrain(x + _ffn(lp, cfg, x), ("dp", None, None))


def _dec_layer(lp, cfg, x, positions, enc):
    """One decoder layer: (x, its self K/V, its cross K/V)."""
    h, kv = A.gqa_full(lp["attn"], cfg, rms_norm(x, lp["ln1"], cfg.norm_eps),
                       positions)
    x = x + h
    ekv = A.cross_precompute(lp["xattn"], cfg, enc)
    x = x + A.cross_full(lp["xattn"], cfg,
                         rms_norm(x, lp["lnx"], cfg.norm_eps), ekv)
    return constrain(x + _ffn(lp, cfg, x), ("dp", None, None)), kv, ekv


def _decoder(params, cfg, tokens, enc, keep: bool):
    """The decoder over ``tokens`` against ``enc``: (hidden, self K/V and
    cross K/V of every layer when ``keep``)."""
    x = T.embed_tokens(params["embed"], cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    kept = {"k": [], "v": [], "ck": [], "cv": []}
    lps = T.layers(params["layers"])
    for i in range(cfg.n_layers):
        lp = SH.fsdp_layer(lps[i], cfg, "layers")
        x, kv, ekv = T.remat(_dec_layer, cfg, x)(lp, cfg, x, positions, enc)
        if keep:
            for name, t in (("k", kv["k"]), ("v", kv["v"]),
                            ("ck", ekv["k"]), ("cv", ekv["v"])):
                kept[name].append(t)
    return x, kept


def forward(params, cfg: ModelConfig, frames, tokens, return_caches=False,
            return_hidden=False, enc=None):
    """Encode ``frames`` (unless ``enc`` is given), then the decoder over
    ``tokens``. Returns (logits|hidden, 0.0, caches|None), caches
    ``{"attn": {"k", "v"}}`` of the decoder's self-attention, each
    ``(L, b, s, hkv, hd)``."""
    T.check_supported(cfg)
    if enc is None:
        enc = encode(params, cfg, frames)
    x, kept = _decoder(params, cfg, tokens, enc, return_caches)
    caches = ({"attn": {"k": torch.stack(kept["k"]),
                        "v": torch.stack(kept["v"])}}
              if return_caches else None)
    if return_hidden:
        return x, 0.0, caches
    return T._logits(params, cfg, x), 0.0, caches


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int,
                 enc_len: int) -> dict:
    """The shapes of `init_cache`'s tree (whole, on one device)."""
    T.check_supported(cfg)
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    self_shape = (L, batch, cache_len, cfg.n_kv_heads, hd)
    cross_shape = (L, batch, enc_len, cfg.n_heads, hd)
    return {name: {kv: shape for kv in ("k", "v")}
            for name, shape in (("attn", self_shape), ("cross", cross_shape))}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int,
               dtype=None, device=None):
    """Zeroed cache: the decoder's self-attention ``{"attn": {"k", "v"}}``
    of ``(L, batch, cache_len, hkv, hd)`` and the encoder's cross K/V
    ``{"cross": {"k", "v"}}`` of ``(L, batch, enc_len, h, hd)``, n_heads
    wide. Under a mesh context, ``batch`` counts global rows and each
    leaf is the rank's block."""
    shapes = cache_shapes(cfg, batch, cache_len, enc_len)
    return T.zero_cache(shapes, T.cache_specs(cfg, shapes, batch),
                        dtype or T.DTYPES[cfg.dtype], device)


def prefill(params, cfg: ModelConfig, frames, tokens, cache_len=None):
    """Encode once, then the teacher-forced decoder pass; builds the decode
    caches (self K/V fitted to ``cache_len`` slots, cross K/V whole). The
    cross K/V are computed once and kept, where the reference computes
    them a second time (the same values). Logits for the last position
    only, (b, 1, V). Under a mesh context the caches are the rank's
    blocks."""
    T.check_supported(cfg)
    enc = encode(params, cfg, frames)
    x, kept = _decoder(params, cfg, tokens, enc, True)
    logits = T._logits(params, cfg, x[:, -1:])
    batch = T.global_batch(tokens.shape[0])
    shapes = cache_shapes(cfg, batch, cache_len or tokens.shape[1],
                          enc.shape[1])
    specs = T.cache_specs(cfg, shapes, batch)
    out = T.zero_cache(shapes, specs, T.DTYPES[cfg.dtype], x.device)
    caches = {"attn": {"k": torch.stack(kept["k"]),
                       "v": torch.stack(kept["v"])},
              "cross": {"k": torch.stack(kept["ck"]),
                        "v": torch.stack(kept["cv"])}}
    return logits, T.fill_cache(out, caches, specs)


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token: (b, 1) ints; pos: its absolute position. Updates the self
    K/V cache IN PLACE (ring slot ``pos % S``) and attends across to the
    cached cross K/V; returns ``(logits (b, 1, V), cache)``."""
    T.check_supported(cfg)
    x = T.embed_tokens(params["embed"], cfg, token)
    spec = SH.cache_spec("cross", "k")
    cross_axis = SH.time_axis(spec)
    for i in range(cfg.n_layers):
        lp = SH.fsdp_layer(T.layer(params["layers"], i), cfg, "layers")
        h, _ = A.gqa_decode(lp["attn"], cfg,
                            rms_norm(x, lp["ln1"], cfg.norm_eps),
                            T.layer(cache["attn"], i), pos)
        x = x + h
        x = x + A.cross_full(lp["xattn"], cfg,
                             rms_norm(x, lp["lnx"], cfg.norm_eps),
                             T.layer(cache["cross"], i), cross_axis)
        x = x + _ffn(lp, cfg, x)
    return T._logits(params, cfg, x), cache
