"""Uniform model API: family dispatch, abstract parameters and step
inputs, and the training loss (the JAX package's `models/api.py`).
`abstract_params` and `input_specs` are the counterparts of the
reference's ``ShapeDtypeStruct`` trees: tensors on ``meta`` (shape and
dtype, no data), which the dry run (`launch/dryrun.py`) runs the port's
step on. Decoder-only configs (dense, MoE, SSM, hybrid, VLM) go
to `models/transformer.py`, whose VLM batches carry ``"embeds"`` (the
patch prefix) beside ``"tokens"``; encoder-decoder configs go to
`models/encdec.py`, whose batches carry ``"frames"``. `lm_loss` is the
next-token cross-entropy with a chunked vocabulary projection. Under a
model axis (slice E6a) the embedding and each chunk's logits are
vocab-parallel (`transformer.embed_tokens`, `transformer._logits`: the
logits gathered whole), and a VLM's patch embeddings are replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, transformer
from repro_torch.models import sharding as SH
from repro_torch.models.sharding import constrain


@dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    forward: Callable        # (params, cfg, batch) -> (logits, aux)
    hidden: Callable         # (params, cfg, batch) -> (pre-norm hidden, aux)
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes of ``cfg``'s family."""
    return (encdec if cfg.encoder_layers else transformer).param_shapes(cfg)


def get_api(cfg: ModelConfig) -> ModelAPI:
    transformer.check_supported(cfg)
    if cfg.encoder_layers:
        return ModelAPI(
            init_params=encdec.init_params,
            forward=lambda p, c, batch: encdec.forward(
                p, c, batch["frames"], batch["tokens"])[:2],
            hidden=lambda p, c, batch: encdec.forward(
                p, c, batch["frames"], batch["tokens"],
                return_hidden=True)[:2],
            prefill=lambda p, c, batch, cache_len=None: encdec.prefill(
                p, c, batch["frames"], batch["tokens"], cache_len),
            decode_step=encdec.decode_step,
            init_cache=lambda c, b, s, **kw: encdec.init_cache(c, b, s, s,
                                                               **kw),
        )
    return ModelAPI(
        init_params=transformer.init_params,
        forward=lambda p, c, batch: transformer.forward(
            p, c, batch["tokens"], embeds=batch.get("embeds"))[:2],
        hidden=lambda p, c, batch: transformer.forward(
            p, c, batch["tokens"], embeds=batch.get("embeds"),
            return_hidden=True)[:2],
        prefill=lambda p, c, batch, cache_len=None: transformer.prefill(
            p, c, batch["tokens"], embeds=batch.get("embeds"),
            cache_len=cache_len),
        decode_step=transformer.decode_step,
        init_cache=transformer.init_cache,
    )


def abstract_params(cfg: ModelConfig, device="meta") -> dict:
    """The parameter tree of ``cfg`` as empty tensors on ``device``: the
    shapes of `param_shapes`, the dtypes `init_params` gives
    (`transformer.param_dtype`). Nothing is drawn."""
    return SH._map_with_path(lambda path, shape: torch.empty(
        shape, dtype=transformer.param_dtype(cfg, path[-1]), device=device),
        param_shapes(cfg))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """The inputs of one (arch × shape) cell's step as empty tensors on
    ``device`` (the reference's ``input_specs``):

    train:   tokens (B, S+1) — the model reads [:, :-1], labels [:, 1:]
    prefill: tokens (B, S)
    decode:  token (B, 1), the cache of S slots (`init_cache`, zeroed),
             and pos, a 0-d int32 (serving passes a host int)
    A VLM's patch embeddings (B, n_patches, d) are part of S; an
    encoder-decoder's frames (B, S, d) feed the encoder."""
    B, S = shape.global_batch, shape.seq_len
    dt = transformer.DTYPES[cfg.dtype]

    def ids(*s):
        return torch.empty(s, dtype=torch.int32, device=device)

    def emb(*s):
        return torch.empty(s, dtype=dt, device=device)

    if shape.kind in ("train", "prefill"):
        extra = 1 if shape.kind == "train" else 0
        if cfg.encoder_layers:
            return {"frames": emb(B, S, cfg.d_model),
                    "tokens": ids(B, S + extra)}
        if cfg.n_patches:
            return {"embeds": emb(B, cfg.n_patches, cfg.d_model),
                    "tokens": ids(B, S - cfg.n_patches + extra)}
        return {"tokens": ids(B, S + extra)}
    cache = get_api(cfg).init_cache(cfg, B, S, device=device)
    return {"cache": cache, "token": ids(B, 1), "pos": ids()}


def lm_loss(params, cfg: ModelConfig, batch, aux_weight: float = 0.01,
            ce_chunk_tokens: int = 32_768):
    """Next-token cross-entropy with a CHUNKED vocabulary projection, plus
    ``aux_weight`` times the MoE load-balancing loss.

    ``batch["tokens"]`` is (B, S + 1): the model reads ``[:, :-1]`` and is
    scored on ``[:, 1:]``. A VLM's hidden states cover patches and text,
    and only the text positions are scored. The backbone's (B, S, d)
    output is projected in sequence chunks of C positions, C the largest
    divisor of S at most ``ce_chunk_tokens // B``; each chunk's logits go
    to f32, the vocabulary's padding columns to ``-1e30``, and the chunk
    runs under `torch.utils.checkpoint` where autograd records, so the
    backward pass re-projects it instead of keeping its logits."""
    api = get_api(cfg)
    tokens = batch["tokens"]
    inputs = dict(batch)
    inputs["tokens"] = tokens[:, :-1]
    x, aux = api.hidden(params, cfg, inputs)
    if cfg.n_patches and not cfg.encoder_layers:
        x = x[:, cfg.n_patches:, :]
    labels = tokens[:, 1:].long()
    B, S = labels.shape
    C = max(1, min(S, ce_chunk_tokens // max(B, 1)))
    while S % C:
        C -= 1
    pad = (torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
           if cfg.padded_vocab != cfg.vocab else None)

    def chunk_nll(x_c, y_c):
        logits = constrain(transformer._logits(params, cfg, x_c).float(),
                           ("dp", None, "model"))
        if pad is not None:
            logits = torch.where(pad, logits, -1e30)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y_c[..., None])[..., 0]
        return (logz - gold).sum()

    records = torch.is_grad_enabled() and x.requires_grad
    total = 0.0
    for c0 in range(0, S, C):
        args = (x[:, c0:c0 + C], labels[:, c0:c0 + C])
        total = total + (checkpoint(chunk_nll, *args, use_reentrant=False)
                         if records else chunk_nll(*args))
    return total / (B * S) + aux_weight * aux
