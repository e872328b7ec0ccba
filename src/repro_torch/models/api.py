"""Uniform model API: family dispatch (the JAX package's `models/api.py`,
without the abstract specs that wait for tooling, slice G, and
`lm_loss`, which waits for training). Decoder-only configs (dense, MoE,
SSM, hybrid) go to `models/transformer.py`, encoder-decoder configs to
`models/encdec.py`, whose batches carry ``"frames"`` beside
``"tokens"``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


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
