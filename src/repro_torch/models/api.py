"""Uniform model API for decoder-only configs (the JAX package's
`models/api.py`, without the abstract specs that wait for tooling,
slice G, and `lm_loss`, which waits for training)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    forward: Callable        # (params, cfg, batch) -> (logits, aux)
    hidden: Callable         # (params, cfg, batch) -> (pre-norm hidden, aux)
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def get_api(cfg: ModelConfig) -> ModelAPI:
    transformer.check_supported(cfg)
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
