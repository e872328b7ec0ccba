"""Deterministic synthetic LM data pipeline (the JAX package's
`data/pipeline.py`, single-device).

Zipf-mixture token streams packed to (batch, seq + 1), pure in (seed,
step), so a resumed run replays its batches bit for bit. The batch
arrays are numpy, drawn exactly as the reference draws them, so both
packages see the same tokens, frames and patch embeddings. The
host-sharded placement onto a mesh (``batch_sharded``) belongs to the
multi-device slice and is not here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.transformer import DTYPES


class TokenStream:
    """Stateless per-step batch generator: ``batch_np(step)`` is pure in
    (seed, step). Needs ``seq > 16`` (the 16-token motif)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 zipf_a: float = 1.3):
        self.vocab, self.batch, self.seq, self.seed, self.zipf_a = \
            vocab, batch, seq, seed, zipf_a

    def batch_np(self, step: int) -> np.ndarray:
        """(batch, seq + 1) int32 tokens of ``step``."""
        # an entropy tuple, not seed arithmetic: (seed << 20) ^ step would
        # alias streams once step passed 20 bits
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, step)))
        # zipf over the vocab, plus short repeated motifs (compressible)
        raw = rng.zipf(self.zipf_a, size=(self.batch, self.seq + 1)).astype(
            np.int64)
        toks = (raw - 1) % self.vocab
        # motif repetitions give the LM learnable structure
        motif = rng.integers(0, self.vocab, size=16)
        pos = rng.integers(0, self.seq - 16, size=self.batch)
        for i, p in enumerate(pos):
            if rng.random() < 0.5:
                toks[i, p:p + 16] = motif
        return toks.astype(np.int32)


def _noise(seed: int, step: int, salt: int, shape, dtype, device):
    """N(0, 1) float64 noise of (seed, step, salt), cast to ``dtype``
    (float64 → ``dtype`` in one rounding, as the reference's
    ``jnp.asarray(x, dtype)`` casts it) and moved to ``device``."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, step, salt)))
    return torch.from_numpy(rng.normal(size=shape)).to(dtype).to(device)


def make_batch(cfg, stream: TokenStream, step: int, device=None) -> dict:
    """Step ``step``'s batch on ``device`` (``None``: the CUDA card, which
    must exist): ``"tokens"`` (batch, seq + 1) int32; an encoder-decoder
    adds ``"frames"`` (batch, seq, d), a VLM ``"embeds"`` (batch,
    n_patches, d), each N(0, 1) in ``cfg.dtype`` from its own stream."""
    dev = resolve_device(device)
    batch = {"tokens": torch.from_numpy(stream.batch_np(step)).to(dev)}
    dtype = DTYPES[cfg.dtype]
    if cfg.encoder_layers:
        batch["frames"] = _noise(stream.seed, step, 1,
                                 (stream.batch, stream.seq, cfg.d_model),
                                 dtype, dev)
    elif cfg.n_patches:
        batch["embeds"] = _noise(stream.seed, step, 2,
                                 (stream.batch, cfg.n_patches, cfg.d_model),
                                 dtype, dev)
    return batch
