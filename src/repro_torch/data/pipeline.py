"""Deterministic synthetic LM data pipeline (the JAX package's
`data/pipeline.py`).

Zipf-mixture token streams packed to (batch, seq + 1), pure in (seed,
step), so a resumed run replays its batches bit for bit. The batch
arrays are numpy, drawn exactly as the reference draws them, so both
packages see the same tokens, frames and patch embeddings. Under a mesh
(`TokenStream.batch_sharded`, ``make_batch(..., mesh=)``) each rank keeps
only its block of rows along the data axes — the reference's host-sharded
placement.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.launch.mesh import block, dp_rank, dp_size
from repro_torch.models.sharding import batch_pspec
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

    def batch_sharded(self, step: int, mesh, dp_axes) -> np.ndarray:
        """This rank's rows of ``batch_np(step)``: its block along the
        ``dp_axes`` of ``mesh`` (the reference's ``P(dp, None)``), or
        every row when the batch does not split evenly over them (its
        ``batch_pspec`` then replicates)."""
        return _rows(self.batch_np(step), mesh, dp_axes)


def _noise(seed: int, step: int, salt: int, shape, dtype, device):
    """N(0, 1) float64 noise of (seed, step, salt), cast to ``dtype``
    (float64 → ``dtype`` in one rounding, as the reference's
    ``jnp.asarray(x, dtype)`` casts it) and moved to ``device``."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, step, salt)))
    return torch.from_numpy(rng.normal(size=shape)).to(dtype).to(device)


def _rows(arr, mesh, dp_axes):
    """This rank's block of ``arr``'s rows along the data axes, or all of
    them when they do not split evenly (`sharding.batch_pspec`)."""
    if mesh is None:
        return arr
    if batch_pspec(mesh, dp_axes, arr.shape[0])[0] is None:
        return arr
    return arr[block(arr.shape[0], dp_rank(mesh, dp_axes),
                     dp_size(mesh, dp_axes))]


def make_batch(cfg, stream: TokenStream, step: int, device=None, mesh=None,
               dp_axes=("data",)) -> dict:
    """Step ``step``'s batch on ``device`` (``None``: the CUDA card, which
    must exist): ``"tokens"`` (batch, seq + 1) int32; an encoder-decoder
    adds ``"frames"`` (batch, seq, d), a VLM ``"embeds"`` (batch,
    n_patches, d), each N(0, 1) in ``cfg.dtype`` from its own stream.
    Under a ``mesh`` each entry holds this rank's rows only
    (`TokenStream.batch_sharded`)."""
    dev = resolve_device(device)
    toks = (stream.batch_np(step) if mesh is None
            else stream.batch_sharded(step, mesh, dp_axes))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    dtype = DTYPES[cfg.dtype]
    if cfg.encoder_layers:
        batch["frames"] = _rows(_noise(stream.seed, step, 1,
                                       (stream.batch, stream.seq,
                                        cfg.d_model), dtype, dev),
                                mesh, dp_axes)
    elif cfg.n_patches:
        batch["embeds"] = _rows(_noise(stream.seed, step, 2,
                                       (stream.batch, cfg.n_patches,
                                        cfg.d_model), dtype, dev),
                                mesh, dp_axes)
    return batch
