"""Gradient compression for the data-parallel reduction (the JAX
package's `optim/grad_compression.py`).

Each block of 256 values is scaled by its absolute maximum over 127 and
rounded to int8: to nearest (half to even, as ``jnp.round``) without a
generator, stochastically with one (uniform noise in [-0.5, 0.5) added
before rounding, so the rounding is unbiased). `compressed_psum` is the
error-feedback all-reduce built on it: every rank quantizes ``g + err``
against a SHARED per-block scale (a MAX all-reduce of the local absmax),
the int8 payloads are summed as int32 over the group, the mean comes back
in f32 and the local quantization error is carried to the next step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.optim.adamw import leaves, tree_map, unflatten

BLOCK = 256


def _blockwise_scale(x: torch.Tensor):
    """Per-block absmax scales; x flattened to (nblocks, BLOCK)."""
    n = x.shape[0]
    xb = F.pad(x, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = xb.abs().amax(dim=1, keepdim=True) / 127.0
    return xb, scale, n


def quantize_int8(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """x: (n,) f32 -> (int8 blocks (nblocks, 256), f32 scales (nblocks, 1),
    n). Stochastic rounding when ``generator`` is given (drawn on its
    device, which must be x's)."""
    xb, scale, n = _blockwise_scale(x)
    return _round_int8(xb / torch.clamp(scale, min=1e-12), generator), \
        scale, n


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int):
    return (q.float() * scale).reshape(-1)[:n]


def _round_int8(y: torch.Tensor, generator):
    if generator is not None:
        y = y + (torch.rand(y.shape, generator=generator, device=y.device,
                            dtype=y.dtype) - 0.5)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def compressed_psum(g_flat: torch.Tensor, err: torch.Tensor, group=None,
                    generator: Optional[torch.Generator] = None):
    """One error-feedback compressed all-reduce step over ``group`` (the
    data axis' process group; ``None`` is the default group), in the
    reference's op order: shared block scale by MAX all-reduce, int8
    round (half to even without a ``generator``), int32 SUM, the mean over
    the group's size, the error carried.

    g_flat: (n,) f32 local gradient; err: (n,) f32 carried residual.
    Returns ``(mean over ranks, new_err)``, both (n,) f32."""
    corrected = g_flat + err
    xb, scale, n = _blockwise_scale(corrected)
    dist.all_reduce(scale, dist.ReduceOp.MAX, group=group)
    q = _round_int8(xb / torch.clamp(scale, min=1e-12), generator)
    new_err = corrected - dequantize_int8(q, scale, n)
    acc = q.to(torch.int32)
    dist.all_reduce(acc, group=group)
    mean = (acc.float() * scale).reshape(-1)[:n] / dist.get_world_size(group)
    return mean, new_err


def flatten_grads(grads):
    """Every leaf (the reference's flatten order: sorted keys) flattened and
    concatenated in f32, and what `unflatten_grads` needs to undo it."""
    ls = leaves(grads)
    flat = torch.cat([t.reshape(-1).float() for t in ls])
    return flat, (tree_map(lambda t: tuple(t.shape), grads),
                  [t.numel() for t in ls])


def unflatten_grads(flat: torch.Tensor, meta):
    """The tree of `flatten_grads`' input, its leaves cut from ``flat``
    (f32) in their shapes."""
    shapes, sizes = meta
    return unflatten(shapes, [t.reshape(shape) for t, shape in zip(
        flat.split(sizes), leaves(shapes))])
