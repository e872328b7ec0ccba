"""Plain PyTorch version of the batched intersection kernel.

Exact on any device, including the CPU, where torch has no uint32
arithmetic and no popcount: words are widened to int64 masked with
0xFFFFFFFF and counted with a SWAR popcount (every intermediate stays below
2^57, so nothing wraps).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_BUDGET = 1 << 24  # int64 elements of the (rows, G, G, W) temporary


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of 32-bit words given as int32 (bit-identical
    view of uint32) or int64 in [0, 2^32); returns int64."""
    x = x.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def bitset_intersections(bits: torch.Tensor, valid: int) -> torch.Tensor:
    """bits ``(B, G, W)`` int32 (uint32 words) → ``(B, G, G)`` int32
    ``popcount(row_i & row_j)`` summed over W; batch rows ≥ ``valid`` are
    zero. Batch rows go in chunks that bound the ``(·, G, G, W)``
    temporary."""
    B, G, W = bits.shape
    out = torch.zeros((B, G, G), dtype=torch.int32, device=bits.device)
    valid = min(int(valid), B)
    step = max(1, _BUDGET // max(1, G * G * W))
    for b0 in range(0, valid, step):
        rows = bits[b0:min(b0 + step, valid)]
        inter = popcount_u32(rows[:, :, None, :] & rows[:, None, :, :])
        out[b0:b0 + rows.shape[0]] = inter.sum(-1).to(torch.int32)
    return out


def pairwise_intersection(bits: torch.Tensor) -> torch.Tensor:
    """bits ``(G, W)`` int32 (uint32 words) → ``(G, G)`` int32
    ``popcount(row_i & row_j)`` summed over W. Rows go in chunks that
    bound the ``(rows, G, W)`` temporary."""
    G, W = bits.shape
    out = torch.empty((G, G), dtype=torch.int32, device=bits.device)
    step = max(1, _BUDGET // max(1, G * W))
    for i0 in range(0, G, step):
        inter = popcount_u32(bits[i0:i0 + step, None, :] & bits[None, :, :])
        out[i0:i0 + step] = inter.sum(-1).to(torch.int32)
    return out
