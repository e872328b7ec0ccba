"""Plain PyTorch version of the row-min hash kernel (exact on any device).

u32 words arrive as int32 tensors holding the bit pattern; they are widened
to int64 masked with 0xFFFFFFFF and hashed by the port's one u32 hash
(`kernels/bitset_fold/carry.hash_u32`, 16-bit split multiplies), since
torch on the CPU has no uint32 add, shift or min.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset_fold.carry import M32, hash_u32

_BUDGET = 1 << 24  # int64 elements of the (rows, W) temporaries


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → int64 u32 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def as_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 u32 values → the int32 tensor with the same 32 bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def rowmin_hash(nbr: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``(R, W)`` int32 (u32 words, sentinel ``0xFFFFFFFF``) → ``(R,)``
    int32 (u32 bits) min of ``hash_u32`` over each row's non-sentinel
    words; ``0xFFFFFFFF`` for a row of sentinels only. Rows go in chunks
    that bound the int64 temporaries."""
    R, W = nbr.shape
    out = torch.empty(R, dtype=torch.int32, device=nbr.device)
    step = max(1, _BUDGET // max(1, W))
    for r0 in range(0, R, step):
        x = as_u32(nbr[r0:r0 + step])
        h = torch.where(x != M32, hash_u32(x, a, b), M32)
        mins = h.amin(dim=1) if W else torch.full(
            (x.shape[0],), M32, dtype=torch.int64, device=nbr.device)
        out[r0:r0 + step] = as_i32(mins)
    return out
