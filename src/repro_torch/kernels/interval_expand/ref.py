"""Plain PyTorch version of the interval-count kernel (exact on any
device)."""
from __future__ import annotations

import torch

_BUDGET = 1 << 24  # elements of the (rows, E, P) comparison temporary


def interval_counts(lo: torch.Tensor, hi: torch.Tensor, sign: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """``(B, E)`` int32 intervals and ``(B, P)`` int32 probes → ``(B, P)``
    int32 ``count[b, p] = Σ_e sign[b, e]·[lo[b, e] ≤ pos[b, p] < hi[b, e]]``.
    Rows go in chunks that bound the ``(·, E, P)`` temporary."""
    B, E = lo.shape
    P = pos.shape[1]
    out = torch.zeros((B, P), dtype=torch.int32, device=lo.device)
    step = max(1, _BUDGET // max(1, E * P))
    for b0 in range(0, B, step):
        rows = slice(b0, min(b0 + step, B))
        p = pos[rows, None, :]
        inside = (lo[rows, :, None] <= p) & (p < hi[rows, :, None])
        out[rows] = (inside * sign[rows, :, None]).sum(dim=1,
                                                       dtype=torch.int32)
    return out
