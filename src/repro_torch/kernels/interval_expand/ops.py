"""Public dispatch for batched signed interval-membership counts.

`batch_interval_counts` is what the batched query engine calls: given each
query's padded incident intervals (lo, hi, sign) and its probe positions,
return the signed containment count per probe. ``backend="kernel"`` ships
the tiles to ``device`` and runs `kernel.interval_counts` there (the CUDA
kernel on a card, its plain version on the CPU); ``backend="numpy"`` is
the plain host broadcast reduction. The kernel takes any (B, E, P), so no
padding is added here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.interval_expand.kernel import interval_counts


def batch_interval_counts(lo: np.ndarray, hi: np.ndarray, sign: np.ndarray,
                          pos: np.ndarray, backend: str = "numpy",
                          device=None) -> np.ndarray:
    """(B, E) int intervals + (B, P) int probes -> (B, P) int64 counts.

    Padding contract: interval slots beyond a query's degree carry
    lo == hi == 0 (and sign 0); probe slots beyond a query's probe count are
    -1. Both match nothing, so padded slots contribute zero.
    """
    B, E = lo.shape
    P = pos.shape[1]
    if B == 0 or P == 0:
        return np.zeros((B, P), dtype=np.int64)
    if backend == "numpy":
        inside = (lo[:, :, None] <= pos[:, None, :]) & (pos[:, None, :] < hi[:, :, None])
        return (inside * sign[:, :, None].astype(np.int64)).sum(axis=1)
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}; use 'numpy' or "
                         f"'kernel'")
    if device is None:
        raise ValueError("backend='kernel' needs the device to count on")

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    counts = interval_counts(up(lo), up(hi), up(sign), up(pos))
    return counts.cpu().numpy().astype(np.int64)
