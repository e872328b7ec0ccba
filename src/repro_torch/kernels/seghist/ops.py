"""Public dispatch for per-level state membership counts.

`membership_counts` is what the batched emission DP calls once per tree
level: given each active subedge's pair-state id, return the number of
subedges per state (the DP compares these against the interval products to
classify states full/empty/mixed). ``backend="batched"`` pads the ids and
the state count to powers of two (floor 256, the JAX package's padding
contract), ships the ids to ``device`` and runs `kernel.segment_histogram`
there; ``backend="numpy"`` is a plain host ``np.bincount``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._build import pow2
from repro_torch.kernels.seghist.kernel import segment_histogram


def membership_counts(state_of_edge: np.ndarray, num_states: int,
                      backend: str = "numpy", device=None) -> np.ndarray:
    """(E,) int64 state ids -> (num_states,) int64 subedge counts."""
    if num_states == 0:
        return np.zeros(0, dtype=np.int64)
    if backend != "batched":
        return np.bincount(state_of_edge, minlength=num_states).astype(np.int64)
    if device is None:
        raise ValueError("backend='batched' needs the device to count on")
    Ep = pow2(int(state_of_edge.size), floor=256)
    Sp = pow2(int(num_states), floor=256)
    seg = np.full(Ep, -1, dtype=np.int32)
    seg[: state_of_edge.size] = state_of_edge.astype(np.int32)
    counts = segment_histogram(torch.from_numpy(seg).to(device), Sp)
    return counts.cpu().numpy().astype(np.int64)[:num_states]
