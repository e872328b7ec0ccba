"""Packing and the batched intersection dispatch of the merge engine.

`batched_pairwise_intersections` is the merge engine's entry point: a size
bucket of groups arrives as one (B, G, W) uint32 bitmap batch, gets zero-
padded into fixed tiles (`TILE_B` rows, W rounded up to a power of two —
the JAX package's dispatch contract, so both packages ship the same bytes),
and all pairwise intersection popcounts come back from ONE launch of
`kernel.bitset_intersections` per tile. The tile padding is transfer-only:
the kernel receives the valid row count and writes zeros for padding rows.
Per-group degrees are read off the diagonal (popcount(x & x) = |x|). Every
dispatch reports its h2d/d2h bytes and ticks a ranking round on
`core.transfer.GLOBAL`, entry for entry as the JAX package does. The
fault site ``kernel.bitset_jaccard.intersections`` is checked before any
tile goes up, so a failed dispatch leaves the batch untouched and the
merge engine's `HostRankSource` can rank on the host popcount instead.
``DISPATCHES`` counts the dispatches that passed that site, from every
thread (a run's count picks a fault's ``hit`` within it).

`group_jaccard` is the float similarity view of one wide group: all
pairwise intersections from `kernel.pairwise_intersections` (whose diagonal
is each row's popcount), then the Jaccard matrix.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.transfer import GLOBAL as TRANSFER
from repro_torch.kernels._build import pow2
from repro_torch.kernels.bitset_jaccard.kernel import (bitset_intersections,
                                                       pairwise_intersections)

TILE_B = 64  # rows per launch; the JAX package's tile, for ledger parity
DISPATCHES = 0
_COUNT_LOCK = threading.Lock()  # dispatches also run on worker threads


def pack_bitsets(sets: list, universe: int) -> np.ndarray:
    """List of index-iterables -> (G, ceil(universe/32)) uint32 bitmaps."""
    W = (universe + 31) // 32
    out = np.zeros((len(sets), W), dtype=np.uint32)
    for i, s in enumerate(sets):
        idx = np.asarray(list(s), dtype=np.int64)
        if idx.size:
            np.bitwise_or.at(out[i], idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))
    return out


def group_jaccard(bits: np.ndarray, device=None) -> np.ndarray:
    """(G, W) uint32 -> (G, G) float32 Jaccard similarity matrix,
    ``inter / max(union, 1)`` where ``union > 0``, else 0, computed on
    ``device`` (``None``: the CUDA card, which must exist)."""
    from repro_torch.core.engine import resolve_device  # circular-safe

    dev = resolve_device(device)
    words = np.ascontiguousarray(bits, dtype=np.uint32).view(np.int32)
    x = torch.from_numpy(words).to(dev)
    inter = pairwise_intersections(x)
    deg = torch.diagonal(inter)  # popcount(x & x) = |x|
    union = deg[:, None] + deg[None, :] - inter
    jac = torch.where(union > 0, inter / union.clamp(min=1), 0.0)
    return jac.to(torch.float32).cpu().numpy()


def count_dispatch() -> None:
    """Count one rank dispatch that passed its fault site (this one's and
    the mesh dispatch's, `core/distributed.batched_intersections_mesh`)."""
    global DISPATCHES
    with _COUNT_LOCK:
        DISPATCHES += 1


def batched_pairwise_intersections(bits: np.ndarray,
                                   device=None) -> np.ndarray:
    """All-pairs intersection popcounts for a size-bucketed group batch.

    ``bits``: (B, G, W) uint32 bitmaps — one padded group per batch row.
    Returns (B, G, G) int64, computed on ``device`` in fixed `TILE_B`-row
    tiles; tile rows beyond the real batch are masked out inside the
    kernel, so the padding moves bytes but does no kernel work.
    """
    if device is None:
        raise ValueError("the intersection dispatch needs a device")
    faults.check("kernel.bitset_jaccard.intersections")
    count_dispatch()
    B, G, W = bits.shape
    Wp = pow2(W)
    out = np.empty((B, G, G), dtype=np.int64)
    for t0 in range(0, B, TILE_B):
        nb = min(TILE_B, B - t0)
        batch = np.zeros((TILE_B, G, Wp), dtype=np.uint32)
        batch[:nb, :, :W] = bits[t0 : t0 + nb]
        # the valid count rides as a 4-byte kernel argument
        TRANSFER.add_h2d(batch.nbytes + 4)
        inter = bitset_intersections(
            torch.from_numpy(batch.view(np.int32)).to(device), nb)
        inter = inter.cpu().numpy()                 # (TILE_B, G, G) int32
        TRANSFER.add_d2h(inter.nbytes)
        TRANSFER.tick_round()
        out[t0 : t0 + nb] = inter[:nb].astype(np.int64)
    return out
