"""Min-hash shingles from a CSR graph through the row-min hash kernel.

`pack_adjacency` lays each node's closed neighborhood N(u) ∪ {u} out in
fixed-width u32 rows (a high-degree node spans several rows, `row_owner`
maps rows back); `node_shingles` takes the row minima of the hash with
`kernel.rowmin_hash` and combines each node's rows with a segment min;
`root_shingles` is the segment min over a root map. The segment mins are
``scatter_reduce("amin")`` on int64 u32 values, with ``0xFFFFFFFF`` (the
u32 maximum) for an empty segment, as `jax.ops.segment_min` gives.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitset_fold.carry import M32
from repro_torch.kernels.minhash.kernel import rowmin_hash
from repro_torch.kernels.minhash.ref import as_u32


def pack_adjacency(indptr: np.ndarray, indices: np.ndarray, width: int = 128):
    """Pack CSR rows into fixed-width uint32 rows.

    High-degree nodes span ceil(deg/width) rows; ``row_owner`` maps each packed
    row back to its node. Includes the node itself (shingles hash N(u) ∪ {u}).
    """
    n = indptr.shape[0] - 1
    deg1 = np.diff(indptr) + 1  # + self
    rows_per = -(-deg1 // width)  # ceil; deg1 >= 1 so always >= 1
    owners = np.repeat(np.arange(n, dtype=np.int64), rows_per)
    R = int(rows_per.sum())
    out = np.full((R, width), np.uint32(0xFFFFFFFF), dtype=np.uint32)
    row0 = np.cumsum(rows_per) - rows_per
    # flat [u | N(u)] value stream + one scatter — no per-node Python loop
    total = int(deg1.sum())
    node_of = np.repeat(np.arange(n, dtype=np.int64), deg1)
    start_v = np.cumsum(deg1) - deg1
    off = np.arange(total, dtype=np.int64) - start_v[node_of]
    vals = np.empty(total, dtype=np.uint32)
    vals[off == 0] = np.arange(n, dtype=np.uint32)
    vals[off > 0] = np.asarray(indices, dtype=np.uint32)
    out[row0[node_of] + off // width, off % width] = vals
    return out, owners


def segment_min_u32(values: torch.Tensor, seg: torch.Tensor,
                    n: int) -> torch.Tensor:
    """``(n,)`` int64 min of int64 u32 ``values`` per segment id ``seg``;
    ``0xFFFFFFFF`` where a segment is empty."""
    out = torch.full((n,), M32, dtype=torch.int64, device=values.device)
    return out.scatter_reduce_(0, seg.to(torch.int64), values, "amin",
                               include_self=True)


def node_shingles(nbr_rows: torch.Tensor, row_owner: torch.Tensor, n: int,
                  a: int, b: int) -> torch.Tensor:
    """Per-node shingle = min hash over N(u) ∪ {u}: ``nbr_rows`` ``(R, W)``
    int32 (the u32 rows of `pack_adjacency`) and ``row_owner`` ``(R,)`` on
    one device → ``(n,)`` int64 u32 values there."""
    mins = as_u32(rowmin_hash(nbr_rows, a, b))
    return segment_min_u32(mins, row_owner.to(nbr_rows.device), n)


def root_shingles(node_sh: torch.Tensor, root_of: torch.Tensor,
                  n_ids: int) -> torch.Tensor:
    """Root shingle = min over member nodes (segment min over root ids)."""
    return segment_min_u32(node_sh, root_of.to(node_sh.device), n_ids)
