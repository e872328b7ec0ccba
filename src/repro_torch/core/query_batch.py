"""Batched summary queries on the frozen serving artifact.

`Summary.neighbors` (Algorithm 4) answers one query per Python call; the
serving workload is thousands of concurrent `neighbors`/`edge_exists`
queries against an immutable summary (`PackedSummary`). This module answers
whole batches at once, in three phases:

  gather   climb all ancestor chains level-synchronously and gather every
           incident edge's pre-resolved (lo, hi, sign) interval — flat
           segment arrays, one CSR expansion (`segmented_indices`) total.
  sweep    turn intervals into per-query active DFS-position ranges. Three
           interchangeable backends:
             * ``numpy``  — one global event sweep on the host (lexsort +
               cumsum); the per-query signed sums never interact because
               each query's events sum to zero, so a single flat cumsum
               serves the batch. The host oracle.
             * ``torch``  — a fixed-shape sweep over (B, E)-padded rows on
               ``device``: a per-row sort and cumsum in plain PyTorch.
             * ``kernel`` — the `kernels/interval_expand` kernel evaluates
               the signed membership count at every interval boundary
               directly (count at a boundary == the sweep's running sum over
               the range it opens), trading the sort for an O(E·P) compare
               and sum per query; the CUDA kernel on a card, its plain
               version on the CPU.
  expand   shared range-to-leaf expansion on the host: one
           `segmented_indices` gather, drop each query's own position, sort
           per query. Because every backend feeds the same expansion with
           the same ranges, answers are bit-identical across backends and
           identical to `Summary.neighbors` / decompressed rows.

`edge_exists_batch` is the one-probe special case: the signed membership
count of v's DFS position in u's chain intervals, > 0 iff the edge exists.

The ``torch`` and ``kernel`` backends run on ``device``; ``None`` means the
CUDA card, which must exist (`engine.resolve_device`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.summary_ir import PackedSummary, segmented_indices
from repro_torch.kernels._build import pow2

BACKENDS = ("numpy", "torch", "kernel")


def sweep_device(backend: str, device):
    """The device ``backend`` sweeps on: None for the host oracle, else
    ``device`` resolved (``None`` → the CUDA card, which must exist).
    Raises on an unknown backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    if backend == "numpy":
        return None
    from repro_torch.core.engine import resolve_device  # circular-safe

    return resolve_device(device)


# ---------------------------------------------------------------------------
# gather phase (shared by all backends)
# ---------------------------------------------------------------------------
def _gather_chain_intervals(ps: PackedSummary, vs: np.ndarray):
    """Flat (seg, lo, hi, sign) of every edge incident to each query's
    ancestor chain. ``seg`` indexes into ``vs`` and is non-decreasing only
    after explicit sorting — chains are emitted level by level."""
    vs = np.asarray(vs, dtype=np.int64)
    seg = np.arange(vs.size, dtype=np.int64)
    node = vs
    segs, nodes = [seg], [node]
    for _ in range(ps.max_depth):
        node = ps.parent[node].astype(np.int64)
        up = node >= 0
        if not up.any():
            break
        seg, node = seg[up], node[up]
        segs.append(seg)
        nodes.append(node)
    seg_n = np.concatenate(segs)
    nodes = np.concatenate(nodes)
    lens = ps.inc_ptr[nodes + 1] - ps.inc_ptr[nodes]
    idx = segmented_indices(ps.inc_ptr[nodes], lens)
    ent_seg = np.repeat(seg_n, lens)
    return ent_seg, ps.inc_lo[idx], ps.inc_hi[idx], ps.inc_sign[idx]


def _padded_batch(ent_seg, lo, hi, sg, B: int):
    """Scatter the flat per-entry intervals into pow2-padded (Bp, E) int32
    tiles — the shared fixed-shape layout of the torch and kernel backends.
    Padded slots are (0, 0, 0): zero-sign empty intervals that match nothing
    and move no count."""
    cnt = np.bincount(ent_seg, minlength=B)
    E = pow2(int(cnt.max()), floor=8)
    Bp = pow2(B, floor=8)
    order = np.argsort(ent_seg, kind="stable")
    ends = np.cumsum(cnt)
    rank = np.arange(ent_seg.size, dtype=np.int64) - np.repeat(ends - cnt, cnt)
    rows = ent_seg[order]
    out = []
    for col in (lo, hi, sg):
        m = np.zeros((Bp, E), dtype=np.int32)
        m[rows, rank] = col[order]
        out.append(m)
    return (*out, Bp, E)


# ---------------------------------------------------------------------------
# sweep phase: intervals -> active (seg, start, len) ranges
# ---------------------------------------------------------------------------
def _empty_ranges():
    z = np.zeros(0, dtype=np.int64)
    return z, z, z


def _ranges_numpy(ent_seg, lo, hi, sg, B: int, device=None):
    """One flat event sweep over the whole batch. Each interval contributes
    (+s at lo, -s at hi); within a query the running sum over sorted events
    is the membership count of the half-open range a boundary opens. Event
    sums are zero per query, so the global cumsum needs no per-segment
    reset."""
    if ent_seg.size == 0:
        return _empty_ranges()
    pos = np.concatenate([lo, hi])
    val = np.concatenate([sg, -sg])
    seg2 = np.concatenate([ent_seg, ent_seg])
    order = np.lexsort((pos, seg2))
    seg2, pos, val = seg2[order], pos[order], val[order]
    cum = np.cumsum(val)
    tail = np.empty(pos.size, dtype=bool)  # last event of each (seg, pos)
    tail[-1] = True
    tail[:-1] = (seg2[1:] != seg2[:-1]) | (pos[1:] != pos[:-1])
    active = np.flatnonzero(tail & (cum > 0))
    # a query's final boundary always sweeps to zero, so active events have a
    # successor in the same segment and pos[i + 1] is this range's end
    return seg2[active], pos[active], pos[active + 1] - pos[active]


def _ranges_torch(ent_seg, lo, hi, sg, B: int, device=None):
    """Fixed-shape per-row sweep on ``device`` over the pow2-padded (B, E).
    Padded slots are (0, 0, 0) zero-weight events at position 0 — they move
    no count and a boundary is only active when its count is positive."""
    if ent_seg.size == 0:
        return _empty_ranges()
    lo_p, hi_p, sg_p, _, _ = _padded_batch(ent_seg, lo, hi, sg, B)
    l, h, s = (torch.from_numpy(a).to(device) for a in (lo_p, hi_p, sg_p))
    pos, order = torch.sort(torch.cat([l, h], dim=1), dim=1)
    val = torch.gather(torch.cat([s, -s], dim=1), 1, order)
    cum = torch.cumsum(val, dim=1)
    tail = torch.ones_like(pos, dtype=torch.bool)
    tail[:, :-1] = pos[:, 1:] != pos[:, :-1]
    nxt = torch.cat([pos[:, 1:], pos[:, -1:]], dim=1)
    rseg, col = torch.nonzero(tail & (cum > 0), as_tuple=True)
    start = pos[rseg, col].to(torch.int64)
    end = nxt[rseg, col].to(torch.int64)
    rseg, start, end = (t.cpu().numpy() for t in (rseg, start, end))
    return rseg.astype(np.int64), start, end - start


def _ranges_kernel(ent_seg, lo, hi, sg, B: int, device=None):
    """Boundary evaluation through the interval-count kernel: probe every
    (sorted) interval boundary, keep boundaries whose signed membership
    count is positive. No cumsum — the count at a boundary IS the sweep's
    running sum there."""
    from repro_torch.kernels.interval_expand.ops import batch_interval_counts

    if ent_seg.size == 0:
        return _empty_ranges()
    lo_p, hi_p, sg_p, _, _ = _padded_batch(ent_seg, lo, hi, sg, B)
    pos = np.sort(np.concatenate([lo_p, hi_p], axis=1), axis=1)
    cnt = batch_interval_counts(lo_p, hi_p, sg_p, pos, backend="kernel",
                                device=device)
    tail = np.empty(pos.shape, dtype=bool)
    tail[:, -1] = True
    tail[:, :-1] = pos[:, 1:] != pos[:, :-1]
    rseg, col = np.nonzero(tail & (cnt > 0))
    start = pos[rseg, col].astype(np.int64)
    return (rseg.astype(np.int64), start,
            pos[rseg, col + 1].astype(np.int64) - start)


_RANGES = {"numpy": _ranges_numpy, "torch": _ranges_torch,
           "kernel": _ranges_kernel}


# ---------------------------------------------------------------------------
# expand phase (shared) and the public batch queries
# ---------------------------------------------------------------------------
def _expand_ranges(ps: PackedSummary, vs, rseg, rstart, rlen, B: int):
    hits = segmented_indices(rstart, rlen)
    hseg = np.repeat(rseg, rlen)
    keep = hits != ps.pos_of[vs[hseg]]  # each query drops its own position
    hits, hseg = hits[keep], hseg[keep]
    ids = ps.order[hits].astype(np.int64)
    order = np.lexsort((ids, hseg))
    hseg, ids = hseg[order], ids[order]
    indptr = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(np.bincount(hseg, minlength=B), out=indptr[1:])
    return indptr, ids


def neighbors_batch(ps: PackedSummary, vs, backend: str = "numpy",
                    device=None):
    """Batched Algorithm 4: the neighborhood of every query leaf.

    Returns CSR ``(indptr, ids)`` — query i's neighbors are
    ``ids[indptr[i]:indptr[i+1]]``, sorted ascending, bit-identical to
    ``Summary.neighbors(vs[i])``."""
    dev = sweep_device(backend, device)
    vs = np.asarray(vs, dtype=np.int64)
    ent_seg, lo, hi, sg = _gather_chain_intervals(ps, vs)
    rseg, rstart, rlen = _RANGES[backend](ent_seg, lo, hi, sg, vs.size, dev)
    return _expand_ranges(ps, vs, rseg, rstart, rlen, vs.size)


def edge_exists_batch(ps: PackedSummary, us, vs, backend: str = "numpy",
                      device=None):
    """Batched membership probes: does edge (us[i], vs[i]) exist?

    The signed count of v's DFS position over the intervals incident to u's
    ancestor chain is exactly the p-minus-n count of Sect. II-B; the edge
    exists iff it is positive (and u != v)."""
    dev = sweep_device(backend, device)
    us = np.asarray(us, dtype=np.int64)
    vs = np.asarray(vs, dtype=np.int64)
    B = us.size
    ent_seg, lo, hi, sg = _gather_chain_intervals(ps, us)
    pv = ps.pos_of[vs]
    if ent_seg.size == 0:
        return np.zeros(B, dtype=bool)
    if backend == "numpy":
        inside = (lo <= pv[ent_seg]) & (pv[ent_seg] < hi)
        cnt = np.zeros(B, dtype=np.int64)
        np.add.at(cnt, ent_seg[inside], sg[inside])
    else:
        lo_p, hi_p, sg_p, Bp, _ = _padded_batch(ent_seg, lo, hi, sg, B)
        probes = np.full((Bp, 1), -1, dtype=np.int32)
        probes[:B, 0] = pv
        if backend == "kernel":
            from repro_torch.kernels.interval_expand.ops import (
                batch_interval_counts)

            cnt = batch_interval_counts(lo_p, hi_p, sg_p, probes,
                                        backend="kernel", device=dev)[:B, 0]
        else:
            cnt = _torch_probe_counts(lo_p, hi_p, sg_p, probes, dev)[:B, 0]
    return (cnt > 0) & (us != vs)


def _torch_probe_counts(lo_p, hi_p, sg_p, probes, device):
    """The one-probe count as a plain PyTorch reduction on ``device``."""
    l, h, s, p = (torch.from_numpy(a).to(device)
                  for a in (lo_p, hi_p, sg_p, probes))
    inside = (l <= p) & (p < h)
    return (inside * s).sum(dim=1, keepdim=True).cpu().numpy().astype(np.int64)


def unpack_csr(indptr: np.ndarray, ids: np.ndarray) -> list:
    """CSR batch answer -> list of per-query arrays (convenience)."""
    return [ids[indptr[i]: indptr[i + 1]] for i in range(indptr.size - 1)]
