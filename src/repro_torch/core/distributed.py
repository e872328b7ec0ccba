"""The summarizer's multi-device path on `torch.distributed` (the JAX
package's `core/distributed.py`).

The O(|E|) scans (hashing, segment-min shingles) and the O(k²) in-group
intersection counts are sharded over a mesh's data axis; the small,
inherently sequential merge decisions run on every rank's host alike.
Execution is SPMD (`launch/mesh.py`): every rank runs the same host
program, holds its own shard on its own device, and the collectives go
through the data axis' process group, in the same order on every rank.

`shingle_provider` and `batched_intersections_mesh` are the engine's hooks:
`SummarizerEngine` plugs them into its shingle stage and its batched
ranking whenever it runs under a mesh.

Each sharded function exposes its per-rank body beside the collective
wrapper — `shingles_local` on a rank's edge block, `intersections_rank`
on a rank's batch rows — so the shards of one input can also run in turn
on one device and be held to the unsharded result.

Engines:
  * ``shingles_sharded``     — edge-sharded min-hash shingles (MIN all-reduce)
  * ``shingle_provider``     — the engine hook: sharded shingles + host
                               root segment-min + leafless-root sentinel
  * ``batched_intersections_mesh`` — (B, G, W) bitset batches split over the
                               data axis, the CUDA intersection kernel on
                               each rank's rows with its own valid count,
                               the results all-gathered
  * ``greedy_group_matching``— batched greedy matching per group
  * ``summarize_jax``        — hybrid engine: device scoring + host decisions,
                               exactness restored by the emission DP
  * ``summarize_step_fn``    — the candidate-generation step of the dry-run

u32 values live in int64 tensors masked to 32 bits: neither gloo nor the
CPU build of torch does u32 arithmetic, and int64 MIN reductions order
them as u32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import faults
from repro_torch.core.minhash import rootwise_min, u32_seed_consts
from repro_torch.core.pruning import prune
from repro_torch.core.slugger import SluggerState, _emit_encoding
from repro_torch.core.transfer import GLOBAL as TRANSFER
from repro_torch.graphs.csr import Graph
from repro_torch.kernels._build import pow2
from repro_torch.kernels.bitset_fold.carry import M32, hash_u32
from repro_torch.launch.mesh import (all_gather_rows, block, dp_axes_of,
                                     dp_group, dp_size)


def _hash_u32(x: torch.Tensor, a, b) -> torch.Tensor:
    return hash_u32(x, int(a), int(b))


def node_shingles_dense(src, dst, n: int, a, b) -> torch.Tensor:
    """Replicated-reference shingle computation (src/dst = directed edges,
    int64 tensors): ``(n,)`` int64 holding u32 values."""
    h_self = _hash_u32(torch.arange(n, device=src.device), a, b)
    seg = torch.full((n,), M32, dtype=torch.int64, device=src.device)
    seg.scatter_reduce_(0, src.to(torch.int64), _hash_u32(dst, a, b), "amin")
    return torch.minimum(h_self, seg)


def shingles_local(src, dst, n: int, a, b) -> torch.Tensor:
    """The per-rank body of `shingles_sharded`: node shingles over one edge
    shard (padding rows have ``src == n`` and fold into a dummy segment),
    ``(n,)`` int64. The MIN over every shard's result is the dense one."""
    h_self = _hash_u32(torch.arange(n, device=src.device), a, b)
    seg = torch.full((n + 1,), M32, dtype=torch.int64, device=src.device)
    seg.scatter_reduce_(0, src.to(torch.int64), _hash_u32(dst, a, b), "amin")
    return torch.minimum(h_self, seg[:n])


def shingles_sharded(mesh, data_axes=("data",)):
    """Edge-sharded shingles: local segment-min + cross-shard MIN.

    Returns ``fn(src_shard, dst_shard, n, a, b) -> (n,) int64``, where the
    arguments are this rank's block of edge arrays padded with
    ``src == n`` to a multiple of the shard count (`block`)."""
    group = dp_group(mesh, data_axes)

    def fn(src, dst, n, a, b):
        local = shingles_local(src, dst, n, a, b)
        dist.all_reduce(local, dist.ReduceOp.MIN, group=group)
        return local

    return fn


def root_shingles(node_sh: torch.Tensor, root_of: torch.Tensor,
                  n_ids: int) -> torch.Tensor:
    """Segment-min of node shingles over root ids (u32 max where a root
    owns no leaf)."""
    out = torch.full((n_ids,), M32, dtype=torch.int64, device=node_sh.device)
    return out.scatter_reduce_(0, root_of.to(torch.int64), node_sh, "amin")


def _data_axes_of(mesh, data_axes):
    return tuple(data_axes) if data_axes is not None else dp_axes_of(mesh)


def _mesh_device(mesh, device):
    """The rank's device: ``device`` if given, else the mesh's type (the
    current card under NCCL)."""
    if device is not None:
        return torch.device(device)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shingle_provider(g: Graph, mesh, data_axes=None, device=None):
    """Engine hook: mesh-sharded shingle computation.

    Uploads this rank's block of the padded edge list once; returns
    ``for_roots(root_of) -> shingle_fn(sub_seed, n_ids)`` matching the
    `minhash.candidate_groups` provider protocol. Node-level minima come
    from `shingles_sharded` (local segment-min + cross-shard MIN); the
    root-level segment-min and the leafless-root sentinel run on the host
    through the same `rootwise_min` the host path uses. Sentinels are
    ``2^32 + id`` — device hashes are u32, so they can never collide."""
    data_axes = _data_axes_of(mesh, data_axes)
    n_shards = dp_size(mesh, data_axes)
    rank = dist.get_rank(dp_group(mesh, data_axes))
    dev = _mesh_device(mesh, device)
    src = np.repeat(np.arange(g.n), np.diff(g.indptr)).astype(np.int64)
    dst = np.asarray(g.indices, dtype=np.int64)
    pad = (-src.size) % max(n_shards, 1)
    src_p = np.concatenate([src, np.full(pad, g.n, np.int64)])
    dst_p = np.concatenate([dst, np.zeros(pad, np.int64)])
    own = block(src_p.size, rank, n_shards)
    src_d = torch.from_numpy(src_p[own].copy()).to(dev)
    dst_d = torch.from_numpy(dst_p[own].copy()).to(dev)
    sharded = shingles_sharded(mesh, data_axes)

    def for_roots(root_of: np.ndarray):
        root_of = np.asarray(root_of, dtype=np.int64)

        def shingle_fn(sub_seed: int, n_ids: int) -> np.ndarray:
            a, b = u32_seed_consts(sub_seed)
            node_sh = sharded(src_d, dst_d, g.n, a, b).cpu().numpy()
            return rootwise_min(node_sh, root_of, n_ids, 1 << 32)

        return shingle_fn

    return for_roots


def intersections_rank(batch: np.ndarray, B: int, rank: int, world: int,
                       device) -> torch.Tensor:
    """The per-rank body of `batched_intersections_mesh`: the CUDA
    intersection kernel (its plain version on the CPU) on shard ``rank``'s
    rows of the padded ``(Bp, G, Wp)`` uint32 ``batch``, with the shard's
    own valid count — real rows are a contiguous prefix, so shard s of
    size Bs holds ``clip(B − s·Bs, 0, Bs)`` of them and the padding rows
    do no kernel work. Returns ``(Bs, G, G)`` int32 on ``device``."""
    from repro_torch.kernels.bitset_jaccard.kernel import bitset_intersections

    rows = block(batch.shape[0], rank, world)
    Bs = rows.stop - rows.start
    valid = int(np.clip(B - rank * Bs, 0, Bs))
    x = torch.from_numpy(np.ascontiguousarray(batch[rows]).view(np.int32))
    return bitset_intersections(x.to(device), valid)


def batched_intersections_mesh(mesh, data_axes=None, device=None):
    """Engine hook: the bitset intersection dispatch split over the mesh's
    data axis — the ``backend="batched"`` ranking source under a mesh.

    Returns ``fn((B, G, W) uint32) -> (B, G, G) int64``: the batch is
    padded to a pow2 multiple of the shard count, each rank runs the
    kernel on its slice (`intersections_rank`) and the slices are
    all-gathered in rank order. Intersection counts are exact integers, so
    merge decisions are bit-identical to the host ranking given the same
    bitmaps. The fault site ``kernel.bitset_jaccard.intersections`` is
    checked before any collective, so a fault plan fires at the same call
    on every rank. Transfers report the global bytes to
    `core.transfer.GLOBAL`, one ranking round a dispatch, as the
    reference's ledger does."""
    from repro_torch.kernels.bitset_jaccard import ops

    data_axes = _data_axes_of(mesh, data_axes)
    n_shards = dp_size(mesh, data_axes)
    group = dp_group(mesh, data_axes)
    rank = dist.get_rank(group)
    dev = _mesh_device(mesh, device)

    def fn(bits: np.ndarray) -> np.ndarray:
        faults.check("kernel.bitset_jaccard.intersections")
        ops.count_dispatch()
        B, G, W = bits.shape
        Wp = pow2(W)
        Bs = pow2((B + n_shards - 1) // n_shards, floor=1)
        Bp = n_shards * Bs
        batch = np.zeros((Bp, G, Wp), dtype=np.uint32)
        batch[:B, :, :W] = bits
        TRANSFER.add_h2d(batch.nbytes + 4 * n_shards)  # + the valid counts
        local = intersections_rank(batch, B, rank, n_shards, dev)
        inter = local.new_empty((Bp, G, G))
        all_gather_rows(inter, local, group)
        inter = inter.cpu().numpy()
        TRANSFER.add_d2h(inter.nbytes)
        TRANSFER.tick_round()
        return inter[:B].astype(np.int64)

    return fn


# --------------------------------------------------------------------------
# Greedy matching within padded candidate groups
# --------------------------------------------------------------------------
def greedy_group_matching(scores: torch.Tensor, threshold: float,
                          max_merges: int = None) -> torch.Tensor:
    """Greedy maximum-score matching on each group's (K, K) score matrix,
    all groups at once: scores (G, K, K) -> (G, max_merges, 2) int32 pair
    indices, padded with -1. Each step takes the first maximum of the
    row-major flattened matrix (the diagonal excluded) and, if it reaches
    ``threshold``, masks the pair's rows and columns."""
    G, K, _ = scores.shape
    if max_merges is None:
        max_merges = K // 2
    dev = scores.device
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    sc = torch.where(eye, float("-inf"), scores)
    out = torch.full((G, max_merges, 2), -1, dtype=torch.int32, device=dev)
    ar = torch.arange(K, device=dev)
    gi = torch.arange(G, device=dev)
    for i in range(max_merges):
        flat = torch.argmax(sc.reshape(G, K * K), dim=1)
        r, c = flat // K, flat % K
        ok = sc[gi, r, c] >= threshold
        out[:, i] = torch.where(ok[:, None], torch.stack([r, c], 1),
                                -1).to(torch.int32)
        hit = (ar[None, :] == r[:, None]) | (ar[None, :] == c[:, None])
        mask = ok[:, None, None] & (hit[:, :, None] | hit[:, None, :])
        sc = torch.where(mask, float("-inf"), sc)
    return out


def group_jaccard_scores(nbr_onehot: torch.Tensor) -> torch.Tensor:
    """nbr_onehot: (G, K, R) bool neighbor indicators per group member.
    Returns (G, K, K) float32 Jaccard matrices (einsum form)."""
    x = nbr_onehot.to(torch.float32)
    inter = torch.einsum("gkr,glr->gkl", x, x)
    deg = x.sum(-1)
    union = deg[:, :, None] + deg[:, None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                       torch.zeros((), dtype=torch.float32))


# --------------------------------------------------------------------------
# The candidate-generation step of the multi-pod dry-run
# --------------------------------------------------------------------------
def _min_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the elementwise MIN of every rank's ``x`` over
    ``group`` (a reduce-scatter along dim 0)."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),
                       *x.shape[1:]))
    scatter = (getattr(dist, "reduce_scatter_single", None)
               or dist.reduce_scatter_tensor)
    scatter(out, x.contiguous(), op=dist.ReduceOp.MIN, group=group)
    return out


def summarize_step_fn(n_nodes: int, hist: str = "sort", mesh=None,
                      data_axes=None, sharded_out: bool = False):
    """One SLUGGER candidate-generation + scoring step over an edge list:
    shingles → candidate-group-size histogram.

    ``hist``:
      * "sort"    — exact group sizes via `torch.unique` (the reference's
        ``jnp.unique`` with ``size = n`` and fill ``0xFFFFFFFF``: the fill
        pads only the unique values, never an element's count),
      * "scatter" — hash shingles into n/500 buckets and count each bucket
        (O(n) traffic); group sizes become bucket sizes — the cap-at-500
        random split the paper applies anyway.

    ``step(src, dst, root_of, seed) -> (root_sh, counts)``, both ``(n,)``
    int64 (``root_sh`` holding u32 values). Under ``mesh`` each rank passes
    its block of the edges (`shingles_sharded`: a MIN all-reduce over the
    data axes), ``root_of`` whole. With ``sharded_out`` (under a mesh; the
    reference's output shardings over the data axes) the node and root
    shingle tables stay sharded — each a MIN reduce-scatter in place of an
    all-reduce, each rank the segment-min of its block of nodes — and the
    step returns the rank's block of both outputs (``n`` divisible by the
    data size): the histogram then reads the global counts (a SUM
    all-reduce of the buckets, or an all-gather of the root shingles for
    the exact sort). On ``meta`` (the dry run, where no value exists) the
    unique's outputs are bounded at ``n``, as the reference's ``size = n``,
    and its work is the sort it performs."""
    if hist not in ("sort", "scatter"):
        raise ValueError(f"unknown hist {hist!r}; use 'sort' or 'scatter'")
    if sharded_out and mesh is None:
        raise ValueError("sharded_out needs a mesh to shard over")
    group = dp_group(mesh, _data_axes_of(mesh, data_axes)) if sharded_out \
        else None
    shingles = (shingles_local if mesh is None
                else shingles_sharded(mesh, _data_axes_of(mesh, data_axes)))

    def unique_counts(root_sh):
        if root_sh.device.type == "meta":
            _, inv = torch.sort(root_sh)
            return torch.empty_like(inv)[inv]
        _, inv, counts = torch.unique(root_sh, return_inverse=True,
                                      return_counts=True)
        return counts[inv]

    def step(src, dst, root_of, seed):
        s = int(seed) & M32
        a = (2654435761 * (s | 1)) & M32
        b = (s * 0x9E3779B9) & M32
        if sharded_out:
            node_sh = _min_scatter(shingles_local(src, dst, n_nodes, a, b),
                                   group)
            per = node_sh.shape[0]
            lo = dist.get_rank(group) * per
            root_sh = _min_scatter(root_shingles(
                node_sh, root_of[lo:lo + per], n_nodes), group)
        else:
            node_sh = shingles(src, dst, n_nodes, a, b)
            root_sh = root_shingles(node_sh, root_of, n_nodes)
        if hist == "scatter":
            n_buckets = max(n_nodes // 500, 1)
            bucket = _hash_u32(root_sh, a ^ 0xA5A5A5A5, b) % n_buckets
            counts = torch.zeros(n_buckets, dtype=torch.int64,
                                 device=bucket.device).scatter_add_(
                0, bucket, torch.ones_like(bucket))
            if sharded_out:
                dist.all_reduce(counts, group=group)
            return root_sh, counts[bucket]
        if not sharded_out:
            return root_sh, unique_counts(root_sh)
        whole = root_sh.new_empty((n_nodes,))
        all_gather_rows(whole, root_sh, group)
        lo = dist.get_rank(group) * root_sh.shape[0]
        return root_sh, unique_counts(whole)[lo:lo + root_sh.shape[0]]

    return step


# --------------------------------------------------------------------------
# Hybrid engine: device scoring, host decisions, DP emission for exactness
# --------------------------------------------------------------------------
_P = (1 << 61) - 1  # Mersenne prime of the reference's default shingles


def _mersenne_hash(x: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = int(rng.integers(1, _P))
    b = int(rng.integers(0, _P))
    return (a * x.astype(np.int64) + b) % _P


def _default_shingle_fn(g: Graph, root_of: np.ndarray):
    """`candidate_groups`' default shingles in the reference (the Mersenne
    family of its classic path), which `summarize_jax` groups by."""
    def shingle_fn(sub_seed, n_ids):
        h = _mersenne_hash(np.arange(g.n), sub_seed)
        nm = h.copy()
        if g.indices.size:
            src = np.repeat(np.arange(g.n), np.diff(g.indptr))
            np.minimum.at(nm, src, h[g.indices])
        return rootwise_min(nm, root_of, n_ids, _P)
    return shingle_fn


def summarize_jax(
    g: Graph,
    T: int = 20,
    seed: int = 0,
    max_group: int = 128,
    prune_steps=(1, 2, 3),
    min_jaccard: float = 0.05,
    device=None,
):
    """Approximate-selection engine (merge picks by Jaccard matching on
    ``device`` — ``None``: the CUDA card, which must exist — verified by
    host-side Saving ≥ θ). Lossless by construction — the emission DP
    re-encodes the exact input graph. Keeps the reference's name and host
    loop: each group's merges reach the state before the next group's
    workspace is built."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.core.merging import GroupWorkspace, MergePlan, apply_plans
    from repro_torch.core.minhash import candidate_groups

    device = resolve_device(device)

    state = SluggerState(g)
    iter_streams = np.random.SeedSequence((seed, 31337)).spawn(max(T, 1))
    for t in range(1, T + 1):
        theta = 0.0 if t == T else 1.0 / (1 + t)
        groups = candidate_groups(
            g, state.root_of, state.alive, seed=iter_streams[t - 1],
            shingle_fn=_default_shingle_fn(g, state.root_of),
            max_group=max_group)
        for grp in groups:
            plan = MergePlan(grp)
            ws = GroupWorkspace(state, grp, plan)
            k = len(grp)
            onehot = torch.from_numpy(ws.CNT > 0)[None].to(device)
            scores = group_jaccard_scores(onehot)
            pairs = greedy_group_matching(scores, min_jaccard,
                                          max_merges=k // 2)[0].cpu().numpy()
            for r, c in pairs:
                if r < 0:
                    break
                if not (ws.alive[r] and ws.alive[c]):
                    continue
                sav = ws.savings(int(r), np.array([int(c)]))
                if sav[0] >= theta:
                    ws.merge(int(r), int(c))
            apply_plans(state, [plan])
    summary = _emit_encoding(state)
    if prune_steps:
        summary = prune(summary, steps=prune_steps)
    return summary
