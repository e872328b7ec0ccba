"""Device programs that make merge state outlive one iteration (DESIGN.md
§9): the root map, the adjacency bank and the root shingles.

* ``advance_root_map`` — compose one iteration's applied merges ((A, Z, M)
  id triples) into the root map: a forward map collapsed to its fixpoint
  by pointer doubling (16 squarings cover chains of 2^16 merges).
* ``bank_advance`` — advance the adjacency bank by one applied merge
  batch: the device twin of `SluggerState.merge_batch`'s row build.
* ``bank_grow`` — pow2 regrow of the bank's streams, device to device.
* ``bank_extract`` — build one chunk's arena tensors (bitmaps, counts,
  stats, row costs) straight from the bank.
* ``shingle_roots`` — per-root u32 min-hash shingles from the resident
  edges and root map.

All of them are plain PyTorch on the tensors' device, updating the carried
tensors IN PLACE where the JAX package donates its buffers. Scatters never
see an out-of-range index (pads are filtered out first) and never rely on
which duplicate wins; u32 values live in int64 masked to 32 bits, with
every multiply split so no product passes 2^63.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset_fold.rounds import (pair_cost_c, poss_pair_c,
                                                    poss_self_c)

M32 = 0xFFFFFFFF
INT32_INF = (1 << 31) - 1


# ------------------------------------------------------------------ shingles
def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x·c) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant c < 2^32,
    from 16-bit halves: x·c = xl·c + (xh·c mod 2^16)·2^16 (mod 2^32), and
    no partial product reaches 2^49."""
    c = int(c) & M32
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * (c & 0xFFFF)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def hash_u32(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """The unified u32 mix of the shingle family (`core/minhash.hash_u32`),
    on int64 tensors holding u32 values."""
    h = (mul_u32(x.to(torch.int64) & M32, a) + (int(b) & M32)) & M32
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x7FEB352D)
    return h ^ (h >> 15)


def shingle_roots(src, dst, res_map, n: int, a: int, b: int,
                  n_ids: int) -> torch.Tensor:
    """(n_ids,) int64 root shingles: node shingle = min(h(u), min over
    neighbours h(w)); root shingle = min over the root's leaves; a root
    owning no leaf takes the sentinel 2^32 + id (outside the hash range)."""
    dev = src.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    node = torch.full((n,), M32, dtype=torch.int64, device=dev)
    node.scatter_reduce_(0, src, hash_u32(dst, a, b), "amin",
                         include_self=True)
    node = torch.minimum(node, hash_u32(ids, a, b))
    roots = res_map[:n].to(torch.int64)
    cap = res_map.shape[0]
    sh = torch.full((cap,), M32, dtype=torch.int64, device=dev)
    leaves = torch.zeros(cap, dtype=torch.int64, device=dev)
    sh.scatter_reduce_(0, roots, node, "amin", include_self=True)
    leaves.index_add_(0, roots, torch.ones_like(roots))
    sentinel = (1 << 32) + torch.arange(cap, dtype=torch.int64, device=dev)
    return torch.where(leaves > 0, sh, sentinel)[:n_ids]


# ------------------------------------------------------------------ root map
def advance_root_map(res_map: torch.Tensor, A, Z, M) -> None:
    """Compose the merges ``A → M``, ``Z → M`` (all ``(m,)`` int64 on the
    device, in application order) into ``res_map`` in place."""
    fwd = torch.arange(res_map.shape[0], dtype=res_map.dtype,
                       device=res_map.device)
    fwd[A] = M.to(fwd.dtype)
    fwd[Z] = M.to(fwd.dtype)
    for _ in range(16):  # pointer doubling to the fixpoint
        fwd = fwd[fwd.to(torch.int64)]
    res_map.copy_(fwd[res_map.to(torch.int64)])


# ---------------------------------------------------------------------- bank
def bank_grow(gids: torch.Tensor, cnts: torch.Tensor, new_e: int):
    """Streams regrown to ``new_e`` entries; zero tails are inert."""
    g = torch.zeros(new_e, dtype=gids.dtype, device=gids.device)
    c = torch.zeros(new_e, dtype=cnts.dtype, device=cnts.device)
    g[: gids.shape[0]] = gids
    c[: cnts.shape[0]] = cnts
    return g, c


def bank_advance(bank: dict, res_map: torch.Tensor, slab: torch.Tensor,
                 total: int) -> None:
    """Advance the adjacency bank by ONE applied merge batch, in place.

    ``bank`` holds the (E,) int32 ``gids``/``cnts`` streams and the (cap,)
    int32 ``size``/``selfc``/``nd``/``hgt`` stats; ``res_map`` is the
    pre-batch root map; ``slab`` the (8, m) int64 instruction
    ``[A, Z, M, out_ptr, a_ptr, a_len, z_ptr, z_len]`` of the batch's m
    pairs, and ``total`` = Σ(a_len + z_len) (the host knows it).

    Both parents' bank rows are gathered and every gid resolved through
    the PRE-batch root map (the host's `resolve` at gather time); entries
    internal to the pair are dropped (their count sum, halved, is ``cab``);
    duplicate roots coalesce (two stable sorts + segment heads — the host's
    keyed argsort + reduceat), and each pair's unique external entries are
    appended at ``out_ptr`` in ascending root order. Then the minted
    parents' stats are set and ``res_map`` composes A, Z → M.
    """
    gids, cnts = bank["gids"], bank["cnts"]
    dev = gids.device
    A, Z, M, outp, aptr, alen, zptr, zlen = slab
    m = A.shape[0]
    ub = alen + zlen
    start = torch.cumsum(ub, 0) - ub
    pair = torch.repeat_interleave(torch.arange(m, device=dev), ub,
                                   output_size=total)
    w = torch.arange(total, device=dev) - start[pair]
    from_z = w >= alen[pair]
    idx = torch.where(from_z, zptr[pair] + (w - alen[pair]), aptr[pair] + w)
    e_cnt = cnts[idx]
    rg = res_map[gids[idx].to(torch.int64)].to(torch.int64)
    internal = (rg == A[pair]) | (rg == Z[pair])
    # A→Z and Z→A are both stored: the exact host halving of `cab`
    cab = torch.zeros(m, dtype=torch.int32, device=dev)
    cab.index_add_(0, pair, torch.where(internal, e_cnt, 0))
    cab = torch.div(cab, 2, rounding_mode="floor")
    keep = ~internal
    sp, srg, sc = pair[keep], rg[keep], e_cnt[keep]
    # kept entries grouped by pair, ascending root within a pair
    o = torch.sort(srg, stable=True).indices
    o = o[torch.sort(sp[o], stable=True).indices]
    sp, srg, sc = sp[o], srg[o], sc[o]
    head = torch.ones_like(sp, dtype=torch.bool)
    head[1:] = (sp[1:] != sp[:-1]) | (srg[1:] != srg[:-1])
    rank = torch.cumsum(head.to(torch.int64), 0) - 1
    n_unique = int(head.sum())
    csum = torch.zeros(n_unique, dtype=cnts.dtype, device=dev)
    csum.index_add_(0, rank, sc)
    hp, hr = sp[head], srg[head]
    first = torch.full((m,), INT32_INF, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, hp, rank[head], "amin", include_self=True)
    tgt = outp[hp] + (torch.arange(n_unique, device=dev) - first[hp])
    gids[tgt] = hr.to(gids.dtype)
    cnts[tgt] = csum
    # minted parents' stats; then ids rooted at A or Z root at M
    size, selfc, nd, hgt = bank["size"], bank["selfc"], bank["nd"], bank["hgt"]
    size[M] = size[A] + size[Z]
    selfc[M] = selfc[A] + selfc[Z] + cab
    nd[M] = nd[A] + nd[Z] + 2
    hgt[M] = torch.maximum(hgt[A], hgt[Z]) + 1
    upd = torch.arange(res_map.shape[0], dtype=res_map.dtype, device=dev)
    upd[A] = M.to(upd.dtype)
    upd[Z] = M.to(upd.dtype)
    res_map.copy_(upd[res_map.to(torch.int64)])


def bank_extract(bank: dict, res_map: torch.Tensor, members: torch.Tensor,
                 ptr: torch.Tensor, lens: torch.Tensor, total: int, R: int,
                 Rp: int, Wp: int) -> dict:
    """Build one chunk's resident arena tensors from the bank.

    ``members``/``ptr``/``lens`` are ``(B, G)`` int64 on the device: the
    member roots (pad −1) and their bank row extents; ``total`` =
    Σ lens; ``R`` the host's column-universe width of the chunk. A group's
    column universe is the sorted union of its members and their entries'
    CURRENT roots (``res_map`` resolution — the host's `resolve` at gather
    time); duplicate roots coalesce by integer addition, so every tensor is
    bit-identical to a host `_fill` of the same chunk. Row costs use the
    clamped integer terms in int32: the bank's conservation guard keeps
    every count and cost below C_CLAMP. Returns the state dict of
    `ResidentBitmapArena`.
    """
    gids, cnts = bank["gids"], bank["cnts"]
    dev = gids.device
    i32 = torch.int32
    B, G = members.shape
    cap = res_map.shape[0]
    valid = members >= 0
    mem_c = torch.where(valid, members, 0)
    # flat entry stream: (group, row, bank index) of every live entry
    rowid = torch.repeat_interleave(
        torch.arange(B * G, device=dev), lens.reshape(-1), output_size=total)
    lens_f = lens.reshape(-1)
    start = torch.cumsum(lens_f, 0) - lens_f
    idx = ptr.reshape(-1)[rowid] + (torch.arange(total, device=dev)
                                    - start[rowid])
    e_cnt = cnts[idx]
    e_root = res_map[gids[idx].to(torch.int64)].to(torch.int64)
    e_b = torch.div(rowid, G, rounding_mode="floor")
    e_r = rowid - e_b * G
    # per-group sorted universes: segments of the sorted (group, id) keys
    mb = torch.arange(B, device=dev)[:, None].expand(B, G)[valid]
    key = torch.cat([mb * (cap + 1) + members[valid],
                     e_b * (cap + 1) + e_root])
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    col_b = torch.div(uniq, cap + 1, rounding_mode="floor")
    col_gid = uniq - col_b * (cap + 1)
    first = torch.searchsorted(col_b, torch.arange(B, device=dev))
    pos = torch.arange(uniq.shape[0], device=dev) - first[col_b]
    if uniq.numel() and int(pos.max()) >= R:
        raise RuntimeError("bank extraction disagrees with the host's column "
                           f"universe: width {int(pos.max()) + 1} > {R}")
    n_mem = int(mb.shape[0])
    memcol = torch.zeros((B, G), dtype=i32, device=dev)
    memcol[valid] = pos[inv[:n_mem]].to(i32)
    ec = pos[inv[n_mem:]]
    CNT = torch.zeros((B, G, Rp), dtype=i32, device=dev)
    CNT.index_put_((e_b, e_r, ec), e_cnt, accumulate=True)
    colsize = torch.zeros((B, Rp), dtype=i32, device=dev)
    colsize[col_b, pos] = bank["size"][col_gid]
    stats = {k: torch.where(valid, bank[k][mem_c], 0)
             for k in ("size", "selfc", "nd", "hgt")}
    s_g = stats["size"]
    # packed bitmaps: column c is bit c & 31 of word c >> 5 (the uint32 view
    # of the host's little-endian uint64 words)
    pres = torch.zeros((B, G, Wp * 32), dtype=torch.int64, device=dev)
    pres[:, :, :Rp] = (CNT > 0).to(torch.int64)
    weights = torch.tensor([1 << k for k in range(32)], dtype=torch.int64,
                           device=dev)
    words = (pres.view(B, G, Wp, 32) * weights).sum(dim=3)
    bits = torch.where(words >= (1 << 31), words - (1 << 32), words).to(i32)
    cost = pair_cost_c(CNT, poss_pair_c(s_g[:, :, None],
                                        colsize[:, None, :])).sum(dim=2,
                                                                  dtype=i32)
    cost = cost + pair_cost_c(stats["selfc"], poss_self_c(s_g)) + stats["nd"]
    alive = valid.to(torch.int8)
    return {"bits": bits, "alive": alive, "dirty": alive.clone(), "CNT": CNT,
            "colsize": colsize, "memcol": memcol, "s": s_g,
            "selfc": stats["selfc"], "nd": stats["nd"], "hgt": stats["hgt"],
            "cost": torch.where(valid, cost, 0)}
