"""Attention variants, as in the JAX package's `models/attention.py`:
grouped-query attention (optionally sliding-window, optionally biased),
MLA (DeepSeek-V2's latent attention) and cross-attention, each with a
full-sequence path (prefill) and a single-token decode path over a cache.

The prefill attends through `_attn_dispatch`: the hand-written CUDA flash
kernel (`kernels/flash_attn`, ``attn_impl="pallas_flash"``, the default)
or the plain PyTorch `chunked_sdpa` twin (``"xla_chunked"``). MLA's
prefill is the kernel at q/k width 192 and v width 128. Self-attention
decodes with the plain `_sdpa` (MLA's absorbed decode in the latent
space), as the reference does; cross-attention attends through
`_attn_dispatch` in decode too, non-causal, one query row over the
encoder's keys.

Under a model axis (slice E6a) each rank attends its heads
(`sharding.heads`: its block where the axis divides them, else all) on
its column blocks of the projections, gathering a projection's output
where its block cuts through a head (`sharding.take`); ``wo`` is a row
block summed over the axis (`sharding.rows`). A cache whose time the
model or data axis spreads (`sharding.cache_pspecs`) is attended by
every query head its block holds, the softmax statistics combined
across the ranks (`_combine`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import sharding as SH
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -1e30


def _sdpa(q, k, v, mask):
    """q: (b,sq,hkv,g,hd); k/v: (b,sk,hkv,hd); mask: (b|1, sq, sk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", w, v)


def _causal_mask(sq, sk, q_offset, window, device=None):
    pos_q = q_offset + torch.arange(sq, device=device)[:, None]
    pos_k = torch.arange(sk, device=device)[None, :]
    m = pos_k <= pos_q
    if window:
        m &= pos_k > pos_q - window
    return m[None]  # (1, sq, sk)


def chunked_sdpa(q, k, v, *, causal: bool, window: int = 0,
                 chunk: int = 1024):
    """Blocked attention in plain PyTorch (the flash kernel's twin): a loop
    over q chunks × a loop over exactly the kv chunks each q chunk can see,
    with an online-softmax (m, l, acc) carry, so the peak temporary is one
    (b, hkv, g, chunk, chunk) score block.

    q: (b, sq, hkv, g, hd); k: (b, sk, hkv, hd); v: (b, sk, hkv, vd).
    Returns (b, sq, hkv, g, vd). One-shot `_sdpa` when the problem fits
    in a single block or the shapes do not divide.
    """
    b, sq, hkv, g, hd = q.shape
    sk, vd = k.shape[1], v.shape[-1]
    cq, ck = min(chunk, sq), min(chunk, sk)
    if (sq <= chunk and sk <= chunk) or sq % cq or sk % ck:
        mask = (_causal_mask(sq, sk, 0, window, q.device) if causal
                else torch.ones((1, sq, sk), dtype=torch.bool,
                                device=q.device))
        return _sdpa(q, k, v, mask)
    nq, nk = sq // cq, sk // ck
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(nq):
        qi = q[:, i * cq:(i + 1) * cq]
        if causal:
            lo = max(0, (i * cq - window) // ck) if window else 0
            hi = i + 1 if cq == ck else min(nk, ((i + 1) * cq + ck - 1) // ck)
        else:
            lo, hi = 0, nk
        acc = torch.zeros((b, hkv, g, cq, vd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, hkv, g, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, cq), dtype=torch.float32, device=q.device)
        for j in range(lo, hi):
            kc = k[:, j * ck:(j + 1) * ck]
            vc = v[:, j * ck:(j + 1) * ck]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, kc).float() * scale
            if causal:
                qpos = i * cq + torch.arange(cq, device=q.device)
                kpos = j * ck + torch.arange(ck, device=q.device)
                msk = kpos[None, :] <= qpos[:, None]
                if window:
                    msk = msk & (kpos[None, :] > qpos[:, None] - window)
                s = torch.where(msk[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if causal:
                p = torch.where(msk[None, None, None], p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vc.dtype), vc).float()
            m = m_new
        oi = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        outs.append(oi.permute(0, 3, 1, 2, 4))  # (b,cq,hkv,g,vd)
    return torch.cat(outs, dim=1)


def _attn_dispatch(cfg, q, k, v, *, causal, window):
    """``attn_impl`` selection: the CUDA flash kernel (its plain version on
    the CPU) or the plain chunked twin."""
    if cfg.attn_impl == "pallas_flash":
        bq = bk = min(512, q.shape[1], k.shape[1])
        return flash_attention(q, k, v, causal=causal, window=window,
                               bq=bq, bk=bk)
    if cfg.attn_impl == "xla_chunked":
        return chunked_sdpa(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; use "
                     f"'pallas_flash' or 'xla_chunked'")


def _attend(q, k, v, valid, axis):
    """Attention of q (b, sq, nkv, g, hd) over this rank's time block of
    k, v (b, S_l, nkv, ·) under ``valid`` ((b|1, S_l) in global slots).
    Where ``axis`` (an `Axis` of `models.sharding`) spreads the time over
    its ranks, the softmax statistics are combined over it (`_combine`);
    on one rank this is `_sdpa`. Returns (b, sq, nkv, g, vd)."""
    b, sq = q.shape[:2]
    if axis.size == 1:
        return _sdpa(q, k, v, valid[:, None, :].expand(b, sq, k.shape[1]))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    o = _combine(s, valid[:, None, None, None, :], axis,
                 lambda e: torch.einsum("bkgqs,bskd->bkgqd", e, v.float()))
    return o.to(v.dtype).permute(0, 3, 1, 2, 4)


def _combine(s, valid, axis, weigh):
    """The softmax over slots that ``axis`` spreads over its ranks: the
    row max by a MAX all-reduce, then the rescaled weighted values and row
    sums by one SUM all-reduce. ``s``: f32 scores of this rank's slots
    (last dim); ``weigh(e)``: Σ e·v over them, f32. Ranks whose slots are
    all masked add zeros."""
    s = torch.where(valid, s, NEG_INF)
    m = axis.max(s.amax(dim=-1, keepdim=True))
    e = torch.where(valid, torch.exp(s - m), 0.0)
    o, l = axis.sum_all(weigh(e), e.sum(dim=-1, keepdim=True))
    return o / l


def _time_block(cache_leaf, axis):
    """(S, t0): a time-sharded cache's global slot count and the first
    global slot of this rank's block."""
    S_l = cache_leaf.shape[1]
    return S_l * axis.size, (axis.rank * S_l if axis.size > 1 else 0)


def _slots(S_l: int, t0: int, device):
    """The global slot indices ``t0 … t0 + S_l − 1`` of a time block."""
    return torch.arange(t0, t0 + S_l, device=device)


def _write(cache, new, slot, t0):
    """Write ``new`` {name: (b, 1, …)} at global ring slot ``slot`` of the
    cache blocks, where this rank's time block (from ``t0``) holds it."""
    S_l = next(iter(cache.values())).shape[1]
    if t0 <= slot < t0 + S_l:
        for name, t in new.items():
            cache[name][:, slot - t0:slot - t0 + 1] = t


def gqa_param_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_gqa``'s tree, each shape behind ``lead`` (the layer axis)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": (*lead, d, hq), "wk": (*lead, d, hkv), "wv": (*lead, d, hkv),
         "wo": (*lead, hq, d)}
    if cfg.qkv_bias:
        p.update(bq=(*lead, hq), bk=(*lead, hkv), bv=(*lead, hkv))
    return p


def _proj(x, w, b, n):
    """``x @ w`` for a weight whose ``n`` output columns sit on the model
    axis (``w`` the rank's column block), plus the rank's slice of the
    replicated bias ``b``."""
    y = x @ w
    if b is None:
        return y
    return y + (b[SH.col_block(n)] if SH.split(n) else b)


def _project_qkv(p, cfg, x):
    """Flat queries of the rank's heads (`sharding.heads`) and keys and
    values of the cache's kv heads: the rank's block where the model axis
    divides the kv heads, else all of them (gathered where the column
    block cuts through a head)."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    h0, h1 = SH.heads(H)
    c0, c1 = SH.heads(Hkv)
    q = SH.take(_proj(x, p["wq"], p.get("bq"), H * hd), H * hd, h0 * hd,
                h1 * hd)
    k = SH.take(_proj(x, p["wk"], p.get("bk"), Hkv * hd), Hkv * hd, c0 * hd,
                c1 * hd)
    v = SH.take(_proj(x, p["wv"], p.get("bv"), Hkv * hd), Hkv * hd, c0 * hd,
                c1 * hd)
    return q, k, v


def _group(q, k, v, a0, c0, G):
    """q (b, s, Ha, hd) of query heads ``a0``… and k, v (b, S, Hc, ·) of
    kv heads ``c0``… as `_attn_dispatch` takes them: ((b, s, nkv, g, hd),
    k, v of the nkv kv heads the queries read) — whole groups, or all in
    one kv head; queries that straddle groups unevenly get k and v
    repeated a query head."""
    b, s, Ha, hd = q.shape
    k0, k1 = a0 // G, (a0 + Ha - 1) // G + 1
    if (a0 % G == 0 and Ha % G == 0) or k1 - k0 == 1:
        nkv = k1 - k0
        if k0 != c0 or nkv != k.shape[2]:
            k, v = k[:, :, k0 - c0:k1 - c0], v[:, :, k0 - c0:k1 - c0]
        return q.reshape(b, s, nkv, Ha // nkv, hd), k, v
    idx = torch.arange(a0, a0 + Ha, device=q.device) // G - c0
    return q.reshape(b, s, Ha, 1, hd), k[:, :, idx], v[:, :, idx]


def gqa_full(p, cfg: ModelConfig, x, positions, causal=True):
    """Full-sequence attention on the rank's heads (all of them on one
    device). Returns (out, cache): ``out`` summed over the model axis
    (``wo`` is a row block), the cache's post-rope k and v (the rank's
    kv heads where the model axis divides them, else all)."""
    b, s, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    h0, _ = SH.heads(H)
    c0, _ = SH.heads(Hkv)
    q, k, v = _project_qkv(p, cfg, x)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if causal:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    qg, ka, va = _group(q, k, v, h0, c0, H // Hkv)
    out = _attn_dispatch(cfg, qg, ka, va, causal=causal,
                         window=cfg.sliding_window if causal else 0)
    out = SH.rows(out.reshape(b, s, -1), p["wo"], H * hd, h0 * hd)
    return out, {"k": k, "v": v}


def _gather_heads(t, n_heads, axis):
    """(b, s, Hl, w) of this rank's heads as all ``n_heads`` heads, where
    ``axis`` is the model axis spreading the time of a cache that holds
    every head; else ``t`` as it is. Returns (t, first head)."""
    if axis.size == 1 or axis is not SH.model_axis():
        return t, SH.heads(n_heads)[0]
    b, s, hl, w = t.shape
    if hl == n_heads:
        return t, 0
    return SH.take(t.reshape(b, s, hl * w), n_heads * w, 0,
                   n_heads * w).reshape(b, s, n_heads, w), 0


def gqa_decode(p, cfg: ModelConfig, x, cache, pos: int):
    """x: (b,1,d); cache k/v: the rank's block of (b,S,hkv,hd); pos:
    position of the new token. Writes k and v at ring slot ``pos % S``
    IN PLACE (the reference returns an updated copy; the port saves the
    copy) and attends over the slots written so far — every slot once the
    ring is full. Under a cache whose time the model or data axis spreads
    (`sharding.cache_pspecs`), the rank owning the slot writes it, the
    query heads the block holds attend over the rank's slots, and the
    softmax statistics are combined across the ranks (`_combine`)."""
    b = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    t_ax = SH.time_axis(SH.cache_spec("attn", "k"))
    S, t0 = _time_block(cache["k"], t_ax)
    pos = int(pos)
    q, k, v = _project_qkv(p, cfg, x)
    q = q.reshape(b, 1, -1, hd)
    k = k.reshape(b, 1, -1, hd)
    v = v.reshape(b, 1, -1, hd)
    posa = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posa, cfg.rope_theta)
    k = apply_rope(k, posa, cfg.rope_theta)
    slot = pos % S
    _write(cache, {"k": k, "v": v}, slot, t0)
    q, a0 = _gather_heads(q, H, t_ax)
    qg, kc, vc = _group(q, cache["k"], cache["v"], a0, SH.heads(Hkv)[0],
                        H // Hkv)
    idx = _slots(cache["k"].shape[1], t0, x.device)[None, :]
    valid = (idx <= slot) | (pos >= S)
    out = _attend(qg, kc, vc, valid, t_ax).reshape(b, 1, -1)
    return SH.rows(out, p["wo"], H * hd, a0 * hd), cache


# --------------------------------------------------------------------- MLA
def mla_param_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_mla``'s tree, each shape behind ``lead`` (the layer axis)."""
    d, h, m = cfg.d_model, cfg.n_heads, cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {"wq": (*lead, d, h * qk),
            "wkv_a": (*lead, d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm": (*lead, m.kv_lora_rank),
            "wkv_b": (*lead, m.kv_lora_rank,
                      h * (m.qk_nope_head_dim + m.v_head_dim)),
            "wo": (*lead, h * m.v_head_dim, d)}


def _mla_wkv_b(p, cfg, a0, a1):
    """``wkv_b``'s columns of heads ``[a0, a1)``: the rank's block, or
    gathered where it does not hold them."""
    m = cfg.mla
    w = m.qk_nope_head_dim + m.v_head_dim
    return SH.take(p["wkv_b"], cfg.n_heads * w, a0 * w, a1 * w)


def _mla_expand(p, cfg, ckv, a0, a1):
    """Latent (b,S,r) -> heads ``[a0, a1)``'s k_nope (b,S,·,nope) and v
    (b,S,·,vd): views of one (b,S,·,nope+vd) expansion."""
    m = cfg.mla
    kv = (ckv @ _mla_wkv_b(p, cfg, a0, a1)).view(
        *ckv.shape[:2], a1 - a0, m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def _mla_project(p, cfg, x, positions):
    """Queries of the rank's heads (b,s,hl,nope+rope) with rope applied
    to their last rope dims, the normalised latent ckv (b,s,r) and the
    roped shared key part k_rope (b,s,rd) — the latent whole on every
    rank (``wkv_a``'s output gathered where its columns are split)."""
    b, s, _ = x.shape
    m, H = cfg.mla, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    h0, h1 = SH.heads(H)
    q = SH.take(x @ p["wq"], H * qk, h0 * qk, h1 * qk).reshape(b, s, h1 - h0,
                                                              qk)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ra = m.kv_lora_rank + m.qk_rope_head_dim
    ca = SH.take(x @ p["wkv_a"], ra, 0, ra)
    ckv, k_rope = ca[..., :m.kv_lora_rank], ca[..., m.kv_lora_rank:]
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1), ckv, k_rope[:, :, 0, :]


def _mla_keys(p, cfg, ckv, krope, a0, a1):
    """Keys (b,S,·,nope+rope) and values (b,S,·,vd) of heads ``[a0, a1)``
    from the latent cache; v stays a view of the expansion (the kernel
    reads it by strides)."""
    k_nope, v = _mla_expand(p, cfg, ckv, a0, a1)
    rope = krope[:, :, None, :].expand(*k_nope.shape[:3], krope.shape[-1])
    return torch.cat([k_nope, rope], dim=-1), v


def mla_full(p, cfg: ModelConfig, x, positions):
    """Full-sequence MLA on the rank's heads, attended as MHA (hkv = h,
    group 1) through `_attn_dispatch`. Returns (out, {"ckv": (b,s,r),
    "krope": (b,s,rd)}), the latent whole."""
    b, s, _ = x.shape
    m, H = cfg.mla, cfg.n_heads
    h0, h1 = SH.heads(H)
    qh, ckv, krope = _mla_project(p, cfg, x, positions)
    k, v = _mla_keys(p, cfg, ckv, krope, h0, h1)
    out = _attn_dispatch(cfg, qh.view(b, s, h1 - h0, 1, -1), k, v,
                         causal=True, window=0).reshape(b, s, -1)
    out = SH.rows(out, p["wo"], H * m.v_head_dim, h0 * m.v_head_dim)
    return out, {"ckv": ckv, "krope": krope}


def _mla_step(p, cfg, x, cache, pos: int, t_ax):
    """The new token's queries, written into the latent cache IN PLACE at
    global slot ``pos % S`` by the rank whose time block holds it;
    returns (qh, slot, first global slot of the block)."""
    b = x.shape[0]
    S, t0 = _time_block(cache["ckv"], t_ax)
    posa = torch.full((b, 1), pos, device=x.device)
    qh, ckv_new, krope_new = _mla_project(p, cfg, x, posa)
    slot = pos % S
    _write(cache, {"ckv": ckv_new, "krope": krope_new}, slot, t0)
    return qh, slot, t0


def mla_decode(p, cfg: ModelConfig, x, cache, pos: int):
    """The reference's baseline decode: the latent cache expanded to
    per-head keys and values every step. x: (b,1,d); cache ckv (b,S,r),
    krope (b,S,rd) (the rank's time blocks), updated IN PLACE at slot
    ``pos % S``. The mask is ``arange(S) <= pos % S`` as the reference
    writes it: unlike `gqa_decode` it has no ``pos >= S`` term (ROADMAP
    Queue 3). Under a time-sharded cache every head's query attends over
    the rank's slots (``wkv_b`` gathered where the model axis spreads the
    time) and the statistics are combined."""
    b = x.shape[0]
    m, H = cfg.mla, cfg.n_heads
    t_ax = SH.time_axis(SH.cache_spec("attn", "ckv"))
    pos = int(pos)
    qh, slot, t0 = _mla_step(p, cfg, x, cache, pos, t_ax)
    qh, a0 = _gather_heads(qh, H, t_ax)
    ha = qh.shape[2]
    k, v = _mla_keys(p, cfg, cache["ckv"], cache["krope"], a0, a0 + ha)
    S_l = cache["ckv"].shape[1]
    valid = _slots(S_l, t0, x.device)[None, :] <= slot
    out = _attend(qh.reshape(b, 1, ha, 1, -1), k, v, valid, t_ax)
    return SH.rows(out.reshape(b, 1, -1), p["wo"], H * m.v_head_dim,
                   a0 * m.v_head_dim), cache


def mla_decode_absorbed(p, cfg: ModelConfig, x, cache, pos: int):
    """Decode with ``wkv_b`` absorbed into the query and output sides, so
    attention runs in the latent space (no per-step expansion of the
    cache): O(S·h·r) instead of O(S·h·(nope+vd)·r). Same cache update and
    mask as `mla_decode`. Under a time-sharded cache the absorbed queries
    of every head are gathered, attend over the rank's slots, and the
    latent contexts are combined; the rank keeps its heads for ``wv``
    and ``wo``."""
    b = x.shape[0]
    m, H = cfg.mla, cfg.n_heads
    r, nope = m.kv_lora_rank, m.qk_nope_head_dim
    t_ax = SH.time_axis(SH.cache_spec("attn", "ckv"))
    pos = int(pos)
    qh, slot, t0 = _mla_step(p, cfg, x, cache, pos, t_ax)
    h0, h1 = SH.heads(H)
    q_nope, q_rope = qh[..., :nope], qh[..., nope:]
    wkv_b = _mla_wkv_b(p, cfg, h0, h1).reshape(r, h1 - h0,
                                               nope + m.v_head_dim)
    wk, wv = wkv_b[..., :nope], wkv_b[..., nope:]  # (r,h,nope), (r,h,vd)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wk)
    q_lat, a0 = _gather_heads(q_lat, H, t_ax)
    q_rope, _ = _gather_heads(q_rope, H, t_ax)
    scale = 1.0 / math.sqrt(nope + m.qk_rope_head_dim)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, cache["ckv"])
              + torch.einsum("bqhc,bsc->bhqs", q_rope, cache["krope"])
              ).float() * scale
    S_l = cache["ckv"].shape[1]
    valid = _slots(S_l, t0, x.device)[None, None, None, :] <= slot
    if t_ax.size == 1:
        scores = torch.where(valid, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", w, cache["ckv"])  # latent ctx
    else:
        ctx = _combine(scores, valid, t_ax, lambda e: torch.einsum(
            "bhqs,bsr->bhqr", e, cache["ckv"].float()))
        ctx = ctx.to(x.dtype).permute(0, 2, 1, 3)
        ctx = ctx[:, :, h0 - a0:h1 - a0]
    out_h = torch.einsum("bqhr,rhv->bqhv", ctx, wv)       # expand once a step
    return SH.rows(out_h.reshape(b, 1, -1), p["wo"], H * m.v_head_dim,
                   h0 * m.v_head_dim), cache


# ------------------------------------------------------------- cross-attn
def cross_param_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_cross``'s tree: n_heads wide on both sides (no GQA)."""
    d, hh = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim
    return {"wq": (*lead, d, hh), "wk": (*lead, d, hh), "wv": (*lead, d, hh),
            "wo": (*lead, hh, d)}


def cross_full(p, cfg: ModelConfig, x, enc_kv, axis=SH.SOLO):
    """x: (b,sq,d); enc_kv: precomputed {"k","v"} (b,se,h,hd) of the
    rank's heads. Attends non-causal through `_attn_dispatch`, in prefill
    and in decode (sq 1); over a cross cache whose time ``axis`` spreads
    (batch 1 over the data axes), by the statistics combine."""
    b, sq, _ = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    h0, h1 = SH.heads(H)
    q = SH.take(x @ p["wq"], H * hd, h0 * hd, h1 * hd).reshape(
        b, sq, h1 - h0, 1, hd)
    if axis.size == 1:
        out = _attn_dispatch(cfg, q, enc_kv["k"], enc_kv["v"], causal=False,
                             window=0)
    else:
        valid = torch.ones((1, enc_kv["k"].shape[1]), dtype=torch.bool,
                           device=x.device)
        out = _attend(q, enc_kv["k"], enc_kv["v"], valid, axis)
    return SH.rows(out.reshape(b, sq, -1), p["wo"], H * hd, h0 * hd)


def cross_precompute(p, cfg: ModelConfig, enc_out):
    """The encoder output's keys and values of the rank's heads,
    (b,se,h,hd) each."""
    b, se, _ = enc_out.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    h0, h1 = SH.heads(H)

    def kv(w):
        return SH.take(enc_out @ w, H * hd, h0 * hd, h1 * hd).reshape(
            b, se, h1 - h0, hd)

    return {"k": kv(p["wk"]), "v": kv(p["wv"])}
