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
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn.ops import flash_attention
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


def gqa_param_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_gqa``'s tree, each shape behind ``lead`` (the layer axis)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": (*lead, d, hq), "wk": (*lead, d, hkv), "wv": (*lead, d, hkv),
         "wo": (*lead, hq, d)}
    if cfg.qkv_bias:
        p.update(bq=(*lead, hq), bk=(*lead, hkv), bv=(*lead, hkv))
    return p


def _project_qkv(p, cfg, x):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def gqa_full(p, cfg: ModelConfig, x, positions, causal=True):
    """Full-sequence attention. Returns (out, cache) with post-rope k and v."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, cfg, x)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if causal:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    out = _attn_dispatch(cfg, qg, k, v, causal=causal,
                         window=cfg.sliding_window if causal else 0)
    out = out.reshape(b, s, hq * hd) @ p["wo"]
    return out, {"k": k, "v": v}


def gqa_decode(p, cfg: ModelConfig, x, cache, pos: int):
    """x: (b,1,d); cache k/v: (b,S,hkv,hd); pos: position of the new token.
    Writes k and v at ring slot ``pos % S`` IN PLACE (the reference returns
    an updated copy; the port saves the copy) and attends over the slots
    written so far — every slot once the ring is full."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    S = cache["k"].shape[1]
    pos = int(pos)
    q, k, v = _project_qkv(p, cfg, x)
    q = q.reshape(b, 1, hq, hd)
    k = k.reshape(b, 1, hkv, hd)
    v = v.reshape(b, 1, hkv, hd)
    posa = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posa, cfg.rope_theta)
    k = apply_rope(k, posa, cfg.rope_theta)
    slot = pos % S
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    qg = q.reshape(b, 1, hkv, hq // hkv, hd)
    idx = torch.arange(S, device=x.device)[None, :]
    valid = (idx <= slot) | (pos >= S)
    mask = valid[:, None, :].expand(b, 1, S)
    out = _sdpa(qg, cache["k"], cache["v"], mask).reshape(b, 1, hq * hd)
    return out @ p["wo"], cache


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


def _mla_expand(p, cfg, ckv):
    """Latent (b,S,r) -> per-head k_nope (b,S,h,nope), v (b,S,h,vd): views
    of one (b,S,h,nope+vd) expansion."""
    m, h = cfg.mla, cfg.n_heads
    kv = (ckv @ p["wkv_b"]).view(*ckv.shape[:2], h,
                                 m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def _mla_project(p, cfg, x, positions):
    """Per-head queries (b,s,h,nope+rope) with rope applied to their last
    rope dims, the normalised latent ckv (b,s,r) and the roped shared key
    part k_rope (b,s,rd)."""
    b, s, _ = x.shape
    m, h = cfg.mla, cfg.n_heads
    q = (x @ p["wq"]).view(b, s, h, -1)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ca = x @ p["wkv_a"]
    ckv, k_rope = ca[..., :m.kv_lora_rank], ca[..., m.kv_lora_rank:]
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1), ckv, k_rope[:, :, 0, :]


def _mla_keys(p, cfg, ckv, krope):
    """Per-head keys (b,S,h,nope+rope) and values (b,S,h,vd) from the
    latent cache; v stays a view of the expansion (the kernel reads it by
    strides)."""
    k_nope, v = _mla_expand(p, cfg, ckv)
    rope = krope[:, :, None, :].expand(*k_nope.shape[:3], krope.shape[-1])
    return torch.cat([k_nope, rope], dim=-1), v


def mla_full(p, cfg: ModelConfig, x, positions):
    """Full-sequence MLA, attended as MHA (hkv = h, group 1) through
    `_attn_dispatch`. Returns (out, {"ckv": (b,s,r), "krope": (b,s,rd)})."""
    b, s, _ = x.shape
    h = cfg.n_heads
    qh, ckv, krope = _mla_project(p, cfg, x, positions)
    k, v = _mla_keys(p, cfg, ckv, krope)
    out = _attn_dispatch(cfg, qh.view(b, s, h, 1, -1), k, v, causal=True,
                         window=0).reshape(b, s, -1)
    return out @ p["wo"], {"ckv": ckv, "krope": krope}


def _mla_step(p, cfg, x, cache, pos: int):
    """The new token's queries, written into the latent cache IN PLACE at
    slot ``pos % S``; returns (qh, slot)."""
    b = x.shape[0]
    S = cache["ckv"].shape[1]
    posa = torch.full((b, 1), pos, device=x.device)
    qh, ckv_new, krope_new = _mla_project(p, cfg, x, posa)
    slot = pos % S
    cache["ckv"][:, slot:slot + 1] = ckv_new
    cache["krope"][:, slot:slot + 1] = krope_new
    return qh, slot


def mla_decode(p, cfg: ModelConfig, x, cache, pos: int):
    """The reference's baseline decode: the whole latent cache expanded to
    per-head keys and values every step. x: (b,1,d); cache ckv (b,S,r),
    krope (b,S,rd), updated IN PLACE at slot ``pos % S``. The mask is
    ``arange(S) <= pos % S`` as the reference writes it: unlike
    `gqa_decode` it has no ``pos >= S`` term (ROADMAP Queue 3)."""
    b = x.shape[0]
    h, S = cfg.n_heads, cache["ckv"].shape[1]
    pos = int(pos)
    qh, slot = _mla_step(p, cfg, x, cache, pos)
    k, v = _mla_keys(p, cfg, cache["ckv"], cache["krope"])
    valid = torch.arange(S, device=x.device)[None, :] <= slot
    mask = valid[:, None, :].expand(b, 1, S)
    out = _sdpa(qh.view(b, 1, h, 1, -1), k, v, mask).reshape(b, 1, -1)
    return out @ p["wo"], cache


def mla_decode_absorbed(p, cfg: ModelConfig, x, cache, pos: int):
    """Decode with ``wkv_b`` absorbed into the query and output sides, so
    attention runs in the latent space (no per-step expansion of the
    cache): O(S·h·r) instead of O(S·h·(nope+vd)·r). Same cache update and
    mask as `mla_decode`."""
    b = x.shape[0]
    m, h = cfg.mla, cfg.n_heads
    S, r = cache["ckv"].shape[1], m.kv_lora_rank
    nope = m.qk_nope_head_dim
    pos = int(pos)
    qh, slot = _mla_step(p, cfg, x, cache, pos)
    q_nope, q_rope = qh[..., :nope], qh[..., nope:]
    wkv_b = p["wkv_b"].view(r, h, nope + m.v_head_dim)
    wk, wv = wkv_b[..., :nope], wkv_b[..., nope:]    # (r,h,nope), (r,h,vd)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wk)
    scale = 1.0 / math.sqrt(nope + m.qk_rope_head_dim)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, cache["ckv"])
              + torch.einsum("bqhc,bsc->bhqs", q_rope, cache["krope"])
              ).float() * scale
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= slot
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, cache["ckv"])   # latent context
    out_h = torch.einsum("bqhr,rhv->bqhv", ctx, wv)       # expand once a step
    return out_h.reshape(b, 1, -1) @ p["wo"], cache


# ------------------------------------------------------------- cross-attn
def cross_param_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_cross``'s tree: n_heads wide on both sides (no GQA)."""
    d, hh = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim
    return {"wq": (*lead, d, hh), "wk": (*lead, d, hh), "wv": (*lead, d, hh),
            "wo": (*lead, hh, d)}


def cross_full(p, cfg: ModelConfig, x, enc_kv):
    """x: (b,sq,d); enc_kv: precomputed {"k","v"} (b,se,h,hd). Attends
    non-causal through `_attn_dispatch`, in prefill and in decode (sq 1)."""
    b, sq, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, sq, h, 1, hd)
    out = _attn_dispatch(cfg, q, enc_kv["k"], enc_kv["v"], causal=False,
                         window=0).reshape(b, sq, h * hd)
    return out @ p["wo"]


def cross_precompute(p, cfg: ModelConfig, enc_out):
    """The encoder output's keys and values, (b,se,h,hd) each."""
    b, se, _ = enc_out.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    return {"k": (enc_out @ p["wk"]).reshape(b, se, h, hd),
            "v": (enc_out @ p["wv"]).reshape(b, se, h, hd)}
