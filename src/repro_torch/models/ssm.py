"""Mamba2 (SSD, state-space duality) block, as in the JAX package's
`models/ssm.py`: the chunked scan of a prefill and the O(1) single-token
decode (zxbcdt projection, causal depthwise conv, scalar-decay SSD, gated
RMSNorm).

The reference's ``lax.scan`` over chunks is a Python loop here, carrying
the ``(b, nh, hp, ds)`` state in f32; each chunk's matmuls are
`torch.einsum`. There is no hand kernel: the reference computes this in
jnp, not Pallas. `mamba2_decode` updates its cache IN PLACE, as the port's
attention decodes do. Under a model axis (slice E6a) the block runs on the
rank's heads and conv channels (`_project`, `_heads`, `_out`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as SH
from repro_torch.models.layers import rms_norm

# float32 in every model, whatever ``cfg.dtype`` (the reference's init)
F32_PARAMS = ("A_log", "D", "dt_bias")


def dims(cfg: ModelConfig):
    """(d_inner, heads, conv channels, in_proj width)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    zxbcdt = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
    return d_inner, nh, conv_dim, zxbcdt


def param_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_mamba2``'s tree, each shape behind ``lead`` (the layer axis).
    The port's init (`transformer.init_params`) draws ``conv_w`` from
    N(0, 1) times 0.1 and the projections N(0, 1/d_in); ``conv_b`` and
    ``dt_bias`` are 0, ``A_log`` 0 (so A = -1), ``D`` and ``norm_w`` 1."""
    d_inner, nh, conv_dim, zxbcdt = dims(cfg)
    return {"in_proj": (*lead, cfg.d_model, zxbcdt),
            "conv_w": (*lead, conv_dim, cfg.ssm.conv_kernel),
            "conv_b": (*lead, conv_dim),
            "A_log": (*lead, nh), "D": (*lead, nh), "dt_bias": (*lead, nh),
            "norm_w": (*lead, d_inner),
            "out_proj": (*lead, d_inner, cfg.d_model)}


def _causal_conv(x, w, b, state=None):
    """x: (b, s, c); w: (c, K) depthwise causal; state: (b, K-1, c) of
    history. Returns (silu(conv + b), the new (b, K-1, c) history)."""
    K = w.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[:, i] for i in range(K))
    # a copy: a view would keep all of xp alive in the cache
    return F.silu(out + b), xp[:, -(K - 1):, :].clone()


def _split_zxbcdt(cfg, zx):
    d_inner, _, conv_dim, _ = dims(cfg)
    return (zx[..., :d_inner], zx[..., d_inner:d_inner + conv_dim],
            zx[..., d_inner + conv_dim:])


def ssd_chunked(xh, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD scan.
    xh: (b,s,nh,hp); dt: (b,s,nh) (post-softplus, f32); A: (nh,) negative;
    B, C: (b,s,g,ds); head h reads group ``h // (nh // g)``. Returns (y,
    h_last): y (b,s,nh,hp) f32, h_last (b,nh,hp,ds) f32. A sequence that
    chunks do not divide is padded with zero ``dt``, so the padded steps
    neither decay nor feed the state."""
    b, s, nh, hp = xh.shape
    g, ds = B.shape[2], B.shape[3]
    hpg = nh // g
    Q = chunk
    pad = (-s) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    h = (torch.zeros((b, nh, hp, ds), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    ys = []
    for t0 in range(0, xh.shape[1], Q):
        xq, dtq = xh[:, t0:t0 + Q], dt[:, t0:t0 + Q]
        Bq, Cq = B[:, t0:t0 + Q].float(), C[:, t0:t0 + Q].float()
        cum = torch.cumsum(dtq * A, dim=1)                     # (b,Q,nh)
        # intra-chunk decay exp(cum_i - cum_j) for i >= j, 0 above the
        # diagonal, where exp(rel) overflows to inf. The mask goes in
        # before exp: the reference's where(tri, exp(rel), 0) has the same
        # values, but its backward multiplies the masked entries' zero
        # gradient by exp(rel) = inf, and NaN reaches every gradient once
        # a chunk's decay overflows (mamba2-130m at chunk 256)
        rel = cum[:, :, None, :] - cum[:, None, :, :]          # (b,Q,Q,nh)
        L = torch.exp(torch.where(tri[None, :, :, None], rel, -torch.inf))
        G = torch.einsum("bqgn,bkgn->bqkg", Cq, Bq)
        M = G[..., None] * L.reshape(b, Q, Q, g, hpg)
        xdt = (xq.float() * dtq[..., None]).reshape(b, Q, g, hpg, hp)
        y = torch.einsum("bqkgh,bkghp->bqghp", M, xdt)
        # the carried state's contribution
        y_inter = torch.einsum("bqgn,bghpn->bqghp", Cq,
                               h.reshape(b, g, hpg, hp, ds))
        y = y + y_inter * torch.exp(cum).reshape(b, Q, g, hpg)[..., None]
        ys.append(y.reshape(b, Q, nh, hp))
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)         # (b,Q,nh)
        w = xdt * decay_to_end.reshape(b, Q, g, hpg)[..., None]
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + torch.einsum(
            "bkgn,bkghp->bghpn", Bq, w).reshape(b, nh, hp, ds)
    return torch.cat(ys, dim=1)[:, :s], h


def _project(p, cfg, x, conv_state):
    """in_proj, conv and the split: (z, xs, B, C, dt post-softplus in f32,
    A, new conv history), each whole. Under a model axis ``in_proj``'s
    packed output is gathered, the conv runs on the rank's channels (its
    ``conv_w`` block and conv history) and its output is gathered."""
    s_cfg = cfg.ssm
    d_inner, _, conv_dim, zxbcdt = dims(cfg)
    b, s = x.shape[:2]
    zx = SH.take(x @ p["in_proj"], zxbcdt, 0, zxbcdt)
    z, xBC, dt = _split_zxbcdt(cfg, zx)
    if SH.split(conv_dim):
        ch = SH.col_block(conv_dim)
        xBC, conv_state = _causal_conv(xBC[..., ch], p["conv_w"],
                                       p["conv_b"][ch], conv_state)
        xBC = SH.take(xBC, conv_dim, 0, conv_dim)
    else:
        xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                       conv_state)
    gs = s_cfg.n_groups * s_cfg.d_state
    B = xBC[..., d_inner:d_inner + gs].reshape(b, s, s_cfg.n_groups,
                                               s_cfg.d_state)
    C = xBC[..., d_inner + gs:].reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])
    return z, xBC[..., :d_inner], B, C, dt, -torch.exp(p["A_log"]), conv_state


def _heads(cfg, xs, dt, A, B, C):
    """The rank's heads (`sharding.heads`) of the scan's inputs: xh (b, s,
    hl, hp), dt, A, and B, C cut to the groups those heads read. Returns
    (h0, xh, dt, A, B, C)."""
    b, s = xs.shape[:2]
    nh, hp, g = dims(cfg)[1], cfg.ssm.head_dim, cfg.ssm.n_groups
    h0, h1 = SH.heads(nh)
    if h1 - h0 == nh:
        return 0, xs.reshape(b, s, nh, hp), dt, A, B, C
    xh = xs[..., h0 * hp:h1 * hp].reshape(b, s, h1 - h0, hp)
    hpg = nh // g
    g0, g1 = h0 // hpg, (h1 - 1) // hpg + 1
    if (h1 - h0) % (g1 - g0):
        raise NotImplementedError(f"heads {h0}..{h1} straddle the groups of "
                                  f"{hpg} heads unevenly")
    return (h0, xh, dt[..., h0:h1], A[h0:h1], B[:, :, g0:g1],
            C[:, :, g0:g1])


def _block(t, first: int, n: int):
    """Entries ``first … first + n`` of a per-head vector: a view, or
    ``t`` itself where those are all of them."""
    return t if n == t.shape[0] else t[first:first + n]


def _out(p, cfg, y, z, dtype, lo: int = 0):
    """Gated RMSNorm and out_proj of the scan's f32 output (b, s, ·):
    channels ``lo`` … of d_inner. The norm's mean of squares runs over the
    whole d_inner: where the rank holds a block, its sum of squares is
    SUM all-reduced over the model axis."""
    d_inner = dims(cfg)[0]
    if y.shape[-1] == d_inner:
        y = rms_norm(y.to(dtype) * F.silu(z), p["norm_w"], cfg.norm_eps)
    else:
        yz = y.to(dtype) * F.silu(z[..., lo:lo + y.shape[-1]])
        yf = yz.to(torch.promote_types(yz.dtype, torch.float32))
        var = SH.model_axis().sum((yf * yf).sum(dim=-1, keepdim=True))
        inv = torch.rsqrt(var / d_inner + cfg.norm_eps)
        y = yz * inv.to(dtype) * p["norm_w"][lo:lo + y.shape[-1]]
    return SH.rows(y, p["out_proj"], d_inner, lo)


def mamba2_full(p, cfg: ModelConfig, x, conv_state=None, h0=None):
    """Full-sequence Mamba2 block on the rank's heads. Returns (out,
    {"state": (b,hl,hp,ds) f32, "conv": (b,K-1,·) in x's dtype}) — the
    rank's heads and conv channels."""
    b, s = x.shape[:2]
    hp = cfg.ssm.head_dim
    z, xs, B, C, dt, A, conv_state = _project(p, cfg, x, conv_state)
    first, xh, dt, A, B, C = _heads(cfg, xs, dt, A, B, C)
    with tracing.span("ssm.scan"):
        y, h_last = ssd_chunked(xh, dt, A, B, C, cfg.ssm.chunk, h0=h0)
    D = _block(p["D"], first, xh.shape[2])
    y = y + D[None, None, :, None] * xh.float()
    out = _out(p, cfg, y.reshape(b, s, -1), z, x.dtype, first * hp)
    return out, {"state": h_last, "conv": conv_state}


def mamba2_decode(p, cfg: ModelConfig, x, cache):
    """Single-token recurrent update. x: (b,1,d); cache {"state": (b,nh,hp,
    ds) f32, "conv": (b,K-1,conv_dim)} (the rank's heads and channels),
    updated IN PLACE (the reference returns an updated copy). Returns
    (out, cache)."""
    b = x.shape[0]
    hp = cfg.ssm.head_dim
    z, xs, B, C, dt, A, conv_state = _project(p, cfg, x, cache["conv"])
    first, xh, dt, A, B, C = _heads(cfg, xs, dt, A, B, C)
    hl = xh.shape[2]
    dt = dt[:, 0]                                              # (b,hl)
    xh = xh.reshape(b, hl, hp).float()                         # (b,hl,hp)
    hpg = hl // B.shape[2]
    # head h reads group h // hpg: jnp.repeat, i.e. repeat_interleave
    Bh = B[:, 0].float().repeat_interleave(hpg, dim=1)         # (b,hl,ds)
    Ch = C[:, 0].float().repeat_interleave(hpg, dim=1)
    decay = torch.exp(dt * A[None, :])
    h = cache["state"] * decay[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
    D = _block(p["D"], first, hl)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + D[None, :, None] * xh
    out = _out(p, cfg, y.reshape(b, 1, hl * hp), z, x.dtype, first * hp)
    cache["state"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
