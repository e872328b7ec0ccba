"""Mixture-of-Experts FFN with sort+gather dispatch (the JAX package's
`models/moe.py`).

Top-k routing into per-expert capacity buffers, grouped per batch row.
Ranks within an expert come from a stable argsort of the flat expert
assignments, so routing is deterministic and, with enough capacity, the
same in prefill and decode. Capacity depends on the row's token count,
so it is not causal: a prefill may drop tokens that a decode step or a
longer forward keeps.

Three places where a literal translation would differ:

- ``jax.lax.top_k`` puts the lower expert first among equal
  probabilities; ``torch.topk`` promises no order. Top-k here is a stable
  descending sort, which keeps the lower index first.
- The dispatch scatter sends every dropped (token, k) pair to the one
  sentinel column ``e·cap``. On the card ``scatter_`` keeps an arbitrary
  one of those duplicates; that column is sliced off before it is read.
- ``take_along_axis`` over ``d`` would need an int64 index as large as the
  activations; the gathers index rows (``x[gi, src]``) instead.

The expert products are batched matmuls over the expert axis (cuBLAS on
the card), as the reference computes them outside any Pallas kernel. The
buffers are gathered expert-major, ``(e, b·cap, d)``, so the products
need no transposed copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as SH
from repro_torch.models.layers import lowp_matmul_f32
from repro_torch.models.sharding import constrain


def param_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """``init_moe``'s tree, each shape behind ``lead`` (the layer axis).
    The router is float32 in every model; the rest is in ``cfg.dtype``."""
    d, mo = cfg.d_model, cfg.moe
    e, f = mo.n_experts, mo.d_expert
    p = {"router": (*lead, d, e), "we_gate": (*lead, e, d, f),
         "we_up": (*lead, e, d, f), "we_down": (*lead, e, f, d)}
    if mo.n_shared:
        ds = mo.d_shared or mo.d_expert
        p.update(ws_gate=(*lead, d, ds), ws_up=(*lead, d, ds),
                 ws_down=(*lead, ds, d))
    return p


def _capacity(mo, n_tok: int) -> int:
    cap = int(mo.capacity_factor * n_tok * mo.top_k / mo.n_experts)
    cap = max(cap, mo.top_k)
    return ((cap + 511) // 512) * 512 if cap > 512 else cap  # shard-friendly


class Routing(NamedTuple):
    """One batch's routing. ``probs``: (b, s, e) f32 softmax of the router
    logits; ``top_p``: (b, s, k) renormalised weights of the chosen
    experts; ``top_e``: (b, s, k) their ids, most probable first;
    ``rank``: (b, s·k) each (token, k) pair's place within its expert in
    token order; ``slot``: (b, s·k) its row ``e·cap + rank`` in the
    expert buffers, ``e·cap`` (the sentinel) when dropped; ``cap``: rows
    per expert; ``dropped``: the number of pairs beyond capacity, a 0-d
    tensor on x's device, which `moe_ffn` counts as ``dropped_pairs`` on
    its `tracing` span ``moe.route``: read once, when a recording
    closes."""
    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    rank: torch.Tensor
    slot: torch.Tensor
    cap: int
    dropped: torch.Tensor


def route(p, cfg: ModelConfig, x) -> Routing:
    """The router of `moe_ffn` on ``x`` (b, s, d)."""
    mo = cfg.moe
    b, s, _ = x.shape
    k, e = mo.top_k, mo.n_experts
    logits = lowp_matmul_f32(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    # stable: among equal probabilities the lower expert first (lax.top_k)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = _capacity(mo, s)
    flat_e = top_e.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=x.device).expand(b, e).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    rank_sorted = torch.arange(s * k, device=x.device)[None, :] \
        - torch.gather(starts, 1, sorted_e)
    # the inverse permutation: what `take_along_axis(·, argsort(order))` is
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, e * cap)
    return Routing(probs, top_p, top_e, rank.to(torch.int32), slot, cap,
                   (~keep).sum())


def moe_ffn(p, cfg: ModelConfig, x):
    """x: (b, s, d) -> ((b, s, d), aux loss), routed by `route`. Under a
    model axis that splits the experts, the rank holds a block of them
    (``we_*``'s leading dim): it routes every token as every rank does
    (the router is replicated), gathers only its experts' rows, and adds
    only their contributions; the shared experts run as a column-then-
    row block, and one SUM all-reduce covers both partial sums."""
    mo = cfg.moe
    b, s, d = x.shape
    k, e = mo.top_k, mo.n_experts
    with tracing.span("moe.route"):
        r = route(p, cfg, x)
        tracing.add("dropped_pairs", r.dropped)
        tracing.add("pairs", b * s * k)
    cap, slot = r.cap, r.slot
    el = p["we_gate"].shape[0]          # the rank's experts, e0 … e0+el-1
    lo = SH.col_block(e).start * cap    # their first buffer row
    hi = lo + el * cap

    with tracing.span("moe.dispatch"):
        gi = torch.arange(b, device=x.device)[:, None]
        # slot -> source token within the row (sentinel -> zero row).
        # Dropped pairs all write the sentinel column; it is sliced off.
        tok = (torch.arange(s * k, device=x.device) // k).expand(b, s * k)
        src = torch.full((b, e * cap + 1), s, dtype=torch.int64,
                         device=x.device)
        src.scatter_(1, slot, tok)
        src = src[:, lo:hi].reshape(b, el, cap).transpose(0, 1).contiguous()
        x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
        # gathered expert-major, so "gecd,edf->gecf" is one batched matmul
        xe = constrain(x_pad[gi[None], src].view(el, b * cap, d),
                       ("model", "dp", None))
    with tracing.span("moe.experts"):
        h = F.silu(torch.bmm(xe, p["we_gate"])) * torch.bmm(xe, p["we_up"])
        del xe
        eo = constrain(torch.bmm(h, p["we_down"]),          # (el, b·cap, d)
                       ("model", "dp", None))
        del h

    with tracing.span("moe.combine"):
        # each (token, k) reads its row of eo, expert-major; dropped
        # pairs, and pairs of another rank's experts, read the zero row
        eo_pad = torch.cat([eo.view(el * b * cap, d), eo.new_zeros(1, d)])
        del eo
        mine, rel = ((slot < hi, slot) if lo == 0
                     else ((slot >= lo) & (slot < hi), slot - lo))
        row = torch.where(mine,
                          rel // cap * (b * cap) + gi * cap + slot % cap,
                          el * b * cap)
        gathered = eo_pad[row].view(b, s, k, d)
        routed = (gathered * r.top_p.to(gathered.dtype)[..., None]).sum(dim=2)
    parts = [(routed, SH.split(e))]
    if mo.n_shared:
        with tracing.span("moe.shared"):
            ds = mo.d_shared or mo.d_expert
            hs = F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
            parts.append(SH.row_partial(hs, p["ws_down"], ds,
                                        SH.col_block(ds).start))
    out = _add_parts(parts)
    with tracing.span("moe.aux"):
        aux = _load_balance_loss(r.probs.reshape(b * s, e),
                                 r.top_e.reshape(b * s, k), e)
    return out, aux


def _add_parts(parts):
    """Σ of ``[(term, partial?)]``, in order: the partial terms summed
    locally, then over the model axis in one SUM all-reduce."""
    shares = [t for t, partial in parts if partial]
    out = None
    if shares:
        out = shares[0]
        for t in shares[1:]:
            out = out + t
        out = SH.model_axis().sum(out)
    for t, partial in parts:
        if not partial:
            out = t if out is None else out + t
    return out


def _global_mean(local_mean, axis):
    """The mean over every rank's rows of a per-rank mean (the ranks hold
    equal row counts), differentiably (`sharding.Axis.sum`)."""
    if axis is None or axis.size == 1:
        return local_mean
    return axis.sum(local_mean) / axis.size


def _load_balance_loss(probs, top_e, n_experts):
    """Switch-style auxiliary load-balancing loss (f32) over the GLOBAL
    batch: under a data-parallel mesh context (`sharding.data_axis`) both
    per-expert means are reduced over the ranks first, so the loss is the
    whole batch's and not a mean of per-rank products. Routing is
    replicated over the model axis, so every rank of it has the same."""
    axis = SH.data_axis()
    me = _global_mean(probs.mean(0), axis)
    # one-hot by comparison, not `F.one_hot`, whose CPU kernel alone first
    # reads the ids' range: the same ops on every device, so the step
    # counts alike on the card, the CPU and meta (`launch/step_analysis`)
    hot = top_e[:, :1] == torch.arange(n_experts, device=top_e.device)
    ce = _global_mean(hot.float().mean(0), axis)
    return n_experts * torch.sum(me * ce)
