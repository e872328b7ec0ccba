"""Plain reference of a DeepSeek-V2-style decoder: latent attention (MLA)
and a mixture of experts with shared experts, in float32 (TF32 off).

It follows the configuration file, not the port: the capacity rule,
``norm_topk_prob`` and the widths come from the file. It imports nothing
of the port and works out routing, capacity slots and the latent cache
again from the token ids and the weights it is handed (a dict in the
port's layout: weights ``(d_in, d_out)``, layers stacked on a leading
axis). One layer at a time, attention in query blocks, each expert's
weights widened to f32 one expert at a time, so it fits beside the bf16
weights on one card.

Conventions the file leaves open and this follows: RoPE rotates the
split halves of its 64 dims (``[x1, x2]``), applied to the queries' and
the shared key's rope parts; scores are scaled by ``1/sqrt(nope + rope)``;
the latent is RMS-normalised before its expansion and cached normalised,
the rope key cached rotated. Top-k is a stable descending sort (the lower
expert first among equals); a (token, choice) pair's place in its
expert's buffer is its rank in token order within its batch row, and a
pair at rank ``capacity(s)`` or later is dropped.

``quant="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 with one scale a tensor, the rest unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _q8(t: torch.Tensor) -> torch.Tensor:
    s = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(a, b, quant):
    a, b = a.float(), b.float()
    if quant == "fp8":
        a, b = _q8(a), _q8(b)
    return a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def plain_rope(c: dict) -> bool:
    """Whether the file's RoPE is plain RoPE at ``rope_theta``: no scaling,
    or YaRN at a factor of at most 1, whose interpolated and extrapolated
    frequencies coincide and whose mscale is 1."""
    r = c["rope_scaling"]
    return r is None or (r["type"] == "yarn" and r["factor"] <= 1)


def _rope(x, theta):
    """x: (b, s, h, dr), positions 0..s-1."""
    s, dr = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, dr, 2, dtype=torch.float32,
                                  device=x.device) / dr)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :dr // 2], x[..., dr // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def capacity(c: dict, s: int) -> int:
    """Buffer rows an expert gets in a batch row of ``s`` tokens:
    ``int(factor·s·k/E)``, at least k, rounded up to a multiple of
    ``capacity_round`` once above it."""
    b = c["bench"]
    k, e = c["num_experts_per_tok"], c["n_routed_experts"]
    cap = max(int(b["capacity_factor"] * s * k / e), k)
    r = b["capacity_round"]
    return -(-cap // r) * r if cap > r else cap


def _attend(q, k, v, quant, qblock):
    """Causal attention, q/k (b, s, h, D), v (b, s, h, Dv), in query
    blocks over the keys each block can see."""
    b, s, h, D = q.shape
    out = q.new_empty(b, s, h, v.shape[-1])
    scale = 1.0 / math.sqrt(D)
    if quant == "fp8":
        q, k, v = _q8(q), _q8(k), _q8(v)
    for q0 in range(0, s, qblock):
        q1 = min(s, q0 + qblock)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1]) * scale
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        ki = torch.arange(q1, device=q.device)[None, :]
        sc.masked_fill_(ki > qi, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        del sc
        if quant == "fp8":
            p = _q8(p)
        out[:, q0:q1] = torch.einsum("bhqk,bkhd->bqhd", p, v[:, :q1])
        del p
    return out


def _mla(x, a, c, quant, qblock):
    b, s, _ = x.shape
    H = c["num_attention_heads"]
    nope, dr = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, r = c["v_head_dim"], c["kv_lora_rank"]
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    q = _mm(x, a["wq"], quant).view(b, s, H, nope + dr)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], dim=-1)
    ca = _mm(x, a["wkv_a"], quant)
    ckv = _rms(ca[..., :r], a["kv_norm"], eps)
    krope = _rope(ca[..., r:][:, :, None, :], theta)[:, :, 0, :]
    del ca
    kv = _mm(ckv, a["wkv_b"], quant).view(b, s, H, nope + vd)
    k = torch.cat([kv[..., :nope], krope[:, :, None, :].expand(b, s, H, dr)],
                  dim=-1)
    o = _attend(q, k, kv[..., nope:], quant, qblock)
    del q, k, kv
    return _mm(o.reshape(b, s, H * vd), a["wo"], quant), ckv, krope


def _moe(x, m, c, quant):
    """Routed experts with capacity slots, plus the shared experts."""
    b, s, d = x.shape
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    probs = torch.softmax(_mm(x, m["router"], quant), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    if c["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e = top_e.reshape(b, s * k)
    hot = F.one_hot(flat_e, E)
    rank = (hot.cumsum(1) - 1).gather(2, flat_e[..., None])[..., 0]
    del hot
    keep = rank < capacity(c, s)
    w = top_p.reshape(b, s * k)
    xf = x.reshape(b * s, d)
    out = torch.zeros_like(xf)
    for e in range(E):
        bi, pi = torch.nonzero((flat_e == e) & keep, as_tuple=True)
        if bi.numel() == 0:
            continue
        rows = bi * s + torch.div(pi, k, rounding_mode="floor")
        xe = xf[rows]
        h = F.silu(_mm(xe, m["we_gate"][e], quant)) * _mm(
            xe, m["we_up"][e], quant)
        out.index_add_(0, rows, _mm(h, m["we_down"][e], quant)
                       * w[bi, pi][:, None])
    if c["n_shared_experts"]:
        hs = F.silu(_mm(xf, m["ws_gate"], quant)) * _mm(xf, m["ws_up"], quant)
        out = out + _mm(hs, m["ws_down"], quant)
    return out.view(b, s, d), int((~keep).sum())


def layer_weights(W: dict, i: int) -> dict:
    def at(t):
        return {k: at(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return at(W["layers"])


@torch.no_grad()
def forward(W: dict, c: dict, tokens: torch.Tensor, quant=None,
            qblock: int = 512) -> dict:
    """``tokens`` (b, s) ids on the weights' device. Returns the f32
    logits at the last position over the vocabulary ``(b, V)``, the
    cache that a prefill leaves (``{"ckv": [(b, s, r)] a layer, "krope":
    [(b, s, rope)] a layer}``) and the dropped (token, choice) pairs."""
    if not plain_rope(c):
        raise ValueError("the reference applies plain RoPE only")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        eps = c["rms_norm_eps"]
        x = W["embed"][tokens].float()
        cache = {"ckv": [], "krope": []}
        dropped = 0
        for i in range(c["num_hidden_layers"]):
            lw = layer_weights(W, i)
            h, ckv, krope = _mla(_rms(x, lw["ln1"], eps), lw["attn"], c,
                                 quant, qblock)
            x = x + h
            cache["ckv"].append(ckv)
            cache["krope"].append(krope)
            f, n = _moe(_rms(x, lw["ln2"], eps), lw["moe"], c, quant)
            x = x + f
            dropped += n
            del h, f
        last = _rms(x[:, -1], W["final_norm"], eps)
        logits = _mm(last, W["lm_head"], quant)[:, :c["vocab_size"]]
        return {"logits": logits, "cache": cache, "dropped": dropped,
                "pairs": tokens.numel() * c["num_experts_per_tok"]
                * c["num_hidden_layers"]}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


# ------------------------------------------------------------------ work
def prefill_flops(c: dict, b: int, s: int) -> int:
    """Model FLOPs of one prefill of ``b`` rows of ``s`` tokens: 2 per
    weight a token passes through (the routed experts at ``top_k``
    choices a token, the router, the shared experts), attention at
    2·(D + Dv) a visible (query, key) pair and head, the head at the last
    position of each row only. The embedding is a lookup: no FLOPs."""
    d, H = c["hidden_size"], c["num_attention_heads"]
    nope, dr = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, r = c["v_head_dim"], c["kv_lora_rank"]
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    f, ns = c["moe_intermediate_size"], c["n_shared_experts"]
    per_token = (d * H * (nope + dr) + d * (r + dr) + r * H * (nope + vd)
                 + H * vd * d + d * E + k * 3 * d * f + 3 * d * ns * f)
    L = c["num_hidden_layers"]
    linear = 2 * per_token * b * s * L
    attn = 2 * (nope + dr + vd) * H * (s * (s + 1) // 2) * b * L
    head = 2 * d * c["vocab_size"] * b
    return linear + attn + head


def flash_calls(c: dict, b: int, s: int) -> list:
    """The flash calls of one prefill: ``(B, H, Hkv, Sq, Sk, D, Dv,
    causal, window)``, one a layer, MLA attended as MHA."""
    H = c["num_attention_heads"]
    D = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return [(b, H, H, s, s, D, c["v_head_dim"], True, 0)] \
        * c["num_hidden_layers"]
