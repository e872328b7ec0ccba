"""The plain reference at a tiny size: against a frozen twin written
token by token in float64, and against the port run in float32."""
import math

import torch

from chipbench import weights
from chipbench.conftest import tiny_config
from chipbench.reference import mla_moe as R


def _weights(c, seed=3):
    from chipbench.adapters import mla_moe as A
    from repro_torch.models import api as API

    cfg = A.port_config(c)
    g = torch.Generator().manual_seed(seed)
    W = weights.make(API.abstract_params(cfg), c["bench"]["init"], g, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (3, 40), generator=g)
    return cfg, W, tokens


def twin(W, c, tokens):
    """DeepSeek-V2-style prefill, one row, token and head at a time, f64."""
    d64 = torch.float64
    H, nope, dr = (c["num_attention_heads"], c["qk_nope_head_dim"],
                   c["qk_rope_head_dim"])
    vd, r, eps = c["v_head_dim"], c["kv_lora_rank"], c["rms_norm_eps"]
    E, k, L = c["n_routed_experts"], c["num_experts_per_tok"], \
        c["num_hidden_layers"]

    def rms(v, w):
        return v / torch.sqrt((v * v).mean(-1, keepdim=True) + eps) * w.to(d64)

    def rot(v, pos):   # halves as the real and imaginary parts
        half = v.shape[-1] // 2
        z = torch.complex(v[..., :half], v[..., half:])
        f = torch.tensor([c["rope_theta"] ** (-2 * i / v.shape[-1])
                          for i in range(half)], dtype=d64)
        z = z * torch.polar(torch.ones(half, dtype=d64), pos * f)
        return torch.cat([z.real, z.imag], -1)

    def lw(name, i):
        node = W["layers"]
        for part in name.split("."):
            node = node[part]
        return node[i].to(d64)

    logits, ckvs, kropes = [], [[] for _ in range(L)], [[] for _ in range(L)]
    for row in tokens:
        s = row.numel()
        x = W["embed"][row].to(d64)
        for i in range(L):
            h = rms(x, lw("ln1", i))
            q = (h @ lw("attn.wq", i)).view(s, H, nope + dr)
            ca = h @ lw("attn.wkv_a", i)
            ckv = rms(ca[:, :r], lw("attn.kv_norm", i))
            kr = torch.stack([rot(ca[t, r:], t) for t in range(s)])
            kv = (ckv @ lw("attn.wkv_b", i)).view(s, H, nope + vd)
            o = torch.zeros(s, H, vd, dtype=d64)
            for t in range(s):
                for hh in range(H):
                    qv = torch.cat([q[t, hh, :nope], rot(q[t, hh, nope:], t)])
                    ks = torch.cat([kv[:t + 1, hh, :nope], kr[:t + 1]], -1)
                    p = torch.softmax(ks @ qv / math.sqrt(nope + dr), 0)
                    o[t, hh] = p @ kv[:t + 1, hh, nope:]
            x = x + o.reshape(s, H * vd) @ lw("attn.wo", i)
            ckvs[i].append(ckv)
            kropes[i].append(kr)
            h = rms(x, lw("ln2", i))
            cap = max(int(c["bench"]["capacity_factor"] * s * k / E), k)
            used = [0] * E
            out = torch.zeros_like(h)
            for t in range(s):
                pr = torch.softmax(h[t] @ lw("moe.router", i), 0)
                top = sorted(range(E), key=lambda e: (-float(pr[e]), e))[:k]
                tot = sum(float(pr[e]) for e in top)
                for e in top:
                    used[e] += 1
                    if used[e] > cap:
                        continue
                    g = h[t] @ lw("moe.we_gate", i)[e]
                    u = h[t] @ lw("moe.we_up", i)[e]
                    y = (torch.nn.functional.silu(g) * u) @ lw("moe.we_down", i)[e]
                    out[t] += float(pr[e]) / tot * y
                g, u = h[t] @ lw("moe.ws_gate", i), h[t] @ lw("moe.ws_up", i)
                out[t] += (torch.nn.functional.silu(g) * u) @ lw("moe.ws_down", i)
            x = x + out
        logits.append(rms(x[-1], W["final_norm"]) @ W["lm_head"].to(d64))
    return (torch.stack(logits)[:, :c["vocab_size"]],
            [torch.stack(v) for v in ckvs], [torch.stack(v) for v in kropes])


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_reference_matches_frozen_twin():
    c = tiny_config("float32")
    _, W, tokens = _weights(c)
    ref = R.forward(W, c, tokens, qblock=16)
    logits, ckv, krope = twin(W, c, tokens)
    assert rel(ref["logits"], logits) < 1e-5
    for i in range(c["num_hidden_layers"]):
        assert rel(ref["cache"]["ckv"][i], ckv[i]) < 1e-5
        assert rel(ref["cache"]["krope"][i], krope[i]) < 1e-5


def test_port_in_f32_equals_reference():
    """The port's prefill in float32 and the reference agree to rounding:
    same routing, capacity slots, caches and last-position logits."""
    from repro_torch.models import transformer as T

    c = tiny_config("float32")
    cfg, W, tokens = _weights(c)
    logits, cache = T.prefill(W, cfg, tokens)
    ref = R.forward(W, c, tokens)
    assert rel(logits[:, -1, :c["vocab_size"]], ref["logits"]) < 1e-5
    for name in ("ckv", "krope"):
        for i in range(c["num_hidden_layers"]):
            assert rel(cache["attn"][name][i], ref["cache"][name][i]) < 1e-5
    assert 0 < ref["dropped"] < ref["pairs"]


def test_capacity_rule():
    c = tiny_config()
    c.update(num_experts_per_tok=6, n_routed_experts=64)
    assert [R.capacity(c, s) for s in (256, 2048, 4096, 8192, 16384)] == \
        [30, 240, 480, 1024, 2048]
    assert R.capacity(c, 1) == 6


def test_plain_rope_is_yarn_at_factor_one():
    c = tiny_config()
    assert R.plain_rope(c) and c["rope_scaling"]["factor"] == 1
    assert R.plain_rope(dict(c, rope_scaling=None))
    assert not R.plain_rope(dict(c, rope_scaling=dict(c["rope_scaling"],
                                                      factor=40)))
