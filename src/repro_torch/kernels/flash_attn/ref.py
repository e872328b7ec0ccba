"""Plain PyTorch version of the flash-attention kernel: dense softmax
attention, the oracle the CUDA kernel is held to (the JAX package's
`kernels/flash_attn/ref.py`)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv), GQA by
    head repetition (kv head ``h // g``). Scores in f32, scaled by
    ``1/sqrt(D)``; masked scores are ``-1e30`` and their weights 0; the
    row sum is floored at ``1e-30``. Query positions start at 0 whatever
    Sk is; ``window`` applies only when ``causal``. Returns (B, H, Sq, Dv)
    in q's dtype."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (D ** 0.5)
    mask = None
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
