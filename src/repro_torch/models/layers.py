"""Shared neural building blocks (plain functions over parameter tensors),
forward only.

Each keeps the JAX package's order of operations and its casts, so the
two packages round alike in bf16: `rms_norm` takes the variance in f32 and
scales in ``x.dtype``; `apply_rope` rotates split halves in f32 and casts
back; `swiglu` gates in the working dtype; `lowp_matmul_f32` multiplies
in ``x.dtype`` and returns f32. The custom VJPs of the reference
(`rms_norm`'s, `lowp_matmul_f32`'s) belong to training and are not ported
yet (slice F7).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMSNorm: the mean square in f32, ``x * inv * w`` in ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True)
    inv = torch.rsqrt(var / x.shape[-1] + eps)
    return x * inv.to(x.dtype) * w


def lowp_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('...d,de->...e')`` of x and ``w`` cast to ``x.dtype``, with
    f32 accumulation and an f32 result (the MoE router's logits; a plain
    bf16 matmul would round them to bf16). The operands are widened to f32
    after the cast: a product of two bf16 values is exact in f32, and so
    is a bf16 value under TF32, so this is the bf16 product accumulated
    in f32. Forward only."""
    return x.float() @ w.to(x.dtype).float()


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                scale=None, lead: tuple = ()):
    """``(*lead, d_in, d_out)`` normal weights scaled by ``1/sqrt(d_in)``,
    drawn in f32 on the generator's device and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*lead, d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down
