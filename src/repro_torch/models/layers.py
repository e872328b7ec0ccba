"""Shared neural building blocks (plain functions over parameter tensors).

Each keeps the JAX package's order of operations and its casts, so the
two packages round alike in bf16: `rms_norm` takes the variance in f32 and
scales in ``x.dtype``; `apply_rope` rotates split halves in f32 and casts
back; `swiglu` gates in the working dtype; `lowp_matmul_f32` multiplies
in ``x.dtype`` and returns f32. `rms_norm` and `lowp_matmul_f32` are
`torch.autograd.Function` subclasses whose backward passes are the
reference's custom VJPs: their reductions accumulate in f32 while the
elementwise math and the operands stay in ``x.dtype``. "f32" is f32 or
``x.dtype`` where that is wider (float64, in which `torch.autograd.
gradcheck` holds the backward passes to finite differences).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _acc(t: torch.Tensor) -> torch.dtype:
    """The accumulation type: f32, or ``t``'s type where that is wider."""
    return torch.promote_types(t.dtype, torch.float32)


def _rms_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``rsqrt(mean(x²) + eps)`` over the last dim, in f32, (..., 1)."""
    xf = x.to(_acc(x))
    var = (xf * xf).sum(dim=-1, keepdim=True)
    return torch.rsqrt(var / x.shape[-1] + eps)


class _RmsNorm(torch.autograd.Function):
    """The reference's `rms_norm` and its custom VJP."""

    @staticmethod
    def forward(ctx, x, w, eps):
        inv = _rms_inv(x, eps)
        ctx.save_for_backward(x, w, inv)
        return x * inv.to(x.dtype) * w

    @staticmethod
    def backward(ctx, dy):
        x, w, inv = ctx.saved_tensors
        d = x.shape[-1]
        inv_l = inv.to(x.dtype)
        dyw = dy * w
        # dw: accumulated in f32 over every leading dim
        acc = _acc(x)
        dw = (dy.to(acc) * (x * inv_l).to(acc)).reshape(-1, d).sum(0)
        # dx = inv·dyw − x·inv³·<dyw, x>/d, the coefficient in x.dtype
        dot = (dyw.to(acc) * x.to(acc)).sum(dim=-1, keepdim=True)
        coeff = (inv ** 3 * dot / d).to(x.dtype)
        return dyw * inv_l - x * coeff, dw.to(w.dtype), None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMSNorm: the mean square in f32, ``x * inv * w`` in ``x.dtype``."""
    return _RmsNorm.apply(x, w, eps)


class _LowpMatmulF32(torch.autograd.Function):
    """The reference's `lowp_matmul_f32` and its custom VJP."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.to(_acc(x)) @ w.to(x.dtype).to(_acc(x))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        acc = _acc(x)
        dyl = dy.to(x.dtype)
        dx = dyl @ w.to(x.dtype).t()
        dw = x.to(acc).reshape(-1, x.shape[-1]).t() \
            @ dyl.to(acc).reshape(-1, dy.shape[-1])
        return dx, dw.to(w.dtype)


def lowp_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('...d,de->...e')`` of x and ``w`` cast to ``x.dtype``, with
    f32 accumulation and an f32 result (the MoE router's logits; a plain
    bf16 matmul would round them to bf16). The operands are widened to f32
    after the cast: a product of two bf16 values is exact in f32, and so
    is a bf16 value under TF32, so this is the bf16 product accumulated
    in f32. The backward keeps both operands in ``x.dtype`` (``dx`` is a
    ``x.dtype`` matmul) and accumulates ``dw`` in f32, cast to
    ``w.dtype``."""
    return _LowpMatmulF32.apply(x, w)


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                scale=None, lead: tuple = ()):
    """``(*lead, d_in, d_out)`` normal weights scaled by ``1/sqrt(d_in)``,
    drawn in f32 on the generator's device and cast to ``dtype``. Scaled
    in place: a stacked leaf's f32 draw is 18 GiB for internvl2-26b's FFN,
    and a second f32 copy beside it did not fit the card."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*lead, d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


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
