"""Wrapper of the CUDA kernel `csrc/interval_count.cu`: signed
interval-membership counts of the batched summary queries.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``LAUNCHES`` counts kernel launches only. The launch
path is `_build.launch` (launcher looked up once, raw stream, no device
switch on the current device); the output comes from `new_empty`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.interval_expand import ref

LAUNCHES = 0


def interval_counts(lo: torch.Tensor, hi: torch.Tensor, sign: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """``(B, E)`` int32 intervals ``[lo, hi)`` with ``sign``, and ``(B, P)``
    int32 probes → ``(B, P)`` int32 signed containment counts. Padding:
    intervals ``lo == hi == 0`` (sign 0) and probes ``-1`` match nothing."""
    global LAUNCHES
    if lo.dim() != 2 or pos.dim() != 2 or pos.shape[0] != lo.shape[0]:
        raise ValueError(f"need (B, E) intervals and (B, P) probes, got "
                         f"{tuple(lo.shape)} and {tuple(pos.shape)}")
    for name, t in (("lo", lo), ("hi", hi), ("sign", sign), ("pos", pos)):
        if t.dtype != torch.int32 or t.device != lo.device:
            raise ValueError(f"{name} must be int32 on {lo.device}, got "
                             f"{t.dtype} on {t.device}")
    if hi.shape != lo.shape or sign.shape != lo.shape:
        raise ValueError("lo, hi and sign must have one shape")
    B, E = lo.shape
    P = pos.shape[1]
    if lo.device.type == "cpu":
        return ref.interval_counts(lo, hi, sign, pos)
    if lo.device.type != "cuda":
        raise ValueError(f"unsupported device {lo.device}")
    if not all(t.is_contiguous() for t in (lo, hi, sign, pos)):
        raise ValueError("lo, hi, sign and pos must be contiguous")
    out = pos.new_empty((B, P))
    if out.numel() == 0:
        return out
    _build.launch("interval_count_launch", lo.device.index, lo.data_ptr(),
                  hi.data_ptr(), sign.data_ptr(), pos.data_ptr(),
                  out.data_ptr(), B, E, P)
    LAUNCHES += 1
    return out
