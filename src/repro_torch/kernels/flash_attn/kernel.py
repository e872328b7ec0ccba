"""Wrapper of the CUDA kernel `csrc/flash_attention.cu`: causal,
sliding-window or full attention with GQA and an online softmax.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``LAUNCHES`` counts kernel launches only. The
kernel's tiles are its own (64 query rows by 64 key rows), so the JAX
kernel's ``bq``/``bk`` have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import ref

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D) with H % Hkv == 0 (kv head
    ``h // (H // Hkv)``), one dtype (bfloat16 or float32), D a multiple of
    8 in [8, 256]. Returns (B, H, Sq, D) in q's dtype. ``window`` (> 0)
    limits each query to its last ``window`` keys when ``causal``."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, H, Sq, D) and k, v (B, Hkv, Sk, D) of "
                         f"one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v batch and head dim {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} kv "
                         f"heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of bfloat16 or "
                         f"float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"head dim {D} is not a multiple of 8 in [8, 256]")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            Hkv, Sq, Sk, D, int(bool(causal)), int(window), 1.0 / D ** 0.5,
            _DTYPES[q.dtype], stream)
    _build.check_status("flash_attention", status)
    LAUNCHES += 1
    return out
