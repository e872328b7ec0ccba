"""Wrapper of the CUDA kernel `csrc/bitset_intersections.cu`: batched
all-pairs intersection popcounts of packed neighbor bitmaps.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitset_jaccard import ref

LAUNCHES = 0


def bitset_intersections(bits: torch.Tensor, valid: int) -> torch.Tensor:
    """bits ``(B, G, W)`` int32 — the bit-identical view of uint32 words —
    and the count of real batch rows → ``(B, G, G)`` int32 intersection
    popcounts; rows ≥ ``valid`` are zero."""
    global LAUNCHES
    if bits.dim() != 3 or bits.dtype != torch.int32:
        raise ValueError(f"bits must be a (B, G, W) int32 tensor, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    B, G, W = bits.shape
    valid = max(0, min(int(valid), B))
    if bits.device.type == "cpu":
        return ref.bitset_intersections(bits, valid)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    if not bits.is_contiguous():
        raise ValueError("bits must be contiguous")
    lib = _build.load_library()
    out = torch.empty((B, G, G), dtype=torch.int32, device=bits.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.bitset_intersections_launch(
            bits.data_ptr(), out.data_ptr(), B, G, W, valid, stream)
    _build.check_status("bitset_intersections", status)
    LAUNCHES += 1
    return out
