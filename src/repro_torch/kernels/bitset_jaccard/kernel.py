"""Wrappers of the CUDA kernels `csrc/bitset_intersections.cu` (batched
all-pairs intersection popcounts of packed neighbor bitmaps) and
`csrc/pairwise_intersections.cu` (all pairs of one wide bitmap set).

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``LAUNCHES`` and ``PAIRWISE_LAUNCHES`` count kernel
launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitset_jaccard import ref

LAUNCHES = 0
PAIRWISE_LAUNCHES = 0


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


def pairwise_intersections(bits: torch.Tensor) -> torch.Tensor:
    """bits ``(G, W)`` int32 — the bit-identical view of uint32 words — →
    ``(G, G)`` int32 intersection popcounts of every row pair."""
    global PAIRWISE_LAUNCHES
    if bits.dim() != 2 or bits.dtype != torch.int32:
        raise ValueError(f"bits must be a (G, W) int32 tensor, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    G, W = bits.shape
    if bits.device.type == "cpu":
        return ref.pairwise_intersection(bits)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    if not bits.is_contiguous():
        raise ValueError("bits must be contiguous")
    lib = _build.load_library()
    out = torch.empty((G, G), dtype=torch.int32, device=bits.device)
    if G == 0:
        return out
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.pairwise_intersections_launch(
            bits.data_ptr(), out.data_ptr(), G, W, stream)
    _build.check_status("pairwise_intersections", status)
    PAIRWISE_LAUNCHES += 1
    return out
