"""Wrappers of the CUDA kernels `csrc/bitset_intersections.cu` (batched
all-pairs intersection popcounts of packed neighbor bitmaps) and
`csrc/pairwise_intersections.cu` (all pairs of one wide bitmap set), both
built on the tile routine of `csrc/popc_gram.cuh`.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``LAUNCHES`` and ``PAIRWISE_LAUNCHES`` count kernel
launches only.

The merge engine calls `bitset_intersections` thousands of times a run on
small tiles, so its launch path does little per call: the output comes
from `new_empty`, `_build.launch` looks the launcher up once, reads the
stream as a raw handle and switches the device only when the tensor is
not on the current one, and the pairwise launcher is handed the device's
SM count (read once a device) instead of asking the runtime.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitset_jaccard import ref

LAUNCHES = 0
PAIRWISE_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # wrappers also run on worker threads


def _check_cuda(bits: torch.Tensor, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not bits.is_contiguous():
        raise ValueError("bits must be contiguous")


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
    device = bits.device
    if device.type == "cpu":
        return ref.bitset_intersections(bits, valid)
    _check_cuda(bits, device)
    out = bits.new_empty((B, G, G))
    if out.numel() == 0:
        return out
    _build.launch("bitset_intersections_launch", device.index,
                  bits.data_ptr(), out.data_ptr(), B, G, W, valid)
    with _COUNT_LOCK:
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
    device = bits.device
    if device.type == "cpu":
        return ref.pairwise_intersection(bits)
    _check_cuda(bits, device)
    out = bits.new_empty((G, G))
    if G == 0:
        return out
    index = device.index
    _build.launch("pairwise_intersections_launch", index, bits.data_ptr(),
                  out.data_ptr(), G, W, _build.sm_count(index))
    with _COUNT_LOCK:
        PAIRWISE_LAUNCHES += 1
    return out
