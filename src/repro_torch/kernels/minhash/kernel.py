"""Wrapper of the CUDA kernel `csrc/rowmin_hash.cu`: per-row min of the u32
shingle hash over packed adjacency rows.

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``LAUNCHES`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.minhash import ref

LAUNCHES = 0


def rowmin_hash(nbr: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``(R, W)`` int32 (u32 words, sentinel ``0xFFFFFFFF``) and the hash
    constants → ``(R,)`` int32 (u32 bits) row minima of the hash."""
    global LAUNCHES
    if nbr.dim() != 2 or nbr.dtype != torch.int32:
        raise ValueError(f"nbr must be an (R, W) int32 tensor, got "
                         f"{tuple(nbr.shape)} {nbr.dtype}")
    a, b = int(a) & 0xFFFFFFFF, int(b) & 0xFFFFFFFF
    if nbr.device.type == "cpu":
        return ref.rowmin_hash(nbr, a, b)
    if nbr.device.type != "cuda":
        raise ValueError(f"unsupported device {nbr.device}")
    if not nbr.is_contiguous():
        raise ValueError("nbr must be contiguous")
    R, W = nbr.shape
    lib = _build.load_library()
    out = torch.empty(R, dtype=torch.int32, device=nbr.device)
    if R == 0:
        return out
    with torch.cuda.device(nbr.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.rowmin_hash_launch(nbr.data_ptr(), out.data_ptr(), R, W,
                                        a, b, stream)
    _build.check_status("rowmin_hash", status)
    LAUNCHES += 1
    return out
