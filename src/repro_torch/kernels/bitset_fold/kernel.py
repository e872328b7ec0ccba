"""Wrappers of the resident merge round's two CUDA kernels:
`csrc/jaccard_topj.cu` (ranked top-J candidates of every row) and
`csrc/bitset_fold.cu` (the in-place bitset-OR fold of a round's pairs).

Dispatch is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (a failed launch raises), a CPU tensor takes the plain
version in `ref.py`. ``TOPJ_LAUNCHES`` and ``FOLD_LAUNCHES`` count kernel
launches only. The resident round calls both once a round, so the launch
path is `_build.launch` (launcher looked up once, raw stream, no device
switch on the current device) and outputs come from `new_empty`.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitset_fold import ref

TOPJ_LAUNCHES = 0
FOLD_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()  # wrappers also run on worker threads
MAX_G = 128  # the merge engine's largest batched group


def _check_bits(bits, alive):
    if bits.dim() != 3 or bits.dtype != torch.int32:
        raise ValueError(f"bits must be a (B, G, W) int32 tensor, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    B, G, _ = bits.shape
    if alive.shape != (B, G) or alive.dtype != torch.int8:
        raise ValueError(f"alive must be a ({B}, {G}) int8 tensor, got "
                         f"{tuple(alive.shape)} {alive.dtype}")
    if not 1 <= G <= MAX_G:
        raise ValueError(f"group width {G} outside 1..{MAX_G}")
    if alive.device != bits.device:
        raise ValueError("bits and alive must share a device")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits.device}")
    if bits.device.type == "cuda" and not (bits.is_contiguous()
                                           and alive.is_contiguous()):
        raise ValueError("bits and alive must be contiguous")


def jaccard_topj(bits: torch.Tensor, alive: torch.Tensor,
                 J: int) -> torch.Tensor:
    """bits ``(B, G, W)`` int32 (uint32 words), alive ``(B, G)`` int8 →
    ``(B, G, J)`` int32: each row's candidate columns ranked by quantized
    Jaccard key desc, column asc, dead/self columns last; ``1 ≤ J < G``."""
    global TOPJ_LAUNCHES
    _check_bits(bits, alive)
    B, G, W = bits.shape
    J = int(J)
    if not 1 <= J < G:
        raise ValueError(f"J={J} outside 1..{G - 1}")
    if bits.device.type == "cpu":
        return ref.topj_all(bits, alive, J)
    out = bits.new_empty((B, G, J))
    if B == 0:
        return out
    _build.launch("jaccard_topj_launch", bits.device.index, bits.data_ptr(),
                  alive.data_ptr(), out.data_ptr(), B, G, W, J)
    with _COUNT_LOCK:
        TOPJ_LAUNCHES += 1
    return out


def bitset_fold(bits: torch.Tensor, alive: torch.Tensor,
                instr: torch.Tensor) -> None:
    """Fold one round's accepted pairs into ``bits`` ``(B, G, W)`` int32 and
    ``alive`` ``(B, G)`` int8 IN PLACE; ``instr`` ``(B, P, 8)`` int32 rows
    ``[a, z, wa, ba, wz, bz, valid, _]``, applied in order per group. No
    group, no instruction row or no word (W = 0) is a no-op on either
    device."""
    global FOLD_LAUNCHES
    _check_bits(bits, alive)
    B, G, W = bits.shape
    if (instr.dim() != 3 or instr.shape[0] != B or instr.shape[2] != 8
            or instr.dtype != torch.int32 or instr.device != bits.device):
        raise ValueError(f"instr must be a ({B}, P, 8) int32 tensor on "
                         f"{bits.device}, got {tuple(instr.shape)} "
                         f"{instr.dtype} on {instr.device}")
    if B == 0 or W == 0 or instr.shape[1] == 0:
        return  # nothing to fold (no valid row can name a word of W = 0)
    if bits.device.type == "cpu":
        ref.fold_pairs(bits, alive, instr)
        return
    if not instr.is_contiguous():
        raise ValueError("instr must be contiguous")
    _build.launch("bitset_fold_launch", bits.device.index, bits.data_ptr(),
                  alive.data_ptr(), instr.data_ptr(), B, G, W,
                  instr.shape[1])
    with _COUNT_LOCK:
        FOLD_LAUNCHES += 1
