"""Plain PyTorch versions of the two resident merge-round kernels.

Both are INTEGER-EXACT and bit-identical to the CUDA kernels in
`csrc/jaccard_topj.cu` and `csrc/bitset_fold.cu`, to the JAX package's
Pallas kernels, and to the host sweep's ranking and fold in
`core/merging.py` — the cross-backend bit-identity of the merge engine
rests on that agreement (DESIGN.md §9):

* ``topj_all`` — per row, the ranked top-J candidate columns of its group
  by quantized integer Jaccard key (``rank_keys``: shift intersection and
  union down together until the union fits 15 bits, then an exact integer
  quotient), key descending, column ascending, dead/self columns last.
  ``combined_key`` folds the column into the key so every entry is unique
  and any top-k ranks identically.
* ``fold_pairs`` — the bitset-OR merge fold: per accepted pair, fold
  column cz into ca for every row, OR row z into row a, clear z, clear a's
  own bit. Sequential over a group's pairs (two pairs' member columns may
  share a 32-bit word), vectorized over the groups.

Bitmaps are ``int32`` tensors holding the bit patterns of uint32 words:
torch has no uint32 arithmetic on the CPU, so single bits are masks from
``BIT`` (bit 31 is ``-2^31``) and a shift right is only ever followed by
``& 1``. The wrappers in `kernel.py` call these for CPU tensors; on the
card they are only the comparison yardstick.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset_jaccard.ref import bitset_intersections

KEY_BITS = 15
MASKED = -(2**31) + 1  # below every combined key: a column already taken


def bit_masks(device) -> torch.Tensor:
    """(32,) int32 single-bit masks, ``BIT[k] = 1 << k`` as int32."""
    return torch.tensor([(1 << k) - (1 << 32 if k == 31 else 0)
                         for k in range(32)], dtype=torch.int32, device=device)


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Elementwise bit length of non-negative integers < 2^31 (the 5-step
    binary search of the JAX package)."""
    b = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        t = v >> s
        big = t > 0
        b = b + torch.where(big, s, 0).to(v.dtype)
        v = torch.where(big, t, v)
    return b + (v > 0).to(v.dtype)


def rank_keys(inter, deg_r, deg_c):
    """Quantized-Jaccard integer ranking keys in ``[0, 2^15]`` (int32),
    from intersection counts and the two rows' set sizes (broadcastable).
    """
    inter = inter.to(torch.int32)
    union = deg_r.to(torch.int32) + deg_c.to(torch.int32) - inter
    sh = torch.clamp(bit_length(union) - KEY_BITS, min=0)
    return torch.div((inter >> sh) << KEY_BITS,
                     torch.clamp(union >> sh, min=1), rounding_mode="floor")


def combined_key(keys, ok, col, G: int):
    """``(key+1)·G − 1 − col`` for eligible columns, ``−1 − col`` for
    dead/self ones: a strict total order (key desc, column asc, dead/self
    last), below 2^23 for G ≤ 128."""
    return torch.where(ok, (keys + 1) * G - 1 - col, -1 - col)


def topj_all(bits: torch.Tensor, alive: torch.Tensor, J: int) -> torch.Tensor:
    """bits ``(B, G, W)`` int32, alive ``(B, G)`` → ``(B, G, J)`` int32
    ranked candidate columns of every row; ``J < G``."""
    B, G, W = bits.shape
    inter = bitset_intersections(bits, B)                   # (B, G, G) int32
    deg = torch.diagonal(inter, dim1=1, dim2=2)             # |x & x| = |x|
    keys = rank_keys(inter, deg[:, :, None], deg[:, None, :])
    col = torch.arange(G, dtype=torch.int32, device=bits.device)
    ok = (alive[:, None, :] > 0) & (col[None, None, :] != col[None, :, None])
    ckey = combined_key(keys, ok, col, G)
    # keys are unique, so J argmax passes rank exactly like the kernel's
    out = torch.empty((B, G, J), dtype=torch.int32, device=bits.device)
    for j in range(J):
        idx = ckey.argmax(dim=2)
        out[:, :, j] = idx
        ckey.scatter_(2, idx[:, :, None], MASKED)
    return out


def fold_pairs(bits: torch.Tensor, alive: torch.Tensor,
               instr: torch.Tensor) -> None:
    """Apply one round's accepted pairs IN PLACE.

    bits ``(B, G, W)`` int32, alive ``(B, G)`` int8, instr ``(B, P, 8)``
    int32 rows ``[a, z, wa, ba, wz, bz, valid, _]``: the a/z rows and the
    word/bit of their member columns. Pair p of every group applies before
    pair p+1; rows with ``valid = 0`` change nothing.
    """
    B, G, W = bits.shape
    BIT = bit_masks(bits.device)
    gi = torch.arange(B, device=bits.device)
    for p in range(instr.shape[1]):
        row = instr[:, p].to(torch.int64)
        a, z, wa, ba, wz, bz = (row[:, k] for k in range(6))
        valid = row[:, 6] > 0
        vcol = valid[:, None]
        # 1. move bit bz of word wz to bit ba of word wa, in every row
        colz = (bits[gi, :, wz] >> bz[:, None].to(torch.int32)) & 1
        moved = bits[gi, :, wa] | torch.where(colz > 0, BIT[ba][:, None], 0)
        bits[gi, :, wa] = torch.where(vcol, moved, bits[gi, :, wa])
        cleared = bits[gi, :, wz] & ~BIT[bz][:, None]
        bits[gi, :, wz] = torch.where(vcol, cleared, bits[gi, :, wz])
        # 2. OR row z into row a, zero row z
        merged = bits[gi, a] | bits[gi, z]
        bits[gi, a] = torch.where(vcol, merged, bits[gi, a])
        bits[gi, z] = torch.where(vcol, 0, bits[gi, z])
        # 3. a has no bit for its own column; z dies
        own = bits[gi, a, wa] & ~BIT[ba]
        bits[gi, a, wa] = torch.where(valid, own, bits[gi, a, wa])
        alive[gi, z] = torch.where(valid, 0, alive[gi, z]).to(alive.dtype)
