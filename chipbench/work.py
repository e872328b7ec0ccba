"""Operations and bytes, and the chip's peaks: the yardstick's arithmetic.

`flash_pairs` and `flash_work` are frozen copies of the port's
`launch/roofline.py` functions of the same names (one flash call's
operations and bytes), so a change there cannot move this benchmark.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit; each run records the card's limit beside them).
"""
from __future__ import annotations

BF16_FLOPS = 989e12      # bf16 tensor cores, dense
HBM_BYTES = 3.35e12      # HBM3 bandwidth


def flash_pairs(Sq, Sk, causal, window) -> int:
    """The (query, key) pairs the mask lets through, per (b, h): query i
    sees keys [max(0, i - window + 1), min(i, Sk - 1)] when ``causal``
    (``window`` 0: no lower limit), every key otherwise."""
    if not causal:
        return Sq * Sk
    total = 0
    for i in range(Sq):
        hi = min(i, Sk - 1)
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def causal_pairs(s: int) -> int:
    """`flash_pairs` of a square causal call with no window, closed form."""
    return s * (s + 1) // 2


def flash_work(B, H, Hkv, Sq, Sk, D, Dv, itemsize, causal, window) -> tuple:
    """``(operations, bytes)`` of one flash attention call. Operations:
    2·(D + Dv) per visible (query, key) pair (q·k and p·v, a multiply-add
    each). Bytes: q, k (D wide), v and o (Dv wide) read or written once,
    ``itemsize`` bytes an element."""
    pairs = (causal_pairs(Sq) if causal and not window and Sq == Sk
             else flash_pairs(Sq, Sk, causal, window))
    flops = 2 * (D + Dv) * pairs * B * H
    nbytes = (B * H * Sq * (D + Dv) + B * Hkv * Sk * (D + Dv)) * itemsize
    return flops, nbytes


def flash_bound_s(call: tuple, itemsize: int = 2) -> float:
    """The least time of one flash call ``(B, H, Hkv, Sq, Sk, D, Dv,
    causal, window)``: the larger of its operations at the bf16 peak and
    its bytes at the HBM peak."""
    B, H, Hkv, Sq, Sk, D, Dv, causal, window = call
    flops, nbytes = flash_work(B, H, Hkv, Sq, Sk, D, Dv, itemsize, causal,
                               window)
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
