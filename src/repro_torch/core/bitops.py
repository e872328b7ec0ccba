"""Shared bit-twiddling helpers for the merge engines.

``np.bitwise_count`` only exists on NumPy >= 2.0; every popcount consumer
(the per-group ranking and the host rank source of the batched engine) goes
through :func:`popcount` so older NumPy falls back to
a SWAR sequence.
"""
from __future__ import annotations

import numpy as np

_HAS_NATIVE = hasattr(np, "bitwise_count")


def popcount_swar(x: np.ndarray) -> np.ndarray:
    """SWAR per-element popcount for uint32/uint64 arrays (uint8 result)."""
    x = np.asarray(x)
    if x.dtype == np.uint64:
        one, two, four = np.uint64(1), np.uint64(2), np.uint64(4)
        x = x - ((x >> one) & np.uint64(0x5555555555555555))
        x = (x & np.uint64(0x3333333333333333)) + ((x >> two) & np.uint64(0x3333333333333333))
        x = (x + (x >> four)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(np.uint8)
    if x.dtype == np.uint32:
        one, two, four = np.uint32(1), np.uint32(2), np.uint32(4)
        x = x - ((x >> one) & np.uint32(0x55555555))
        x = (x & np.uint32(0x33333333)) + ((x >> two) & np.uint32(0x33333333))
        x = (x + (x >> four)) & np.uint32(0x0F0F0F0F)
        return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.uint8)
    raise TypeError(f"popcount_swar expects uint32/uint64, got {x.dtype}")


def popcount(x: np.ndarray) -> np.ndarray:
    """Per-element popcount: native ``np.bitwise_count`` when available."""
    if _HAS_NATIVE:
        return np.bitwise_count(x)
    return popcount_swar(x)
