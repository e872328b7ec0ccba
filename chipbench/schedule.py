"""The general traffic generator: a closed loop of prefill-only batches.

A traffic file gives ``slots`` (requests a batch), ``gen_tokens``,
``lengths`` (``[[length, batches], ...]``: the multiset of one cycle) and
``compare_cycles`` (every batch of that many first cycles of the window
is compared with the reference). The seed permutes the cycle and draws
the token ids; it never changes the multiset, so every seed does the
same work a cycle.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

KEYS = {"slots", "gen_tokens", "lengths", "compare_cycles"}


def load(path: Path) -> dict:
    t = json.loads(Path(path).read_text())
    missing = KEYS - set(t)
    if missing:
        raise ValueError(f"{path}: missing {sorted(missing)}")
    return t


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def cycle(traffic: dict, seed: int) -> list:
    """One cycle's prompt lengths, in the seed's order."""
    lengths = [int(n) for n, k in traffic["lengths"] for _ in range(int(k))]
    order = _rng(seed, 1).permutation(len(lengths))
    return [lengths[i] for i in order]


def compared(traffic: dict) -> int:
    """How many first batches of the window are compared: whole cycles."""
    n = sum(int(k) for _, k in traffic["lengths"])
    return int(traffic["compare_cycles"]) * n


class Prompts:
    """Token ids uniform over ``[0, vocab)``, a batch at a time, from one
    of the seed's streams (the window's, or set-up's warm-up)."""

    def __init__(self, seed: int, vocab: int, slots: int, stream: int = 3):
        self.rng, self.vocab, self.slots = _rng(seed, stream), vocab, slots

    def batch(self, length: int) -> list:
        ids = self.rng.integers(0, self.vocab, size=(self.slots, length),
                                dtype=np.int64)
        return list(ids)
