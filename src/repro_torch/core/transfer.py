"""Host↔device transfer accounting for the merge-round device path.

Every dispatch that moves bytes across the host↔device boundary in the
merge hot path — the batched intersection ops — reports into the module
`GLOBAL` counter. A "round" is one device exchange cycle: one ranking
round-trip (a full-matrix intersection dispatch). The counts follow the
JAX package's ledger entry for entry, so the two byte ledgers can be held
to each other.

Thread safety: all mutation happens under one lock, so concurrent sweeps
never lose counts.
"""
from __future__ import annotations

import threading


class TransferCounter:
    """Byte/round tallies for one device path (monotonic; snapshot+delta).

    All mutators take the instance lock. Reads used for gating go through
    ``snapshot()`` (also locked) so a snapshot is always internally
    consistent.
    """

    __slots__ = ("bytes_h2d", "bytes_d2h", "rounds", "_lock")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.bytes_h2d = 0
            self.bytes_d2h = 0
            self.rounds = 0

    def add_h2d(self, nbytes: int):
        with self._lock:
            self.bytes_h2d += int(nbytes)

    def add_d2h(self, nbytes: int):
        with self._lock:
            self.bytes_d2h += int(nbytes)

    def tick_round(self):
        """One device exchange cycle (ranking round-trip) completed."""
        with self._lock:
            self.rounds += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"bytes_h2d": self.bytes_h2d, "bytes_d2h": self.bytes_d2h,
                    "rounds": self.rounds}

    def delta_since(self, snap: dict, now: dict | None = None) -> dict:
        """Totals accumulated since ``snap`` (up to ``now`` if given — the
        engine's per-iteration breakdown reuses one snapshot as both an
        interval's end and the next one's start), plus bytes/round."""
        cur = self.snapshot() if now is None else now
        d = {k: cur[k] - snap.get(k, 0)
             for k in ("bytes_h2d", "bytes_d2h", "rounds")}
        total = d["bytes_h2d"] + d["bytes_d2h"]
        d["bytes_total"] = total
        d["bytes_per_round"] = total / d["rounds"] if d["rounds"] else 0.0
        return d


GLOBAL = TransferCounter()
