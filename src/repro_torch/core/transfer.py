"""Host↔device transfer accounting for the merge-round device path.

Every dispatch that moves bytes across the host↔device boundary in the
merge hot path — the batched intersection ops and the resident arena's
upload/rank/fold/carry cycle — reports into the module `GLOBAL` counter. A
"round" is one device exchange cycle: one ranking round-trip (a
full-matrix intersection dispatch on the batched path, one fused
rank+Saving call on the resident path). On the batched path the counts
follow the JAX package's ledger entry for entry, so the two byte ledgers
can be held to each other.

Resident counts are attributed to a *phase* — ``init`` (one-time edge and
bank seeding), ``upload`` (host-built workspace state), ``rank``, ``fold``,
``carry`` (root-map replay without a bank), ``candgen``, ``bank``
(adjacency-bank advance instructions), ``extract`` (bank→arena index
slabs) and ``sync`` (verification downloads) — so a bytes regression
localizes to the stage that caused it. With the adjacency bank live,
``upload`` stays zero.

Every crossing is also a fault site (``transfer.h2d``/``transfer.d2h``,
`faults.check`), checked before it is counted.

Thread safety: all mutation happens under one lock, so concurrent sweeps
never lose counts.
"""
from __future__ import annotations

import threading

from repro_torch import faults


class TransferCounter:
    """Byte/round tallies for one device path (monotonic; snapshot+delta).

    All mutators take the instance lock. Reads used for gating go through
    ``snapshot()`` (also locked) so a snapshot is always internally
    consistent.
    """

    __slots__ = ("bytes_h2d", "bytes_d2h", "rounds", "phases", "_lock")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.bytes_h2d = 0
            self.bytes_d2h = 0
            self.rounds = 0
            self.phases = {}

    def _phase_add(self, phase: str | None, nbytes: int):
        if phase is not None:
            self.phases[phase] = self.phases.get(phase, 0) + int(nbytes)

    def add_h2d(self, nbytes: int, phase: str | None = None):
        faults.check("transfer.h2d")
        with self._lock:
            self.bytes_h2d += int(nbytes)
            self._phase_add(phase, nbytes)

    def add_d2h(self, nbytes: int, phase: str | None = None):
        faults.check("transfer.d2h")
        with self._lock:
            self.bytes_d2h += int(nbytes)
            self._phase_add(phase, nbytes)

    def tick_round(self):
        """One device exchange cycle (ranking round-trip) completed."""
        with self._lock:
            self.rounds += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"bytes_h2d": self.bytes_h2d, "bytes_d2h": self.bytes_d2h,
                    "rounds": self.rounds, "phases": dict(self.phases)}

    def delta_since(self, snap: dict, now: dict | None = None) -> dict:
        """Totals accumulated since ``snap`` (up to ``now`` if given — the
        engine's per-iteration breakdown reuses one snapshot as both an
        interval's end and the next one's start), plus bytes/round."""
        cur = self.snapshot() if now is None else now
        d = {k: cur[k] - snap.get(k, 0)
             for k in ("bytes_h2d", "bytes_d2h", "rounds")}
        base = snap.get("phases", {})
        d["phases"] = {k: v - base.get(k, 0)
                       for k, v in cur["phases"].items()}
        total = d["bytes_h2d"] + d["bytes_d2h"]
        d["bytes_total"] = total
        d["bytes_per_round"] = total / d["rounds"] if d["rounds"] else 0.0
        return d


GLOBAL = TransferCounter()
