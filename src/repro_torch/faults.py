"""Deterministic fault injection and the degradation ledger (DESIGN.md §11).

Crash safety needs killable code paths: tests, the chaos driver
(`launch/chaos.py`) and the card's smoke run stop the summarizer at an
exact, reproducible point and prove that the checkpoint resume restores a
bit-identical run, and that a failed kernel dispatch or adjacency bank
degrades to a path that finishes the same summary. `FaultPlan` is that
kill switch: a declarative (site, iteration, hit) trigger that raises
`InjectedFault` from an instrumented site, armed by the `inject` context
manager or by the ``REPRO_FAULTS`` environment variable. The sites, the
variable and its syntax are the JAX package's, so one spec means the same
thing to both packages.

Instrumented sites (each calls ``faults.check(site, ...)``):

================================  =========================================
site                              where
================================  =========================================
``engine.shingle`` … ``engine.exchange``
                                  each stage boundary of
                                  `core.engine.SummarizerEngine` (the check
                                  runs AFTER the stage, so a kill lands
                                  between stages, before the iteration's
                                  checkpoint commits)
``kernel.bitset_fold.<op>``       the device ops in
``kernel.bitset_jaccard.<op>``    `kernels/*/ops.py` (checked BEFORE any
                                  device work, so the resident state is
                                  intact and a retry is safe)
``resident.bank.extract``         `ResidentBitmapArena.from_bank`
``resident.bank.advance``         `ResidentAdjacencyBank.advance_batches`
``transfer.h2d`` / ``transfer.d2h``
                                  every accounted host↔device crossing
                                  (`core.transfer.TransferCounter`)
``datasets.fetch``                the download attempt in
                                  `graphs.datasets.fetch`
================================  =========================================

Site matching is exact, or by prefix when the pattern ends with ``"."``
(``"kernel."`` matches every kernel dispatch). The variable's syntax is
``site[@iteration][#hit]``, e.g. ``REPRO_FAULTS=engine.merge_round@3`` or
``REPRO_FAULTS=kernel.#5``.

The module also owns the degradation ledger: every graceful fallback (a
kernel op retried on its plain version, a rank dispatch dropped for the
host popcount, the adjacency bank dropped for host-built workspaces) is
recorded here; the engine marks the ledger at the start of a run and
reports the events since as ``engine.stats["degradations"]``. Everything
is thread-safe: merge-round thunks run on a pool.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager

import numpy as np

ENV_VAR = "REPRO_FAULTS"

STAGE_SITES = ("engine.shingle", "engine.group", "engine.pack",
               "engine.merge_round", "engine.exchange")


class InjectedFault(RuntimeError):
    """A deterministic fault fired by an active `FaultPlan`."""

    def __init__(self, site: str, iteration=None, hit: int = 0):
        self.site = site
        self.iteration = iteration
        self.hit = hit
        where = f"site={site!r}"
        if iteration is not None:
            where += f" iteration={iteration}"
        super().__init__(f"injected fault at {where} (hit {hit})")


class BankFault(RuntimeError):
    """A failure on the resident adjacency-bank path, wrapped so the engine
    can tell it apart and degrade to host-built workspaces for the rest of
    the run (DESIGN.md §11)."""


class FaultPlan:
    """Deterministic fault schedule: raise at the ``hit``-th occurrence of a
    matching ``(site, iteration)``.

    * ``site`` — exact site name, or a prefix ending in ``"."``.
    * ``iteration`` — only occurrences carrying this iteration match
      (``None`` matches any, including sites that report no iteration).
    * ``hit`` — fire on the N-th matching occurrence (1-based).
    * ``times`` — how many firings before the plan disarms (default 1, so
      a degradation retry of the same site succeeds).
    """

    def __init__(self, site: str, iteration=None, hit: int = 1,
                 times: int = 1):
        if not site:
            raise ValueError("FaultPlan needs a non-empty site")
        self.site = str(site)
        self.iteration = None if iteration is None else int(iteration)
        self.hit = max(1, int(hit))
        self.times = max(1, int(times))
        self._lock = threading.Lock()
        self._seen = 0
        self._fired = 0

    @classmethod
    def seeded(cls, seed: int, sites=STAGE_SITES, iterations: int = 5,
               times: int = 1) -> "FaultPlan":
        """Pick a (site, iteration) deterministically from ``seed``: same
        seed, same kill point, every run, in both packages."""
        rng = np.random.default_rng(np.random.SeedSequence((int(seed),
                                                            0xFA17)))
        site = sites[int(rng.integers(0, len(sites)))]
        iteration = int(rng.integers(1, max(int(iterations), 1) + 1))
        return cls(site, iteration=iteration, times=times)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse the variable's syntax ``site[@iteration][#hit]``."""
        spec = spec.strip()
        hit = 1
        if "#" in spec:
            spec, _, h = spec.partition("#")
            hit = int(h)
        iteration = None
        if "@" in spec:
            spec, _, it = spec.partition("@")
            iteration = int(it)
        return cls(spec, iteration=iteration, hit=hit)

    def _matches(self, site: str, iteration) -> bool:
        if self.site.endswith("."):
            if not site.startswith(self.site):
                return False
        elif site != self.site:
            return False
        return self.iteration is None or iteration == self.iteration

    def note(self, site: str, iteration=None):
        """Record one occurrence; raise `InjectedFault` when it is the one."""
        if not self._matches(site, iteration):
            return
        with self._lock:
            if self._fired >= self.times:
                return
            self._seen += 1
            if self._seen < self.hit:
                return
            self._fired += 1
            self._seen = 0  # re-arm the hit counter for times > 1
            hit = self.hit
        raise InjectedFault(site, iteration=iteration, hit=hit)

    def __repr__(self):
        return (f"FaultPlan(site={self.site!r}, iteration={self.iteration}, "
                f"hit={self.hit}, times={self.times})")


# --------------------------------------------------------------- activation
_lock = threading.Lock()
_plans: list = []          # context-manager plans (innermost last)
_env_plan = None           # FaultPlan parsed from $REPRO_FAULTS, or None
_armed = False             # fast-path gate read without the lock


def _rearm():
    global _armed
    _armed = bool(_plans) or _env_plan is not None


def install_env_plan(env=os.environ):
    """(Re)read ``$REPRO_FAULTS``: called at import, and by callers that
    set the variable later."""
    global _env_plan
    spec = env.get(ENV_VAR, "").strip()
    with _lock:
        _env_plan = FaultPlan.from_spec(spec) if spec else None
        _rearm()
    return _env_plan


def check(site: str, iteration=None):
    """Fault-injection hook: a no-op unless a plan is armed (one module
    bool read), else every active plan gets a chance to fire."""
    if not _armed:
        return
    with _lock:
        active = list(_plans) + ([_env_plan] if _env_plan is not None else [])
    for plan in active:
        plan.note(site, iteration=iteration)


@contextmanager
def inject(plan, iteration=None, hit: int = 1, times: int = 1):
    """Arm a `FaultPlan` (or build one from a site string) for the body."""
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan(plan, iteration=iteration, hit=hit, times=times)
    with _lock:
        _plans.append(plan)
        _rearm()
    try:
        yield plan
    finally:
        with _lock:
            _plans.remove(plan)
            _rearm()


# ---------------------------------------------------------------- ledger
class DegradationLog:
    """Thread-safe append-only record of every graceful fallback."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list = []

    def record(self, site: str, detail) -> None:
        with self._lock:
            self._events.append({"site": site, "detail": repr(detail)})

    def count(self) -> int:
        with self._lock:
            return len(self._events)

    def events_since(self, mark: int) -> list:
        with self._lock:
            return list(self._events[mark:])


DEGRADATIONS = DegradationLog()

install_env_plan()
