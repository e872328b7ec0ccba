"""Fault tolerance and straggler accounting for the training loop (the JAX
package's `train/fault_tolerance.py`).

  * checkpoint/restart: periodic async checkpoints, atomic commit, bit-exact
    resume (the data pipeline is pure in (seed, step), so replay repeats)
  * step retry: a step that fails before its update is retried on the
    same in-memory state; one that keeps failing, or that fails DURING
    its update, restores the last checkpoint
  * straggler watch: a per-step deadline from a running median; a breach
    is recorded and handed to an injectable hook

The reference retries from "the last good in-memory state", which its
functional step never touches. The port's step updates parameters and
moments in place (`optim/adamw.apply_updates`): a failure before the
update leaves the state whole, so it is retried in memory; a failure
during it, or during the ZeRO-1 parameter gather after it (on a data or
a model axis), raises `adamw.TornUpdate`, which is never retried in
memory but goes straight to ``restore_fn``, since a retry would build on
a half updated state.
"""
from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.optim.adamw import TornUpdate

log = logging.getLogger("repro_torch.ft")


@dataclass
class FaultToleranceConfig:
    ckpt_every: int = 50
    max_retries: int = 2
    straggler_factor: float = 3.0
    min_history: int = 5


@dataclass
class StragglerWatch:
    factor: float = 3.0
    min_history: int = 5
    times: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Record step ``step``'s ``dt`` seconds; True when it took more
        than ``factor`` times the median of the last 50 (after
        ``min_history`` steps)."""
        is_straggler = False
        if len(self.times) >= self.min_history:
            med = statistics.median(self.times[-50:])
            if dt > self.factor * med:
                self.events.append({"step": step, "dt": dt, "median": med})
                is_straggler = True
        self.times.append(dt)
        return is_straggler


class ResilientLoop:
    """Wraps a step function with retry, checkpoints and straggler
    accounting. ``failures`` records each failure: ``{"step", "error",
    "action"}``, ``action`` ``"retry"`` (with ``"attempt"``) or
    ``"restore"``."""

    def __init__(self, step_fn: Callable, state, make_batch: Callable,
                 checkpointer=None,
                 ft: FaultToleranceConfig = FaultToleranceConfig(),
                 on_straggler: Optional[Callable] = None,
                 restore_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        self.state = state
        self.make_batch = make_batch
        self.ckpt = checkpointer
        self.ft = ft
        self.watch = StragglerWatch(ft.straggler_factor, ft.min_history)
        self.on_straggler = on_straggler
        self.restore_fn = restore_fn
        self.failures: list = []

    def run(self, start_step: int, num_steps: int, metrics_cb=None):
        """Steps ``start_step`` .. ``start_step + num_steps − 1``; returns
        (state, the step reached). A checkpoint is submitted every
        ``ft.ckpt_every`` steps and at the end."""
        step = start_step
        while step < start_step + num_steps:
            batch = self.make_batch(step)
            t0 = time.monotonic()
            try:
                self.state, metrics = self._attempt(self.state, batch, step)
            except Exception as e:
                # persistent, or torn: restore the last checkpoint, replay
                self.failures.append({"step": step, "error": repr(e),
                                      "action": "restore"})
                if self.restore_fn is None:
                    raise
                state, restored_step = self.restore_fn()
                if state is None:
                    raise RuntimeError(f"step {step} failed and there is "
                                       f"no checkpoint to restore") from e
                self.state = state
                log.warning("step %d failed (%r); restored step %s", step,
                            e, restored_step)
                step = restored_step
                continue
            dt = time.monotonic() - t0
            if self.watch.observe(step, dt) and self.on_straggler:
                self.on_straggler(step, dt)
            if metrics_cb:
                metrics_cb(step, metrics)
            step += 1
            if self.ckpt is not None and step % self.ft.ckpt_every == 0:
                self.ckpt.submit(self.state, step)
        if self.ckpt is not None:
            self.ckpt.submit(self.state, step)
            self.ckpt.wait()
        return self.state, step

    def _attempt(self, state, batch, step):
        last = None
        for attempt in range(self.ft.max_retries + 1):
            try:
                return self.step_fn(state, batch)
            except TornUpdate:
                raise  # the state is half updated: no retry builds on it
            except Exception as e:  # transient: retry on the same state
                last = e
                self.failures.append({"step": step, "attempt": attempt,
                                      "error": repr(e), "action": "retry"})
                log.warning("step %d attempt %d failed: %r", step, attempt,
                            e)
        raise last
