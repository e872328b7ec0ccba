"""The port's own spans and counts, off unless a recording is open.

    from repro_torch import tracing

    with tracing.recording() as rec:
        server.run(prompts, gen_tokens=1)
    rec.table()      # {name: [calls, host s, device s, device self s]}

`span(name)` marks a stretch of code, `add(name, value)` puts a count on
the innermost open span. Off, `span` returns one shared no-op and `add`
returns at once: no allocation, no clock read, no CUDA call. On, a span
keeps its host interval (`time.perf_counter_ns`) and, where the recording
times the card, a pair of CUDA events on the current stream. Nothing
synchronises until the recording closes: then one synchronize reads every
event and one read-back every count held in a device tensor.

Only the thread that opened the recording is traced; spans opened on other
threads (autograd's device thread under remat) are the no-op. The record
keeps no file: its owner writes out what it needs.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time

import torch

BATCH = "serve.run"  # the span whose id the spans within it carry as batch
# kernel modules whose module-level ``*LAUNCHES`` counters a record reads
KERNELS = ("flash_attn", "bitset_jaccard", "bitset_fold", "seghist",
           "interval_expand", "minhash")

_active = None  # the open `Record`


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One recorded span. Once its recording closes: ``start_ns`` and
    ``end_ns`` on the host in epoch nanoseconds, ``device_s`` and
    ``self_s`` (less its children's) from its CUDA events (None without),
    ``counts`` ``{name: int}``; ``batch`` is the enclosing `BATCH` span's
    id."""

    __slots__ = ("id", "parent", "name", "batch", "start_ns", "end_ns",
                 "device_s", "self_s", "counts", "_rec", "_ev")

    def __init__(self, rec, name):
        self._rec, self.name, self.counts = rec, name, []
        self.device_s = self.self_s = self._ev = None

    def __enter__(self):
        rec = self._rec
        top = rec._stack[-1] if rec._stack else None
        self.id, self.parent = len(rec.spans), top and top.id
        self.batch = self.id if self.name == BATCH else top and top.batch
        rec.spans.append(self)
        rec._stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if rec.cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        return self

    def __exit__(self, *exc):
        if self._ev:
            self._ev[1].record()
        self.end_ns = time.perf_counter_ns()
        self._rec._stack.pop()
        return False


class Record:
    """What one `recording` saw: ``spans`` in the order they opened,
    ``counts`` ``{(span name, count name): sum}``, ``launches`` the
    change of each kernel counter, ``anchor`` (perf_counter_ns, time_ns)
    read together."""

    def __init__(self, cuda: bool):
        self.cuda, self.thread = cuda, threading.get_ident()
        self.spans, self._stack = [], []
        self.counts, self.launches = {}, {}

    def _close(self, launches0: dict):
        if self.cuda:
            torch.cuda.synchronize()
        shift = self.anchor[1] - self.anchor[0]
        for s in self.spans:
            s.start_ns, s.end_ns = s.start_ns + shift, s.end_ns + shift
            if s._ev:
                s.device_s = s.self_s = s._ev[0].elapsed_time(s._ev[1]) * 1e-3
                s._ev = None
        for s in self.spans:
            if s.parent is not None and s.device_s is not None:
                self.spans[s.parent].self_s -= s.device_s
        held = [(s, n, v) for s in self.spans for n, v in s.counts]
        by_device = {}
        for i, (_, _, v) in enumerate(held):
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(i)
        values = [v for _, _, v in held]
        for idx in by_device.values():
            read = torch.stack([held[i][2].reshape(()).to(torch.int64)
                                for i in idx]).tolist()
            for i, v in zip(idx, read):
                values[i] = v
        for s in self.spans:
            s.counts = {}
        for (s, n, _), v in zip(held, values):
            s.counts[n] = s.counts.get(n, 0) + int(v)
            key = (s.name, n)
            self.counts[key] = self.counts.get(key, 0) + int(v)
        self.launches = {k: v - launches0.get(k, 0)
                         for k, v in _launches().items()
                         if v != launches0.get(k, 0)}

    def table(self) -> dict:
        """``{name: [calls, host s, device s, device self s]}`` (the
        device columns None where the card was not timed)."""
        out = {}
        for s in self.spans:
            row = out.setdefault(s.name, [0, 0.0, None, None])
            row[0] += 1
            row[1] += (s.end_ns - s.start_ns) * 1e-9
            if s.device_s is not None:
                row[2] = (row[2] or 0.0) + s.device_s
                row[3] = (row[3] or 0.0) + s.self_s
        return out

    def sums_within(self, outer: str, name: str, count: str) -> list:
        """For each span named ``outer``: ``count`` summed over the spans
        named ``name`` inside it (each prefill's dropped pairs)."""
        return [sum(s.counts.get(count, 0) for s in g if s.name == name)
                for g in within(self.spans, outer)]


def within(spans, outer: str) -> list:
    """For each span named ``outer`` in ``spans`` (in the order they
    opened; anything with ``id``, ``parent`` and ``name``): it and the
    spans opened inside it."""
    groups, group_of = [], {}
    for s in spans:
        if s.name == outer:
            group_of[s.id] = len(groups)
            groups.append([s])
        elif s.parent in group_of:
            group_of[s.id] = group_of[s.parent]
            groups[group_of[s.id]].append(s)
    return groups


def _launches() -> dict:
    """Each loaded kernel module's ``*LAUNCHES`` counters by
    ``<kernel>.<counter>``."""
    out = {}
    for k in KERNELS:
        mod = sys.modules.get(f"repro_torch.kernels.{k}.kernel")
        if mod is None:
            continue
        for attr, v in vars(mod).items():
            if attr.endswith("LAUNCHES") and isinstance(v, int):
                out[f"{k}.{attr}"] = v
    return out


def span(name: str):
    """A context manager marking ``name``: the no-op unless a recording
    is open on this thread."""
    rec = _active
    if rec is None or rec.thread != threading.get_ident():
        return OFF
    return Span(rec, name)


def add(name: str, value):
    """Adds ``value`` (an int or a 0-d integer tensor, kept as it is: no
    sync) to the count ``name`` of the innermost open span."""
    rec = _active
    if rec is None or rec.thread != threading.get_ident() or not rec._stack:
        return
    rec._stack[-1].counts.append((name, value))


@contextlib.contextmanager
def recording():
    """Traces the calling thread while open and yields its `Record`,
    filled when it closes; where a card is available its spans are timed
    on it by CUDA events too."""
    global _active
    if _active is not None:
        raise RuntimeError("a tracing recording is already open")
    rec = Record(torch.cuda.is_available())
    launches0 = _launches()
    # the one wall-clock read: it places the monotonic span times on the
    # epoch, where the profiler's timeline (trace_start_ns) lies
    rec.anchor = (time.perf_counter_ns(), time.time_ns())
    _active = rec
    try:
        yield rec
    finally:
        _active = None
    rec._close(launches0)
