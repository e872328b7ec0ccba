"""The traced window: device events from `torch.profiler` (CUDA activity
only, so the host pays the least for it) and CUDA-event spans around
named functions of the port, installed for the traced window only."""
from __future__ import annotations

import importlib

import torch

NAME_CHARS = 100


class Spans:
    """CUDA events around ``module:function`` attributes of the port (the
    function looked up at call time by its callers) and around what
    `wrap` is given; `seconds` sums each name's device spans."""

    def __init__(self, targets: dict):
        self.events, self._undo = {}, []
        for name, where in targets.items():
            mod, attr = where.split(":")
            m = importlib.import_module(mod)
            orig = getattr(m, attr)
            setattr(m, attr, self.wrap(name, orig))
            self._undo.append((m, attr, orig))

    def wrap(self, name, fn):
        events = self.events.setdefault(name, [])

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events.append((start, end))
            return out
        return timed

    def close(self):
        for m, attr, orig in self._undo:
            setattr(m, attr, orig)
        self._undo = []

    def seconds(self) -> dict:
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in ev) * 1e-3
                for n, ev in self.events.items() if ev}


def start():
    """A profiler whose first step (a warm-up batch) is discarded: it drops
    the device activity of its first moments."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    return prof


def device_events(prof) -> list:
    """``[(name, start_us, end_us)]`` of every kernel, copy and set on the
    device in the active step, by start."""
    from torch.autograd import DeviceType

    out = [(e.name, float(e.time_range.start), float(e.time_range.end))
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(out, key=lambda t: t[1])


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union(events: list) -> list:
    """The busy intervals ``[(start_us, end_us, next name)]``: overlapping
    events merged, each with the name of the event that opened it."""
    out = []
    for name, s, e in events:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, name])
    return out


def breakdown(events: list, busy: list, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the operation that ended it."""
    by = {}
    for name, s, e in events:
        by[name[:NAME_CHARS]] = by.get(name[:NAME_CHARS], 0.0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = [("before " + b[2][:NAME_CHARS], b[0] - a[1])
            for a, b in zip(busy, busy[1:])]
    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    return {"device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": [[n, us * 1e-6] for n, us in gaps]}
