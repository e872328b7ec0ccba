"""The program's own spans and counts (`repro_torch.tracing`) on the
profiler's clock: one more traced cycle after the harness's, and what it
reads.

    PYTHONPATH=src python3 -m chipbench.program_trace --workload <cell> --seed <n> --seconds <s>

from the root of a checkout runs the cell as ``run.py --trace 1`` does,
then one more cycle (prompt stream 6) under a fresh profiler and
`tracing.recording()`, and prints the result line with these added:

- ``breakdown.idle_by_span``: the cycle's device idle seconds, each gap
  charged to the innermost program span open on the host when it opened,
  or ``outside`` when no ``serve.run`` was open;
- ``info.program_spans``: ``{name: [calls, host s, device s, device self
  s]}``; ``info.program_counts``: the counts summed by span and name, the
  kernels' launches, and the prefills' dropped-pair share;
- ``info.tracer_cycle``: that cycle's wall and idle beside the first
  traced cycle's (the tracer's cost when on);
- ``info.clock_check``: for every batch, its first device event against
  its ``serve.upload``'s host start and its last against its
  ``serve.readback``'s host end (µs; both non-negative when the clocks
  agree), on the profiler's device clock and once the events are moved
  onto the host's clock (`on_host_clock`), with the offsets moved by;
- the metrics ``serve_idle_share`` and ``moe_dispatch_share`` (``.ttft``
  in a cell that reports ``ttft_p95_ms``).

Idle time and the shares are read on the host's clock: under load the
profiler's device timestamps drift from the host's by milliseconds over a
cycle (PERF.md), so each batch's device events are pinned to the runtime
calls of its upload and readback copies.

The harness's own cycles, readers and numbers are untouched: the cycle is
added by wrapping `harness._traced_cycle` for this process only.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import gc
import json
import sys
import time

import torch

from chipbench import harness, schedule, trace

SERVE = "serve.run"
TAIL_S = 0.05  # waited before the profiler stops
DISPATCH = ("moe.route", "moe.dispatch", "moe.combine")

# a recorded span with its host interval in the profiler's microseconds
Mapped = collections.namedtuple(
    "Mapped", "id parent name batch start_us end_us device_s counts")


def mapped(record, trace_start_ns: int) -> list:
    """``record``'s spans, their host intervals (epoch ns) moved onto the
    profiler's timeline: µs after its ``trace_start_ns``."""
    return [Mapped(s.id, s.parent, s.name, s.batch,
                   (s.start_ns - trace_start_ns) * 1e-3,
                   (s.end_ns - trace_start_ns) * 1e-3, s.device_s, s.counts)
            for s in record.spans]


def to_us(record, trace_start_ns: int, t: float) -> float:
    """A host `time.perf_counter` reading ``t`` (s) on the profiler's
    timeline, by the record's anchor."""
    perf_ns, epoch_ns = record.anchor
    return (epoch_ns + round(t * 1e9) - perf_ns - trace_start_ns) * 1e-3


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle ``[(start_us, end_us)]`` within ``[lo, hi]`` between the
    busy intervals ``[(start, end, ·)]`` (sorted, disjoint)."""
    out, at = [], lo
    for s, e, _ in busy:
        if e <= at:
            continue
        if s >= hi:
            break
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def idle_by_span(spans: list, busy: list, lo: float, hi: float) -> dict:
    """Idle seconds within ``[lo, hi]`` by the innermost span open on the
    host when each gap opened; ``outside`` when no `SERVE` span was."""
    order = sorted(spans, key=lambda s: s.start_us)
    out, stack, j = {}, [], 0
    for g0, g1 in gaps(busy, lo, hi):
        while j < len(order) and order[j].start_us <= g0:
            while stack and stack[-1].end_us <= order[j].start_us:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1].end_us <= g0:
            stack.pop()
        name = (stack[-1].name if any(s.name == SERVE for s in stack)
                else "outside")
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def serve_idle_share(spans: list, busy: list):
    """100 × the device's idle µs inside the `SERVE` spans' host intervals
    over those intervals' µs; None without such spans or events."""
    runs = [(s.start_us, s.end_us) for s in spans if s.name == SERVE]
    total = sum(e - s for s, e in runs)
    if not runs or not busy or total <= 0:
        return None
    idle = sum(g1 - g0 for s, e in runs for g0, g1 in gaps(busy, s, e))
    return 100.0 * idle / total


def moe_dispatch_share(spans: list):
    """100 × the device seconds of MoE routing, dispatch and combine
    inside the ``serve.prefill`` spans over those spans' device seconds;
    None where the card was not timed or no MoE ran."""
    from repro_torch import tracing

    groups = tracing.within(spans, "serve.prefill")
    prefill = sum(g[0].device_s or 0.0 for g in groups)
    moe = sum(s.device_s or 0.0 for g in groups for s in g
              if s.name in DISPATCH)
    if prefill <= 0 or moe <= 0:
        return None
    return 100.0 * moe / prefill


def clock_check(spans: list, events: list) -> dict:
    """For each `SERVE` span: its first device event's start less its
    ``serve.upload``'s host start, and its ``serve.readback``'s host end
    less its last device event's end (µs), the events of a batch being
    those that start after the previous batch's readback ended."""
    from repro_torch import tracing

    starts = [e[1] for e in events]
    first, last, prev = [], [], float("-inf")
    for g in tracing.within(spans, SERVE):
        up = next(s for s in g if s.name == "serve.upload")
        back = [s for s in g if s.name == "serve.readback"][-1]
        mine = events[bisect.bisect_right(starts, prev):
                      bisect.bisect_right(starts, back.end_us)]
        if mine:
            first.append(mine[0][1] - up.start_us)
            last.append(back.end_us - max(e for _, _, e in mine))
        prev = back.end_us
    return {"batches": len(first), "upload_to_first_us": first,
            "last_to_readback_us": last,
            "min_upload_margin_us": min(first, default=None),
            "min_readback_margin_us": min(last, default=None)}


def copy_calls(prof) -> list:
    """The ``cudaMemcpy*`` runtime calls of the profile, ``[(name,
    start_us, end_us)]`` by start: host-side, on the profiler's host
    clock."""
    from torch.autograd import DeviceType

    out = [(e.name, float(e.time_range.start), float(e.time_range.end))
           for e in prof.events() if e.device_type != DeviceType.CUDA
           and e.name.startswith("cudaMemcpy")]
    return sorted(out, key=lambda t: t[1])


def on_host_clock(spans: list, events: list, calls: list):
    """``events`` moved onto the host's clock batch by batch, and each
    batch's offsets ``[at its upload, at its readback]`` (µs, device less
    host). Each batch's device events run from its upload's host-to-device
    copy to its readback's device-to-host copy; the two copies are pinned
    to the ends of the runtime calls that issued them (the last
    ``cudaMemcpy*`` inside the `serve.upload` and `serve.readback` spans)
    and the times between mapped linearly. ``(events, None)`` where a
    batch lacks either copy or call."""
    from repro_torch import tracing

    outs = [i for i, e in enumerate(events)
            if e[0].startswith("Memcpy DtoH")]
    groups = tracing.within(spans, SERVE)
    if len(outs) != len(groups):
        return events, None
    moved, offsets, first = [], [], 0

    def last_call(span):
        inside = [c for c in calls if span.start_us <= c[1] <= span.end_us]
        return inside[-1] if inside else None

    for g, last in zip(groups, outs):
        seg = events[first:last + 1]
        up = last_call(next(s for s in g if s.name == "serve.upload"))
        back = last_call([s for s in g if s.name == "serve.readback"][-1])
        copy_in = next((e for e in seg if e[0].startswith("Memcpy HtoD")),
                       None)
        if up is None or back is None or copy_in is None:
            return events, None
        a0, a1, h0, h1 = copy_in[1], seg[-1][2], up[2], back[2]
        rate = (h1 - h0) / (a1 - a0)
        moved += [(n, h0 + (s - a0) * rate, h0 + (e - a0) * rate)
                  for n, s, e in seg]
        offsets.append([a0 - h0, a1 - h1])
        first = last + 1
    moved += events[first:]
    return sorted(moved, key=lambda t: t[1]), offsets


def cycle(spec, server, rec, order, seed) -> dict:
    """One more cycle of ``order`` (prompt stream 6) under a fresh profiler
    and `tracing.recording()`, one untimed batch first as the harness's
    traced cycle has; the record on the profiler's clock and what it
    reads."""
    from repro_torch import tracing

    c, slots = spec.config, int(spec.traffic["slots"])
    harness.use_prefill(server, rec)  # the first cycle's CUDA events off
    # the first cycle's profiler leaves ~10^6 objects in reference cycles,
    # whose collection (0.7-0.9 s) would otherwise fall inside this cycle
    gc.collect()
    prof = trace.start()
    prompts = schedule.Prompts(seed, c["vocab_size"], slots, stream=6)
    server.run(prompts.batch(min(order)), gen_tokens=1)
    torch.cuda.synchronize()
    prof.step()
    batches = []
    with tracing.recording() as record:
        harness._drive(server, prompts, order, batches, [])
        torch.cuda.synchronize()
        # the profiler drops device activity stamped after it stops, and
        # under load its device clock runs ahead of the host's (PERF.md)
        time.sleep(TAIL_S)
        prof.step()
    prof.stop()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    raw = trace.device_events(prof)
    spans = mapped(record, t0)
    events, offsets = on_host_clock(spans, raw, copy_calls(prof))
    busy = trace.union(events)
    lo = to_us(record, t0, batches[0].t_hand)
    hi = to_us(record, t0, batches[-1].t_back)
    idle = sum(g1 - g0 for g0, g1 in gaps(busy, lo, hi))
    drops = record.sums_within("serve.prefill", "moe.route", "dropped_pairs")
    pairs = record.sums_within("serve.prefill", "moe.route", "pairs")
    counts = {f"{s}.{n}": v for (s, n), v in record.counts.items()}
    counts.update(launches=record.launches, dropped_pair_share=(
        sum(drops) / sum(pairs) if sum(pairs) else None))
    return {"spans": spans, "events": events, "raw_events": raw,
            "offsets": offsets, "busy": busy,
            "window_us": (lo, hi), "wall_s": (hi - lo) * 1e-6,
            "idle_s": idle * 1e-6, "table": record.table(), "counts": counts}


def add_to_line(result: dict, spec, ctx, prog: dict) -> dict:
    """``result`` (the harness's line) with the fields the module's
    docstring lists."""
    spans, busy = prog["spans"], prog["busy"]
    lo, hi = prog["window_us"]
    by_span = idle_by_span(spans, busy, lo, hi)
    result.setdefault("breakdown", {})["idle_by_span"] = by_span
    info = result["info"]
    info["program_spans"] = prog["table"]
    info["program_counts"] = prog["counts"]
    info["tracer_cycle"] = {
        "first": {"wall_s": ctx.traced_s, "busy_s": ctx.busy_s,
                  "idle_s": ctx.traced_s - ctx.busy_s},
        "second": {"wall_s": prog["wall_s"], "idle_s": prog["idle_s"],
                   "busy_s": prog["wall_s"] - prog["idle_s"],
                   "idle_by_span_sum_s": sum(by_span.values())}}
    offsets = prog["offsets"]
    info["clock_check"] = {
        "device_clock": clock_check(spans, prog["raw_events"]),
        "offsets_us": offsets,
        "on_host_clock": clock_check(spans, prog["events"])
        if offsets else None}
    tail = ".ttft" if any(m["name"] == "ttft_p95_ms"
                          for m in spec.end_to_end) else ""
    for name, value in (("serve_idle_share", serve_idle_share(spans, busy)),
                        ("moe_dispatch_share", moe_dispatch_share(spans))):
        if value is not None:
            result["metrics"][name + tail] = {"value": float(value),
                                              "unit": "%"}
    return result


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = harness.load_spec(harness.ROOT, args.workload)
    if not torch.cuda.is_available():
        print("chipbench.program_trace: needs a CUDA card", file=sys.stderr)
        return 2
    first, held = harness._traced_cycle, {}

    def both(spec, server, rec, order, seed, ctx):
        first(spec, server, rec, order, seed, ctx)
        held["ctx"], held["prog"] = ctx, cycle(spec, server, rec, order,
                                                seed)

    harness._traced_cycle = both
    try:
        result = harness.run_cell(spec, args.seed, args.seconds, True,
                                  device="cuda", t0=t0)
    finally:
        harness._traced_cycle = first
    print(json.dumps(add_to_line(result, spec, held["ctx"], held["prog"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
