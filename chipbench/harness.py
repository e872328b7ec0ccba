"""One run of one cell: set-up, the measured window through the port's
serving entry, the reference's check, and the result line.

The window drives `repro_torch.launch.serve.BatchServer.run` in a closed
loop: one batch of ``slots`` prompts of one length, the next handed in
when its answers are back, lengths in the seed's order of the traffic's
cycle. Set-up is everything from the start of the process to the first
timed batch: imports, the kernels' build or load, the weights, the
server and one untimed batch at each length of the cycle.

With ``--trace 1`` one more cycle follows the window, under
`torch.profiler` and with CUDA-event spans, and the line carries the
per-layer metrics: those of the device from the traced cycle, those of
the host clock from the window.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chipbench import compare, schedule, trace, weights

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


# ----------------------------------------------------------------- spec
@dataclasses.dataclass
class Spec:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def family(self):
        return importlib.import_module(
            f"chipbench.reference.{self.config['bench']['reference']}")

    @property
    def adapter(self):
        return importlib.import_module(
            f"chipbench.adapters.{self.config['bench']['reference']}")


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m
            or cell in m["workloads"]]


def load_spec(root: Path, cell: str) -> Spec:
    """The cell's entry of ``BENCHMARK.json`` and the files it names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "chipbench"
    return Spec(
        name=cell, chips=int(w["chips"]),
        config=json.loads((root / entry["file"]).read_text()),
        traffic=schedule.load(here / "traffic" / f"{w['traffic']}.json"),
        limits=json.loads((here / "limits" / f"{cell}.json").read_text()),
        end_to_end=_for_cell(bench["end_to_end"], cell),
        per_layer=_for_cell(bench["per_layer"], cell), root=root)


def reader(root: Path, name: str):
    """The module ``chipbench/metrics/<name>.py`` under ``root``."""
    path = root / "chipbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- window
@dataclasses.dataclass
class Batch:
    length: int
    slots: int
    served: int          # requests answered
    t_hand: float        # host clock when handed to `run`
    t_back: float        # host clock when `run` returned


@dataclasses.dataclass
class Ctx:
    """What a metric reader reads."""
    config: dict
    family: object
    setup_s: float
    batches: list                 # every `Batch` of the window
    window_s: float               # first hand-off to last return
    traced: list = None           # traced: the traced cycle's `Batch`es
    traced_s: float = None        # traced: its first hand-off to last return
    events: list = None           # traced: device (name, start_us, end_us)
    busy_s: float = None          # traced: union of the device events
    spans: dict = None            # traced: {name: device seconds}
    counters: dict = None         # traced: the program's own counters


class Recorder:
    """The server's ``api.prefill`` (the call `run` makes), wrapped: keeps
    the first-token logits of every batch of the window, and the cache of
    the batches to compare, under the batch's index (``-1``: keep
    nothing)."""

    def __init__(self, server):
        self.index, self.cache_too, self.logits, self.caches = -1, False, {}, {}
        self._orig = server.api.prefill
        use_prefill(server, self)

    def __call__(self, *a, **k):
        logits, cache = self._orig(*a, **k)
        if self.index >= 0:
            self.logits[self.index] = logits
            if self.cache_too:
                self.caches[self.index] = cache
        return logits, cache


def use_prefill(server, fn):
    server.api = dataclasses.replace(server.api, prefill=fn)


def smi() -> dict:
    """The card's power limit and SM clock by `nvidia-smi` (empty where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.sm",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30).stdout
        limit, clock = [float(v) for v in out.strip().split(",")[:2]]
        return {"power_limit_w": limit, "sm_clock_mhz": clock}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _drive(server, prompts, order, batches, answers, rec=None, keep=0,
           stop=None):
    """Batches of ``order``'s lengths (cycling), one at a time, until
    ``stop(batches run, host clock)`` holds (by default: once through
    ``order``); answers and `Batch`es appended, the first ``keep`` batches'
    caches kept by ``rec``. Returns the failed requests."""
    from repro_torch.launch.serve import RequestError

    failed, i = 0, 0
    while True:
        n = order[i % len(order)]
        ids = prompts.batch(n)
        if rec is not None:
            rec.index, rec.cache_too = i, i < keep
        ta = time.perf_counter()
        out = server.run(ids, gen_tokens=1)
        tb = time.perf_counter()
        bad = sum(isinstance(a, RequestError) for a in out)
        failed += bad
        batches.append(Batch(n, len(ids), len(ids) - bad, ta, tb))
        answers.append((ids, out))
        i += 1
        if stop(i, tb) if stop else i == len(order):
            break
    if rec is not None:
        rec.index = -1
    return failed


@dataclasses.dataclass
class Run:
    """A run's window, measured: the result line's fields so far, and what
    the check reads (the weights, the compared batches' ids and answers,
    the logits and caches the timed path left)."""
    result: dict
    weights: dict
    answers: list
    logits: dict
    caches: dict
    device: str


def measure(spec: Spec, seed: int, seconds: float, traced: bool,
            device="cuda", t0: float = None) -> Run:
    """Set-up, the window (at least ``seconds``, and at least the compared
    cycles), with ``traced`` one more cycle under the profiler, and the
    metrics; the program's state is freed before it returns."""
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import api as API

    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    marks = {"imported": time.perf_counter() - t0}
    c, tr = spec.config, spec.traffic
    cfg = spec.adapter.port_config(c)
    order = schedule.cycle(tr, seed)
    lengths = sorted(set(order))
    spec.adapter.check(c, cfg, lengths)
    n_cmp = schedule.compared(tr)
    slots, gen = int(tr["slots"]), int(tr["gen_tokens"])
    if gen != 1:
        raise ValueError("the window serves prefill-only requests")

    gen_w = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    W = weights.make(API.abstract_params(cfg), c["bench"]["init"], gen_w,
                     device)
    _sync(device)
    marks["weights"] = time.perf_counter() - t0
    server = BatchServer(cfg, W, batch_slots=slots,
                         max_len=max(lengths) + gen, device=device)
    rec = Recorder(server)
    warm = schedule.Prompts(seed, c["vocab_size"], slots, stream=4)
    for n in lengths:
        server.run(warm.batch(n), gen_tokens=gen)
        marks[f"warm_{n}"] = time.perf_counter() - t0
    _sync(device)
    card = smi() if cuda else {}

    # the window
    batches, answers = [], []
    setup_s = time.perf_counter() - t0
    t_start = time.perf_counter()
    failed = _drive(
        server, schedule.Prompts(seed, c["vocab_size"], slots), order,
        batches, answers, rec, keep=n_cmp,
        stop=lambda i, tb: tb - t_start >= seconds and i >= n_cmp)
    ctx = Ctx(c, spec.family, setup_s, batches, batches[-1].t_back - t_start)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": spec.chips,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda
           else 0, **card}
    result = {}
    if traced:
        _traced_cycle(spec, server, rec, order, seed, ctx)
        dev.update(busy_s=ctx.busy_s, window_s=ctx.traced_s)
        result["breakdown"] = trace.breakdown(ctx.events, trace.union(
            ctx.events))
    metrics = {}
    for m in (spec.per_layer if traced else spec.end_to_end):
        v = reader(spec.root, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    by_len = {}
    for b in batches:
        by_len.setdefault(b.length, []).append(b.t_back - b.t_hand)
    info = {"setup_marks_s": marks, "card_after": smi() if cuda else {},
            "batch_s_by_length": {n: [min(v), float(np.median(v)), max(v)]
                                  for n, v in sorted(by_len.items())},
            "batch_ms": [round((b.t_back - b.t_hand) * 1e3, 2)
                         for b in batches],
            "cycle": order, "batches": len(batches), "compared": n_cmp}
    result.update(attempted=sum(b.slots for b in batches), failed=failed,
                  metrics=metrics, device=dev, info=info)
    logits, caches = rec.logits, rec.caches
    del server, rec
    gc.collect()   # the server's own reference cycles hold its state
    if cuda:
        torch.cuda.empty_cache()
    return Run(result, W, answers, logits, caches, device)


def _traced_cycle(spec, server, rec, order, seed, ctx):
    """One more cycle under the profiler, with CUDA-event spans; fills
    ``ctx``'s traced fields."""
    c, slots = spec.config, int(spec.traffic["slots"])
    prof = trace.start()
    warm = schedule.Prompts(seed, c["vocab_size"], slots, stream=5)
    server.run(warm.batch(min(order)), gen_tokens=1)
    torch.cuda.synchronize()
    prof.step()
    targets = {}
    for m in spec.per_layer:
        targets.update(getattr(reader(spec.root, m["name"]), "SPANS", {}))
    spans = trace.Spans(targets)
    use_prefill(server, spans.wrap("prefill", rec))
    flash0 = _flash_launches()
    batches = []
    _drive(server, warm, order, batches, [])
    torch.cuda.synchronize()
    prof.step()
    prof.stop()
    spans.close()
    ctx.traced = batches
    ctx.traced_s = batches[-1].t_back - batches[0].t_hand
    ctx.events = trace.device_events(prof)
    ctx.busy_s = sum(e - s for s, e, _ in trace.union(ctx.events)) * 1e-6
    ctx.spans = spans.seconds()
    ctx.counters = {"flash_launches": _flash_launches() - flash0}


def compared(spec: Spec, run: Run):
    """Each compared batch against the reference on its ids, in window
    order: yields ``(tokens, reference result, reading)``."""
    from repro_torch.launch.serve import RequestError

    c, fam = spec.config, spec.family
    for i in sorted(run.caches):
        ids, out = run.answers[i]
        logits, cache = run.logits.pop(i), run.caches.pop(i)
        if any(isinstance(a, RequestError) for a in out):
            continue
        tokens = torch.from_numpy(np.stack(ids)).to(run.device)
        s = tokens.shape[1]
        ref = fam.forward(run.weights, c, tokens)
        reading = compare.reading(
            _served(out), logits[:, -1, :c["vocab_size"]].float(),
            {k: (lambda l, t=t: t[l, :, :s])
             for k, t in spec.adapter.cache_views(cache).items()}, ref)
        del cache
        yield tokens, ref, reading
        del ref


def _served(out) -> np.ndarray:
    return np.array([int(a[0]) for a in out])


def own_gaps(spec: Spec, run: Run) -> list:
    """For every answered request of the window: the program's own best
    first-token logit less its logit at the token it served."""
    from repro_torch.launch.serve import RequestError

    gaps = []
    for i, logits in run.logits.items():
        _, out = run.answers[i]
        ok = [j for j, a in enumerate(out) if not isinstance(a, RequestError)]
        lg = logits[ok, -1, :spec.config["vocab_size"]].float()
        gaps += compare.own_gaps(_served([out[j] for j in ok]), lg)
    return gaps


def judge(spec: Spec, run: Run) -> dict:
    """The result line: ``run``'s fields with ``correct`` and ``checks``
    (each number that decides it, beside its limit) last."""
    own = own_gaps(spec, run)
    readings, dropped, pairs = [], 0, 0
    for _, ref, r in compared(spec, run):
        readings.append(r)
        dropped, pairs = dropped + ref["dropped"], pairs + ref["pairs"]
    result, info = run.result, run.result["info"]
    info["dropped_pair_share"] = dropped / pairs if pairs else None
    if readings:
        values = compare.numbers(readings, own)
        ok, checks = compare.verdict(values, spec.limits)
    else:
        values = None
        ok, checks = False, {n: [None, lim] for n, lim in spec.limits.items()}
    info["numbers"] = values
    result["correct"] = bool(ok and result["failed"] == 0)
    result["checks"] = checks
    return result


def run_cell(spec: Spec, seed: int, seconds: float, traced: bool,
             device="cuda", t0: float = None) -> dict:
    """One run: `measure`, then `judge`."""
    return judge(spec, measure(spec, seed, seconds, traced, device, t0))


def _flash_launches() -> int:
    from repro_torch.kernels.flash_attn import kernel as K
    return K.LAUNCHES


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(ROOT, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec.chips:
        print(f"chipbench: {args.workload} needs {spec.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t0=t0)
    bad = banned_modules()
    if bad:
        print(f"chipbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result))
    return 0
