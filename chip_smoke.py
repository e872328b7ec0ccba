#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SLUGGER (`src/repro_torch`) once on one
CUDA card, and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each printing one JSON line with its seconds:

  device   the card's name and count, and its power limit from nvidia-smi
  build    the CUDA kernels built from `src/repro_torch/csrc` (nvcc, sm_90a)
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes the main path gives it: exact equality, CUDA-event times
           of the kernel, the plain version and a one-call PyTorch yardstick
  main     `summarize(caveman(20000, 11, 0.03), backend="batched")` — the
           1.1M-edge graph at T=20 — lossless, with both kernels' launch
           counts read from a run that started them at 0
  parity   the host oracle `backend="numpy"` on the same graph, and both
           backends on `rmat(14, 8)`: parent and edges equal bit for bit
  trace    the main path once more under `torch.profiler`: device busy
           time by kernel and copy against the run's wall time

The line before the last is the per-kernel record; its times are the sums
over every call the main path made (distinct shapes timed once each,
weighted by their call counts). The last line is
``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero without that line. Without a card, or outside a checkout,
it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
# Results per SM per clock on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): 32-bit integer add, compare
# and bitwise AND issue on 64 lanes, 32-bit population count on 16. The
# rates below multiply these by the card's SM count and its maximum SM
# clock, both read from the card (`card_rates`).
INT32_LANES_PER_SM = 64
POPC_LANES_PER_SM = 16

INTER_SHAPES = [(64, g, w, 64) for g in (8, 16, 32, 64, 128)
                for w in (8, 64, 256)] + [(64, 16, 8, 37)]
HIST_SHAPES = [((1 << 17), (1 << 18)), ((1 << 20), (1 << 15))]


def emit(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0,
                      **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, after a
    warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- inputs/bounds
def inter_input(B, G, W, rng):
    import numpy as np
    import torch

    words = rng.integers(0, 1 << 32, size=(B, G, W), dtype=np.uint64)
    words[0, 0, :] = 0xFFFFFFFF  # all-ones words
    return torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda()


def card_rates():
    """Peak 32-bit integer and popcount rates of card 0: lanes per SM times
    its SM count times its maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])
    return {"sms": sms, "sm_clock_max_mhz": mhz,
            "int32_ops_per_s": INT32_LANES_PER_SM * sms * mhz * 1e6,
            "popc_per_s": POPC_LANES_PER_SM * sms * mhz * 1e6,
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def inter_bound_s(B, G, W, valid, rates):
    """Rows ``b >= valid`` are neither read nor needed; the whole (B, G, G)
    output is written. Each of the valid*G*G*W word pairs takes one AND and
    one ADD on the integer lanes and one POPC on its own unit; the two
    issue side by side, so the slower of them bounds."""
    by_bytes = (valid * G * W * 4 + B * G * G * 4) / rates["hbm_bytes_per_s"]
    pairs = valid * G * G * W
    by_ops = max(2 * pairs / rates["int32_ops_per_s"],
                 pairs / rates["popc_per_s"])
    return by_bytes, by_ops


def hist_input(E, S, rng):
    import numpy as np
    import torch

    ids = rng.integers(0, S, size=E).astype(np.int32)
    ids[rng.random(E) < 0.25] = -1  # padding
    return torch.from_numpy(ids).cuda()


def hist_bound_s(ids, S, rates):
    """Every id is read and range-checked (two compares), each valid one
    adds one; the (S,) output is written once."""
    E = int(ids.numel())
    n_valid = int((ids >= 0).sum())
    return ((E * 4 + S * 4) / rates["hbm_bytes_per_s"],
            (2 * E + n_valid) / rates["int32_ops_per_s"])


def inter_library(bits):
    """One bmm over the bits unpacked to 0/1 in fp16 (exact products and
    fp32 accumulation; the unpacking is set-up, not timed)."""
    import torch

    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    B, G, W = bits.shape
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    unpacked = ((bits[..., None] >> shifts) & 1).reshape(B, G, W * 32)
    a = unpacked.to(torch.float16)
    at = a.transpose(1, 2).contiguous()
    return lambda: torch.bmm(a, at)


# ---------------------------------------------------------------------- phases
def phase_device():
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    rates = card_rates()
    emit("device", t0, **dev, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, rates=rates)
    return dev, smi.splitlines()[0], rates


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library(rebuild=True)
    emit("build", t0, **_build.BUILD_INFO)


def phase_kernels(rng, rates):
    import torch

    from repro_torch.kernels.bitset_jaccard import kernel as K1, ref as R1
    from repro_torch.kernels.seghist import kernel as K2, ref as R2

    t0 = time.perf_counter()
    rows = []
    for B, G, W, valid in INTER_SHAPES:
        x = inter_input(B, G, W, rng)
        got = K1.bitset_intersections(x, valid)
        want = R1.bitset_intersections(x, valid)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise AssertionError(f"bitset_intersections {B, G, W, valid}: "
                                 f"max |kernel − plain| = {err}")
        lib = inter_library(x)
        bb, bo = inter_bound_s(B, G, W, valid, rates)
        rows.append({
            "kernel": "bitset_intersections", "shape": [B, G, W],
            "valid": valid, "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: K1.bitset_intersections(x, valid), 50),
            "plain_ms": cuda_ms(lambda: R1.bitset_intersections(x, valid), 3),
            "library_ms": cuda_ms(lib, 20),
            "bound_us": max(bb, bo) * 1e6,
            "bound_by": "bytes" if bb >= bo else "operations"})
    for E, S in HIST_SHAPES:
        ids = hist_input(E, S, rng)
        got = K2.segment_histogram(ids, S)
        want = R2.segment_histogram(ids, S)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err:
            raise AssertionError(f"segment_histogram {E, S}: max |kernel − "
                                 f"plain| = {err}")
        valid_ids = ids[ids >= 0].to(torch.int64)
        bb, bo = hist_bound_s(ids, S, rates)
        rows.append({
            "kernel": "segment_histogram", "shape": [E, S],
            "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: K2.segment_histogram(ids, S), 50),
            "plain_ms": cuda_ms(lambda: R2.segment_histogram(ids, S), 10),
            "library_ms": cuda_ms(
                lambda: torch.bincount(valid_ids, minlength=S), 10),
            "bound_us": max(bb, bo) * 1e6,
            "bound_by": "bytes" if bb >= bo else "operations"})
    emit("kernels", t0, results=rows)


class CallRecorder:
    """Records the shapes (and the histogram's ids) of every kernel call the
    main path makes, by wrapping the names the ops modules call. The
    kernels' own launch counters are untouched by it."""

    def __init__(self):
        from repro_torch.kernels.bitset_jaccard import ops as O1
        from repro_torch.kernels.seghist import ops as O2

        self.O1, self.O2 = O1, O2
        self.inter = Counter()
        self.hist: list = []
        self._orig = (O1.bitset_intersections, O2.segment_histogram)

        def inter(bits, valid, _f=self._orig[0]):
            self.inter[(*bits.shape, int(valid))] += 1
            return _f(bits, valid)

        def hist(ids, S, _f=self._orig[1]):
            self.hist.append((ids.clone(), int(S)))
            return _f(ids, S)

        O1.bitset_intersections, O2.segment_histogram = inter, hist

    def close(self):
        self.O1.bitset_intersections, self.O2.segment_histogram = self._orig


def phase_main(graph):
    import torch

    import repro_torch
    from repro_torch.core.transfer import GLOBAL as TRANSFER
    from repro_torch.kernels.bitset_jaccard import kernel as K1
    from repro_torch.kernels.seghist import kernel as K2

    t0 = time.perf_counter()
    recorder = CallRecorder()
    torch.cuda.reset_peak_memory_stats()
    TRANSFER.reset()
    K1.LAUNCHES = 0
    K2.LAUNCHES = 0
    try:
        engine = repro_torch.SummarizerEngine(backend="batched", T=20,
                                              device="cuda")
        tw = time.perf_counter()
        summary = engine.run(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    finally:
        recorder.close()
    launches = {"bitset_intersections": K1.LAUNCHES,
                "segment_histogram": K2.LAUNCHES}
    transfer = TRANSFER.snapshot()
    lossless = summary.validate_lossless(graph)
    if not lossless:
        raise AssertionError("batched summary does not decompress to the "
                             "input graph")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    emit("main", t0, graph={"n": graph.n, "m": graph.m}, T=20,
         wall_seconds=wall, lossless=lossless, merges=engine.stats["merges"],
         cost=summary.cost(), relative_size=summary.relative_size(graph),
         launches=launches, transfer=transfer,
         stage_seconds={k: engine.stats[k] for k in (
             "shingle", "group", "pack", "merge_round", "exchange", "emit",
             "prune")},
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         distinct_intersection_shapes=len(recorder.inter),
         intersection_calls_by_shape=sorted(
             [[*shape, n] for shape, n in Counter(
                 k[:3] for k in recorder.inter.elements()).items()],
             key=lambda r: -r[-1]),
         histogram_calls=[[int(i.numel()), s] for i, s in recorder.hist])
    return summary, launches, recorder


def phase_parity(graph, batched):
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.graphs import generators as GG

    t0 = time.perf_counter()
    checks = []

    def timed(g, backend):
        tw = time.perf_counter()
        s = repro_torch.summarize(g, backend=backend, device="cuda")
        torch.cuda.synchronize()
        return s, time.perf_counter() - tw

    def same(a, b, what, walls):
        ok = (np.array_equal(a.parent, b.parent)
              and np.array_equal(a.edges, b.edges))
        checks.append({"case": what, "equal": ok, "wall_seconds": walls})
        if not ok:
            raise AssertionError(f"{what}: batched and numpy summaries differ")

    host, host_wall = timed(graph, "numpy")
    same(batched, host, "caveman(20000, 11, 0.03) T=20",
         {"numpy": host_wall})
    g2 = GG.rmat(14, 8, seed=0)
    b2, b2_wall = timed(g2, "batched")
    h2, h2_wall = timed(g2, "numpy")
    if not b2.validate_lossless(g2):
        raise AssertionError("rmat(14, 8) batched summary is not lossless")
    same(b2, h2, "rmat(14, 8) T=20", {"batched": b2_wall, "numpy": h2_wall})
    emit("parity", t0, checks=checks, rmat={"n": g2.n, "m": g2.m,
                                           "cost": b2.cost()})


def phase_trace(graph):
    """One more batched run of the main path under `torch.profiler`: the
    device's busy time by kernel and copy, against the run's wall time.
    Reported, not asserted: the wall of this run includes the profiler's
    own cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        repro_torch.summarize(graph, backend="batched", device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            by_name[e.key] = {"device_us": us, "count": e.count}
    busy_us = sum(v["device_us"] for v in by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["device_us"])[:8])
    emit("trace", t0, wall_seconds=wall, device_busy_us=busy_us,
         device_busy_share=busy_us * 1e-6 / wall if busy_us else None,
         by_name=top)
    return by_name


def kernel_record(recorder, launches, rng, device_us, rates):
    """The per-kernel contract line: times summed over the main path's
    calls, each distinct call shape timed once and weighted by its count.
    ``device_ms`` is the kernel's own device time over the traced rerun of
    the main path (None where the profiler saw no device time)."""
    import torch

    from repro_torch.kernels.bitset_jaccard import kernel as K1, ref as R1
    from repro_torch.kernels.seghist import kernel as K2, ref as R2

    saved = (K1.LAUNCHES, K2.LAUNCHES)  # comparison launches do not count
    inter = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bb=0.0, bo=0.0, err=0)
    for (B, G, W, valid), n in recorder.inter.items():
        x = inter_input(B, G, W, rng)
        got = K1.bitset_intersections(x, valid)
        want = R1.bitset_intersections(x, valid)
        inter["err"] = max(inter["err"], int(
            (got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        inter["ms"] += n * cuda_ms(lambda: K1.bitset_intersections(x, valid), 10)
        inter["plain_ms"] += n * cuda_ms(
            lambda: R1.bitset_intersections(x, valid), 2)
        inter["library_ms"] += n * cuda_ms(inter_library(x), 5)
        bb, bo = inter_bound_s(B, G, W, valid, rates)
        inter["bb"] += n * bb
        inter["bo"] += n * bo
    hist = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bb=0.0, bo=0.0, err=0)
    for ids, S in recorder.hist:
        got = K2.segment_histogram(ids, S)
        want = R2.segment_histogram(ids, S)
        hist["err"] = max(hist["err"], int(
            (got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        valid_ids = ids[ids >= 0].to(torch.int64)
        hist["ms"] += cuda_ms(lambda: K2.segment_histogram(ids, S), 20)
        hist["plain_ms"] += cuda_ms(lambda: R2.segment_histogram(ids, S), 5)
        hist["library_ms"] += cuda_ms(
            lambda: torch.bincount(valid_ids, minlength=S), 5)
        bb, bo = hist_bound_s(ids, S, rates)
        hist["bb"] += bb
        hist["bo"] += bo
    K1.LAUNCHES, K2.LAUNCHES = saved
    for name, acc in (("bitset_intersections", inter),
                      ("segment_histogram", hist)):
        if acc["err"]:
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"the main path's calls by {acc['err']}")
    out = []
    for name, acc, src, replaces in (
            ("bitset_intersections", inter,
             "src/repro_torch/csrc/bitset_intersections.cu",
             "src/repro/kernels/bitset_jaccard/kernel.py:85"),
            ("segment_histogram", hist,
             "src/repro_torch/csrc/segment_histogram.cu",
             "src/repro/kernels/seghist/kernel.py:39")):
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": acc["err"], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"],
            "bound_ms": max(acc["bb"], acc["bo"]) * 1e3,
            "bound_by": "bytes" if acc["bb"] >= acc["bo"] else "operations",
            "library_ms": acc["library_ms"],
            "device_ms": sum(v["device_us"] for k, v in device_us.items()
                             if f"{name}_kernel" in k) * 1e-3 or None})
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke.py: no src/repro_torch beside {ROOT}; run it from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible to torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.graphs import generators as GG

    t_all = time.perf_counter()
    rng = np.random.default_rng(0)
    dev, smi, rates = phase_device()
    phase_build()
    phase_kernels(rng, rates)
    t0 = time.perf_counter()
    graph = GG.caveman(20000, 11, 0.03, seed=0)
    emit("graph", t0, n=graph.n, m=graph.m)
    summary, launches, recorder = phase_main(graph)
    phase_parity(graph, summary)
    device_us = phase_trace(graph)
    t0 = time.perf_counter()
    record = kernel_record(recorder, launches, rng, device_us, rates)
    emit("record", t0, total_seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
