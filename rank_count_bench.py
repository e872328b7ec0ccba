#!/usr/bin/env python3
"""Time one checkout's top-J ranking (`jaccard_topj`) and interval-count
(`interval_counts`) kernels on one CUDA card at `chip_smoke.py`'s fixed
shapes, so that two checkouts can be compared in one call, on one card, in
turns:

    python3 rank_count_bench.py --src /path/to/parent/src --label parent
    python3 rank_count_bench.py --label change   # this checkout's src/
    python3 rank_count_bench.py --split          # the probe split, swept
    python3 rank_count_bench.py --src DIR --drain  # the serving drain

Each run builds that checkout's kernels (its own `build/`) and prints the
card's name and power limit, then one JSON line per shape: the mean
milliseconds of the public wrapper over ``--reps`` calls by CUDA events
after a warm-up call (the wrapper's host cost included, as the resident
round and the serving drain pay it), the kernels' own device time a call
by `torch.profiler`, and whether the call equals the plain version.
Shapes: `TOPJ_SHAPES` of `chip_smoke.py` (the resident path's largest
calls among them) and its `INTERVAL_SHAPES` (serving's hub tile and the
any-int32 input among them), inputs drawn as there
(`numpy.random.default_rng(0)`). Only the public wrappers are called, so
any checkout of the port since the interval kernel landed can be timed.

``--split`` sweeps the interval kernel's probe split at serving's hub tile
(256, 4096, 8192): a row's probes in runs of 512 to 8,192 a block, each
block sorting the row itself (8,192: one block a row, the hub row's
probes all on one SM), through the raw `interval_count_split_launch`
into one preallocated output, checked against the plain version. Without
a card it exits non-zero.

``--drain`` times the serving path the interval kernel sits on, end to
end: `rmat(14, 8, seed=0)` summarized at T=20 (host backend), packed, and
16,384 `make_queries(n, 16384, edge_frac=0.25, seed=1)` queries drained
through `SummaryQueryServer(batch_slots=256)` with the kernel and the torch
backends on the card, host clock around each run ending in a
synchronize: the first run (new shapes, as `chip_smoke.py`'s serve phase
takes it) and ``--drains`` warm runs each, every answer list equal to the
numpy backend's.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPLITS = (512, 1024, 2048, 4096, 8192)  # probes a block at the hub tile
HUB = (256, 4096, 8192)


def device_us(fn, names, reps=20):
    """Mean device microseconds a call of the kernels whose name holds one
    of ``names``, over ``reps`` calls under the profiler (after a warm-up)."""
    import chip_smoke as CS

    def many():
        for _ in range(reps):
            fn()

    _, by_name = CS.traced(many, warmup=True)
    us = [v["device_us"] for k, v in by_name.items()
          if any(n in k for n in names)]
    return sum(us) / reps if us else None


def split_run(label: str, reps: int) -> None:
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels.interval_expand import ref as RI

    lib = _build.load_library()
    B, E, P = HUB
    x = CS.interval_serving_input(B, E, np.random.default_rng(0))
    want = RI.interval_counts(*x)
    out = torch.empty((B, P), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for ppb in SPLITS:
        call = functools.partial(
            lib.interval_count_split_launch, *(t.data_ptr() for t in x),
            out.data_ptr(), B, E, P, ppb, stream)
        out.fill_(-1)
        _build.check_status("interval_count", call())
        torch.cuda.synchronize()
        rows.append(({"label": label, "split": ppb, "shape": [B, E, P],
                      "equal": bool(torch.equal(out, want)),
                      "ms": CS.cuda_ms(call, reps)}, call))
    for row, call in rows:  # device times last, as in the main run
        print(json.dumps({**row, "device_us": device_us(
            call, ("interval_count_kernel",))}), flush=True)


def drain_run(label: str, drains: int) -> None:
    import time

    import torch

    import repro_torch
    from repro_torch.graphs import generators as GG
    from repro_torch.launch.summary_serve import (SummaryQueryServer,
                                                  make_queries)

    g = GG.rmat(14, 8, seed=0)
    packed = repro_torch.summarize(g, T=20, backend="numpy").pack_for_serving()
    queries = make_queries(g.n, 16384, edge_frac=0.25, seed=1)
    want = SummaryQueryServer(packed, batch_slots=256, backend="numpy",
                              device="cuda").run(queries)
    for backend in ("kernel", "torch"):
        server = SummaryQueryServer(packed, batch_slots=256, backend=backend,
                                    device="cuda")
        walls, equal = [], True
        for _ in range(1 + drains):  # the first run meets new shapes
            tw = time.perf_counter()
            got = server.run(queries)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - tw)
            equal &= all(
                (a == b) if isinstance(a, bool) else
                (a.shape == b.shape and bool((a == b).all()))
                for a, b in zip(got, want))
        warm = sorted(walls[1:])
        print(json.dumps({
            "label": label, "drain": "rmat_14_8", "backend": backend,
            "queries": len(queries), "equal": equal, "first_s": walls[0],
            "warm_s": walls[1:],
            "warm_median_qps": len(queries) / warm[len(warm) // 2]}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the `src` directory of the checkout to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--drain", action="store_true")
    ap.add_argument("--drains", type=int, default=5)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"rank_count_bench.py: no repro_torch under {src}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("rank_count_bench.py: no CUDA card visible to torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    import chip_smoke as CS
    from repro_torch.kernels.bitset_fold import kernel as K3, ref as R3
    from repro_torch.kernels.interval_expand import kernel as KI, ref as RI

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    if args.split:
        split_run(args.label, args.reps)
        return 0
    if args.drain:
        drain_run(args.label, args.drains)
        return 0
    rng = np.random.default_rng(0)
    rows = []  # (record, the wrapper call, the kernels' names)
    for B, G, W, J in CS.TOPJ_SHAPES:
        x, alive = CS.topj_input(B, G, W, rng)
        call = functools.partial(K3.jaccard_topj, x, alive, J)
        rows.append(({
            "label": args.label, "kernel": "jaccard_topj",
            "shape": [B, G, W, J],
            "equal": bool(torch.equal(call(), R3.topj_all(x, alive, J))),
            "kernel_ms": CS.cuda_ms(call, args.reps)}, call,
            ("jaccard_topj",)))
    for kind, B, E, P in CS.INTERVAL_SHAPES:
        x = CS.INTERVAL_INPUTS[kind](B, E, P, rng)
        call = functools.partial(KI.interval_counts, *x)
        rows.append(({
            "label": args.label, "kernel": "interval_count", "layout": kind,
            "shape": [B, E, P],
            "equal": bool(torch.equal(call(), RI.interval_counts(*x))),
            "kernel_ms": CS.cuda_ms(call, args.reps)}, call,
            ("interval_count_kernel", "interval_probe_kernel")))
    # device times last: a profiler session slows the launches after it
    for row, call, names in rows:
        print(json.dumps({**row, "device_us": device_us(call, names)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
