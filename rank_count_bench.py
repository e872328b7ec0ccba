#!/usr/bin/env python3
"""Time one checkout's top-J ranking (`jaccard_topj`) and interval-count
(`interval_counts`) kernels, or its bitset-fold (`bitset_fold`) and
segment-histogram (`segment_histogram`) kernels, on one CUDA card, so
that two checkouts can be compared in one call, on one card, in turns:

    python3 rank_count_bench.py --src /path/to/parent/src --label parent
    python3 rank_count_bench.py --label change   # this checkout's src/
    python3 rank_count_bench.py --kernels fold_hist --src DIR --label parent
    python3 rank_count_bench.py --split          # the probe split, swept
    python3 rank_count_bench.py --src DIR --drain  # the serving drain
    python3 rank_count_bench.py --src DIR --resident --emit  # fold, hist

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

``--kernels fold_hist`` times the fold and the histogram instead:
`chip_smoke.py`'s `FOLD_SHAPES` with its kernels-phase instruction slabs
(a pair in every slot: synthetic) and its `HIST_SHAPES`, then a replay of
the main paths' own calls: every fold call of the caveman 1.1M resident
run and every histogram call of the batched emission over its forest
(`caveman(20000, 11, 0.03, seed=0)` at T=20), captured as each call was
handed its inputs (`CallRecorder(keep_fold=True)`), each call checked
against its plain version; a replay's wall and device time are the sums
over its calls, as the record line of `chip_smoke.py` sums them.

``--split`` sweeps the interval kernel's probe split at serving's hub tile
(256, 4096, 8192): a row's probes in runs of 512 to 8,192 a block, each
block sorting the row itself (8,192: one block a row, the hub row's
probes all on one SM), through the raw `interval_count_split_launch`
into one preallocated output, checked against the plain version. Without
a card it exits non-zero, whatever the mode.

``--drain`` times the serving path the interval kernel sits on, end to
end: `rmat(14, 8, seed=0)` summarized at T=20 (host backend), packed, and
16,384 `make_queries(n, 16384, edge_frac=0.25, seed=1)` queries drained
through `SummaryQueryServer(batch_slots=256)` with the kernel and the torch
backends on the card, host clock around each run ending in a
synchronize: the first run (new shapes, as `chip_smoke.py`'s serve phase
takes it) and ``--drains`` warm runs each, every answer list equal to the
numpy backend's.

``--resident`` and ``--emit`` time the two stages the fold and the
histogram sit on, end to end, on that caveman graph: ``--resident`` the
merge forest on the resident backend (its `merge_round` seconds, the
fold's launches); ``--emit`` the batched emission DP
(`_emit_encoding(..., backend="batched")`, the batched run's `emit`
stage) over that same forest, which the batched backend builds bit for
bit too: the first call and ``--emits`` warm calls, host clock around each
call ending in a synchronize, the histogram's launches.
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
CAVEMAN = (20000, 11, 0.03)  # the 1.1M-edge graph of the main paths, T=20


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


def stages_run(label: str, resident: bool, emit: bool, emits: int) -> None:
    import time

    import torch

    import repro_torch
    from repro_torch.core.slugger import _emit_encoding
    from repro_torch.graphs import generators as GG
    from repro_torch.kernels.bitset_fold import kernel as K3
    from repro_torch.kernels.seghist import kernel as K2

    g = GG.caveman(*CAVEMAN, seed=0)
    engine = repro_torch.SummarizerEngine(backend="resident", T=20,
                                          device="cuda")
    folds = K3.FOLD_LAUNCHES
    tw = time.perf_counter()
    state, _ = engine.merge_forest(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    if resident:
        print(json.dumps({
            "label": label, "stage": "resident merge forest",
            "graph": {"n": g.n, "m": g.m}, "wall_s": wall,
            "merge_round_s": engine.stats["merge_round"],
            "merges": engine.stats["merges"],
            "fold_launches": K3.FOLD_LAUNCHES - folds}), flush=True)
    if not emit:
        return
    walls, costs = [], set()
    hists = K2.LAUNCHES
    for _ in range(1 + emits):  # the first call meets new shapes
        tw = time.perf_counter()
        summary = _emit_encoding(state, backend="batched", device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tw)
        costs.add(summary.cost())
    warm = sorted(walls[1:])
    print(json.dumps({
        "label": label, "stage": "batched emit", "first_s": walls[0],
        "warm_s": walls[1:], "warm_median_s": warm[len(warm) // 2],
        "costs": sorted(costs), "lossless": summary.validate_lossless(g),
        "hist_launches": K2.LAUNCHES - hists}), flush=True)


def main_calls():
    """Every fold call of the caveman resident run (inputs as handed to
    it) and every histogram call of the batched emission over its forest:
    ``([(bits, alive, instr)], [(ids, S)])``."""
    import repro_torch
    import chip_smoke as CS
    from repro_torch.core.slugger import _emit_encoding
    from repro_torch.graphs import generators as GG

    g = GG.caveman(*CAVEMAN, seed=0)
    recorder = CS.CallRecorder(keep_fold=True)
    try:
        state, _ = repro_torch.SummarizerEngine(
            backend="resident", T=20, device="cuda").merge_forest(g)
        _emit_encoding(state, backend="batched", device="cuda")
    finally:
        recorder.close()
    return recorder.fold_inputs, recorder.hist


def rank_count_rows(label, reps, rng):
    """(record, the wrapper call, the kernels' names) of each shape of
    top-J and the interval count."""
    import torch

    import chip_smoke as CS
    from repro_torch.kernels.bitset_fold import kernel as K3, ref as R3
    from repro_torch.kernels.interval_expand import kernel as KI, ref as RI

    rows = []
    for B, G, W, J in CS.TOPJ_SHAPES:
        x, alive = CS.topj_input(B, G, W, rng)
        call = functools.partial(K3.jaccard_topj, x, alive, J)
        rows.append(({
            "label": label, "kernel": "jaccard_topj",
            "shape": [B, G, W, J],
            "equal": bool(torch.equal(call(), R3.topj_all(x, alive, J))),
            "kernel_ms": CS.cuda_ms(call, reps)}, call,
            ("jaccard_topj",)))
    for kind, B, E, P in CS.INTERVAL_SHAPES:
        x = CS.INTERVAL_INPUTS[kind](B, E, P, rng)
        call = functools.partial(KI.interval_counts, *x)
        rows.append(({
            "label": label, "kernel": "interval_count", "layout": kind,
            "shape": [B, E, P],
            "equal": bool(torch.equal(call(), RI.interval_counts(*x))),
            "kernel_ms": CS.cuda_ms(call, reps)}, call,
            ("interval_count_kernel", "interval_probe_kernel")))
    return rows


def fold_hist_rows(label, reps, rng):
    """(record, the wrapper call, the kernels' names) of each fixed shape
    of the fold and the histogram, then of the replay of each one's main
    path calls (`main_calls`)."""
    import torch

    import chip_smoke as CS
    from repro_torch.kernels.bitset_fold import kernel as K3
    from repro_torch.kernels.seghist import kernel as K2, ref as R2

    rows = []
    for B, G, W, P in CS.FOLD_SHAPES:
        n_valid = B * P - B // 2
        x, alive, instr = CS.fold_input(B, G, W, P, n_valid, rng)
        equal = CS.fold_error(x, alive, instr) == 0
        call = functools.partial(K3.bitset_fold, x, alive, instr)
        rows.append(({
            "label": label, "kernel": "bitset_fold", "slab": "every slot",
            "shape": [B, G, W, P], "valid_pairs": n_valid, "equal": equal,
            "kernel_ms": CS.cuda_ms(call, reps)}, call, ("bitset_fold",)))
    for E, S in CS.HIST_SHAPES:
        ids = CS.hist_input(E, S, rng)
        call = functools.partial(K2.segment_histogram, ids, S)
        rows.append(({
            "label": label, "kernel": "segment_histogram", "shape": [E, S],
            "equal": bool(torch.equal(call(), R2.segment_histogram(ids, S))),
            "kernel_ms": CS.cuda_ms(call, reps)}, call,
            ("segment_histogram",)))
    folds, hists = main_calls()
    equal = all(CS.fold_error(*f) == 0 for f in folds)

    def fold_replay():
        for x, alive, instr in folds:
            K3.bitset_fold(x, alive, instr)

    rows.append(({
        "label": label, "kernel": "bitset_fold", "slab": "main replay",
        "calls": len(folds),
        "valid_pairs": sum(int((i[..., 6] > 0).sum()) for _, _, i in folds),
        "equal": equal, "kernel_ms": CS.cuda_ms(fold_replay, reps)},
        fold_replay, ("bitset_fold",)))

    def hist_replay():
        for ids, S in hists:
            K2.segment_histogram(ids, S)

    rows.append(({
        "label": label, "kernel": "segment_histogram", "slab": "main replay",
        "calls": len(hists), "shapes": [[int(i.numel()), S] for i, S in hists],
        "equal": all(torch.equal(K2.segment_histogram(i, S),
                                 R2.segment_histogram(i, S))
                     for i, S in hists),
        "kernel_ms": CS.cuda_ms(hist_replay, reps)}, hist_replay,
        ("segment_histogram",)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the `src` directory of the checkout to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--kernels", choices=("rank_count", "fold_hist"),
                    default="rank_count",
                    help="top-J and the interval count, or the fold and "
                    "the histogram")
    ap.add_argument("--reps", type=int, default=None,
                    help="calls a row (default 50, fold_hist 200)")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--drain", action="store_true")
    ap.add_argument("--drains", type=int, default=5)
    ap.add_argument("--resident", action="store_true")
    ap.add_argument("--emit", action="store_true")
    ap.add_argument("--emits", type=int, default=5)
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

    reps = args.reps or (200 if args.kernels == "fold_hist" else 50)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    if args.split:
        split_run(args.label, reps)
        return 0
    if args.drain:
        drain_run(args.label, args.drains)
        return 0
    if args.resident or args.emit:
        stages_run(args.label, args.resident, args.emit, args.emits)
        return 0
    rng = np.random.default_rng(0)
    if args.kernels == "fold_hist":
        rows, profiled = fold_hist_rows(args.label, reps, rng), 200
    else:
        rows, profiled = rank_count_rows(args.label, reps, rng), 20
    # device times last: a profiler session slows the launches after it;
    # the fold's and histogram's calls of a few us over a long window
    # (200), as the profiler loses some launches of a short one
    for row, call, names in rows:
        print(json.dumps({**row, "device_us": device_us(call, names,
                                                        profiled)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
