"""Readings that the limits of ``limits/<cell>.json`` are set from, in one
process on the card: for each seed the compared cycles of the cell's
traffic through the timed path, compared with the reference as a
benchmark run compares them; on the control seeds also the control, the reference in
fp8 in the program's place. Not part of a benchmark run.

    python3 chipbench/calibrate.py --workload dsv2lite.chat \\
        --seeds 101-112 --control-seeds 101-103 --out chiprun_out/cal.jsonl

One JSON line a seed, then a summary: each number's largest program
reading and smallest control reading.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402

import torch  # noqa: E402

from chipbench import compare, harness  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def control_reading(spec, weights, tokens, ref) -> dict:
    """The control on one compared batch: the reference in fp8 in the
    program's place, read against the reference as the program is."""
    ctl = spec.family.forward(weights, spec.config, tokens, quant="fp8")
    served = ctl["logits"].argmax(-1).cpu().numpy()
    return compare.reading(
        served, ctl["logits"],
        {k: (lambda l, t=t: t[l]) for k, t in ctl["cache"].items()}, ref), \
        compare.own_gaps(served, ctl["logits"])


def read(spec, seed: int, control: bool) -> tuple:
    """The compared cycles' readings of the program and, with ``control``,
    of the control: ``(result line, program numbers, control numbers or
    None)``."""
    run = harness.measure(spec, seed, 0.0, False)
    own = harness.own_gaps(spec, run)
    prog, ctl, ctl_own = [], [], []
    for tokens, ref, r in harness.compared(spec, run):
        prog.append(r)
        if control:
            c, g = control_reading(spec, run.weights, tokens, ref)
            ctl.append(c)
            ctl_own += g
    return (run.result, compare.numbers(prog, own),
            compare.numbers(ctl, ctl_own) if control else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.load_spec(ROOT, args.workload)
    ctl_seeds = set(seeds(args.control_seeds)) if args.control_seeds else set()
    rows, out = [], (open(args.out, "a") if args.out else None)
    for seed in sorted(set(seeds(args.seeds)) | ctl_seeds):
        t = time.perf_counter()
        result, prog, ctl = read(spec, seed, seed in ctl_seeds)
        row = {"workload": args.workload, "seed": seed, "program": prog,
               "control": ctl, "compared": result["info"]["compared"],
               "memory_peak_bytes": result["device"]["memory_peak_bytes"],
               "seconds": time.perf_counter() - t}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del result
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload,
               "program_max": {n: max(r["program"][n] for r in rows)
                               for n in compare.NAMES},
               "control_min": ({n: min(r["control"][n] for r in rows
                                       if r["control"])
                                for n in compare.NAMES} if ctl_seeds else None),
               "seeds": len(rows), "control_seeds": len(ctl_seeds)}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
