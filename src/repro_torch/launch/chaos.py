"""Chaos driver: kill the summarizer at every stage boundary and prove the
plan-log checkpoint resumes bit-identically (DESIGN.md §11).

The default mode injects an `InjectedFault` at each of the five engine
stage boundaries (``engine.shingle``/``group``/``pack``/``merge_round``/
``exchange``) mid-run, resumes from the surviving checkpoint and asserts
the summary equals an uninterrupted run array for array. ``--kernel-fault``
instead injects a dispatch fault into the resident backend's proposal
round and asserts that the engine finishes on the kernels' plain versions
with a lossless, numpy-identical summary and the degradation counted; on
the card it also asserts that the top-J kernel ran.

    PYTHONPATH=src python -m repro_torch.launch.chaos [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.chaos --kernel-fault [--device cpu]

``--device`` defaults to the CUDA card and raises without one, like every
entry point of the port.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np

from repro_torch import faults
from repro_torch.core.engine import STAGE_ORDER, SummarizerEngine
from repro_torch.graphs import generators


def _engine(backend: str = "numpy", partitions: int = 1, T: int = 5,
            device=None) -> SummarizerEngine:
    return SummarizerEngine(partitions=partitions, backend=backend, T=T,
                            seed=3, device=device)


def run_stage_kills(T: int = 5, kill_at: int = 3, device=None) -> int:
    """Kill at every stage boundary of iteration ``kill_at``; resume each
    time and demand bit-identity with the uninterrupted run."""
    g = generators.caveman(14, 6, 0.05, seed=13)
    want = _engine(T=T, device=device).run(g)
    assert want.validate_lossless(g)
    for stage in STAGE_ORDER:
        ckpt = tempfile.mkdtemp(prefix=f"slugger-chaos-{stage}-")
        try:
            try:
                with faults.inject(f"engine.{stage}", iteration=kill_at):
                    _engine(T=T, device=device).run(g, checkpoint_dir=ckpt)
                raise AssertionError(f"engine.{stage} fault never fired")
            except faults.InjectedFault:
                pass
            eng = _engine(T=T, device=device)
            got = eng.run(g, checkpoint_dir=ckpt, resume=True)
            resumed = eng.stats.get("resumed_from")
            # the commit lands AFTER iteration kill_at's stages, so every
            # kill inside iteration kill_at resumes from kill_at - 1
            assert resumed == kill_at - 1, (stage, resumed)
            assert np.array_equal(got.parent, want.parent), stage
            assert np.array_equal(got.edges, want.edges), stage
            assert got.validate_lossless(g), stage
            print(f"[chaos] kill @ engine.{stage} (iter {kill_at}): resumed "
                  f"from {resumed}, bit-identical")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[chaos] OK: {len(STAGE_ORDER)} stage-boundary kills, "
          f"{len(STAGE_ORDER)} bit-identical resumes")
    return 0


def run_kernel_fault(T: int = 3, device=None) -> int:
    """Inject a dispatch fault into a resident run: the arena must retry on
    the plain versions and finish losslessly, numpy-identical, with the
    degradation counted."""
    from repro_torch.kernels.bitset_fold import kernel as K

    g = generators.caveman(40, 5, 0.05, seed=0)
    want = _engine(T=T, device=device).run(g)
    eng = _engine(backend="resident", T=T, device=device)
    topj0 = K.TOPJ_LAUNCHES
    # kernel sites carry no engine iteration (the check sits in the device
    # op), so target the Nth dispatch instead
    with faults.inject("kernel.bitset_fold.round", hit=2):
        got = eng.run(g)
    degr = eng.stats["degradations"]
    assert degr > 0, "kernel fault injected but no degradation recorded"
    assert np.array_equal(got.parent, want.parent)
    assert np.array_equal(got.edges, want.edges)
    assert got.validate_lossless(g)
    launched = K.TOPJ_LAUNCHES - topj0
    if eng.device.type == "cuda":
        assert launched > 0, "the resident run never launched jaccard_topj"
    print(f"[chaos] OK: kernel dispatch fault degraded to the plain versions "
          f"({degr} degradation(s), {launched} top-J launches), summary "
          f"lossless and numpy-identical")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel-fault", action="store_true",
                    help="resident-backend dispatch fault → retry on the "
                         "kernels' plain versions")
    ap.add_argument("--iters", type=int, default=5,
                    help="engine iterations T for the stage-kill mode")
    ap.add_argument("--kill-at", type=int, default=3,
                    help="iteration the stage-boundary faults fire in")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: the card, which must exist) "
                         "or 'cpu'")
    args = ap.parse_args(argv)
    if args.kernel_fault:
        return run_kernel_fault(device=args.device)
    return run_stage_kills(T=args.iters, kill_at=args.kill_at,
                           device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
