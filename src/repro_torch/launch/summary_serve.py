"""Batched summary-query serving driver: continuous batching over a frozen
summary artifact.

This driver drains a `neighbors`/`edge_exists` query queue through fixed
query slots against a `PackedSummary` (`core/summary_ir.py`), answered
whole-batch-at-a-time by `core/query_batch`. Short final chunks share
`serve.pad_to_slots`. The server and the CLI sweep with the interval-count
kernel on the CUDA card by default; ``--device cpu`` runs its plain
version.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.summary_serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.summary_serve --edges 220k
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.query_batch import (BACKENDS, edge_exists_batch,
                                          neighbors_batch, sweep_device)
from repro_torch.core.slugger import summarize
from repro_torch.core.summary_ir import PackedSummary
from repro_torch.graphs.generators import SERVING_GRAPHS
from repro_torch.launch.serve import RequestError, pad_to_slots


class SummaryQueryServer:
    """Fixed-slot continuous batching for summary queries: queries occupy
    slots, every step answers one full batch, finished slots refill from the
    queue. Short final chunks are padded by repeating the last query
    (`pad_to_slots`) and the pad answers dropped. ``device=None`` means the
    CUDA card, which must exist (for the ``torch`` and ``kernel``
    backends)."""

    def __init__(self, packed: PackedSummary, batch_slots: int = 256,
                 backend: str = "kernel", device=None):
        self.device = sweep_device(backend, device)
        self.ps = packed
        self.B = int(batch_slots)
        self.backend = backend

    def _invalid_reason(self, q):
        """Reason string for a malformed/out-of-range query, else None."""
        if not isinstance(q, (tuple, list)) or not q:
            return "query must be a ('neighbors', v) or ('edge', u, v) tuple"
        kind = q[0]
        if kind not in ("neighbors", "edge"):
            return f"unknown query kind {kind!r}"
        want = 2 if kind == "neighbors" else 3
        if len(q) != want:
            return f"{kind!r} query takes {want - 1} id(s), got {len(q) - 1}"
        for v in q[1:]:
            if not isinstance(v, (int, np.integer)):
                return f"query id {v!r} is not an integer"
            if not 0 <= int(v) < self.ps.n_leaves:
                return (f"query id {int(v)} out of range "
                        f"[0, {self.ps.n_leaves})")
        return None

    def run(self, queries: list, timeout: float | None = None) -> list:
        """``queries``: ("neighbors", v) or ("edge", u, v) tuples.

        Returns answers in submission order: a sorted int64 id array per
        neighbors query, a bool per edge query. A malformed or
        out-of-range query gets a `RequestError` record in its slot — the
        drain loop keeps serving the rest of the batch. With ``timeout``
        (wall-clock seconds) no NEW batch starts after the deadline (the
        first always runs); answered batches are flushed and cut-off
        queries come back as timeout `RequestError`\\ s."""
        if not queries:
            return []
        out: list = [None] * len(queries)
        nb: list = []
        eg: list = []
        for i, q in enumerate(queries):
            reason = self._invalid_reason(q)
            if reason is not None:
                out[i] = RequestError(q, reason)
            elif q[0] == "neighbors":
                nb.append((i, q[1]))
            else:
                eg.append((i, q[1], q[2]))
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        started = False

        def expired():
            return (started and deadline is not None
                    and time.perf_counter() >= deadline)

        for c0 in range(0, len(nb), self.B):
            if expired():
                break
            real = nb[c0: c0 + self.B]
            vs = np.array([v for _, v in pad_to_slots(real, self.B)], dtype=np.int64)
            indptr, ids = neighbors_batch(self.ps, vs, backend=self.backend,
                                          device=self.device)
            for j, (i, _) in enumerate(real):
                out[i] = ids[indptr[j]: indptr[j + 1]]
            started = True
        for c0 in range(0, len(eg), self.B):
            if expired():
                break
            real = eg[c0: c0 + self.B]
            chunk = pad_to_slots(real, self.B)
            us = np.array([u for _, u, _ in chunk], dtype=np.int64)
            vs = np.array([v for _, _, v in chunk], dtype=np.int64)
            hit = edge_exists_batch(self.ps, us, vs, backend=self.backend,
                                    device=self.device)
            for j, (i, _, _) in enumerate(real):
                out[i] = bool(hit[j])
            started = True
        for i, q in enumerate(queries):
            if out[i] is None:
                out[i] = RequestError(
                    q, f"batch timed out after {timeout:.3f}s; "
                       f"partial results flushed")
        return out


def make_queries(n: int, count: int, edge_frac: float = 0.25, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    kinds = rng.random(count) < edge_frac
    a = rng.integers(0, n, size=count)
    b = rng.integers(0, n, size=count)
    return [("edge", int(a[i]), int(b[i])) if kinds[i]
            else ("neighbors", int(a[i])) for i in range(count)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny graph + save/load round-trip + answer check")
    ap.add_argument("--edges", default="55k", choices=sorted(SERVING_GRAPHS))
    ap.add_argument("--backend", default="kernel", choices=BACKENDS)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' (plain versions)")
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--batch-slots", type=int, default=256)
    ap.add_argument("--artifact", default=None,
                    help="write the packed .npz here and serve from the reload")
    ap.add_argument("--iters", type=int, default=5, help="merge iterations")
    args = ap.parse_args(argv)

    name = "smoke" if args.smoke else args.edges
    g = SERVING_GRAPHS[name]()
    print(f"[summary-serve] graph {name}: {g.n} nodes, {g.m} edges")
    t0 = time.perf_counter()
    s = summarize(g, T=args.iters, seed=0, device=args.device)
    packed = s.pack_for_serving()
    print(f"[summary-serve] summarized+packed in {time.perf_counter()-t0:.2f}s "
          f"(cost {s.cost()}, artifact {packed.nbytes()/1e6:.2f} MB)")

    path = args.artifact
    with tempfile.TemporaryDirectory(prefix="slugger-serve-") as tmp:
        if args.smoke and path is None:
            path = os.path.join(tmp, "packed.npz")
        if path is not None:
            path = packed.save(path)  # save normalizes to the real .npz path
            packed = PackedSummary.load(path)
            print(f"[summary-serve] artifact round-trip via {path}")

    requests = 256 if args.smoke else args.requests
    queries = make_queries(g.n, requests)
    server = SummaryQueryServer(packed, batch_slots=args.batch_slots,
                                backend=args.backend, device=args.device)
    t0 = time.perf_counter()
    answers = server.run(queries)
    dt = time.perf_counter() - t0
    print(f"[summary-serve] {len(queries)} queries in {dt:.3f}s "
          f"({len(queries)/dt:.0f} q/s, backend={args.backend}, "
          f"device={server.device}, slots={args.batch_slots})")

    if args.smoke:
        # every answer must match the per-call reference engine
        for q, a in zip(queries, answers):
            if q[0] == "neighbors":
                assert np.array_equal(a, s.neighbors(q[1])), q
            else:
                want = bool(np.isin(q[2], s.neighbors(q[1])))
                assert a == want, q
        print(f"[summary-serve] smoke OK: {len(queries)} answers match the "
              "per-call engine")
    return answers


if __name__ == "__main__":
    main()
