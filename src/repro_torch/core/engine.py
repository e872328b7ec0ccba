"""Stage-based summarization engine (DESIGN.md §8).

`SummarizerEngine` is the engine behind `slugger.summarize()`: each of the T
iterations runs five explicit stages

    shingle → group → pack → merge_round → exchange

followed by the emission DP and pruning. Candidate generation is global and
seeded; candidate GROUPS are swept in record mode (`merging.MergePlan`)
against the iteration-start snapshot, and the exchange stage replays every
plan in canonical group order (`merging.apply_plans`), so the summary is a
pure function of (graph, seed, config) — bit-identical to the JAX package's
engine on the same inputs for every ported backend.

Per-iteration randomness comes from `np.random.SeedSequence(seed).spawn(T)`
— no arithmetic on raw seeds anywhere.

Device work: ``backend="batched"`` ranks merge partners with the CUDA
bitset-intersection kernel and counts emission-DP state membership with the
CUDA segment-histogram kernel, both on ``device``. The engine resolves
``device=None`` to the CUDA card and raises when there is none; a CPU
device runs the kernels' plain versions. Partitions, meshes, checkpoints
and the resident backend are not ported yet (ROADMAP slices C and E).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from repro_torch.core.merging import apply_plans, build_merge_work
from repro_torch.core.minhash import candidate_groups, host_shingle_provider
from repro_torch.core.pruning import prune
from repro_torch.core.slugger import SluggerState, _emit_encoding
from repro_torch.core.transfer import GLOBAL as TRANSFER

log = logging.getLogger("repro_torch.engine")

STAGE_ORDER = ("shingle", "group", "pack", "merge_round", "exchange")


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, which must exist; otherwise the named
    ``cuda`` or ``cpu`` device. Never falls back from the card to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs its kernels on a CUDA card and none is "
            "available; pass device='cpu' to run their plain versions")
    return dev


class IterationContext:
    """Mutable scratch shared by one iteration's stages."""

    __slots__ = ("t", "theta", "state", "ss_groups", "ss_merge", "shingle_fn",
                 "groups", "group_children", "group_seeds", "plans", "thunks",
                 "merges")

    def __init__(self, t: int, theta: float, state):
        self.t = t
        self.theta = theta
        self.state = state
        self.shingle_fn = None
        self.groups = []
        self.group_children = []
        self.group_seeds = np.zeros(0, dtype=np.uint64)
        self.plans = []
        self.thunks = []
        self.merges = 0


class SummarizerEngine:
    """Configured, reusable SLUGGER engine.

    Parameters mirror `summarize()`. ``partitions`` must be 1 and ``backend`` one of ``"batched"``,
    ``"numpy"`` or ``"loop"`` until ROADMAP slices E and C land.
    """

    def __init__(self, partitions: int = 1, backend: str = "batched",
                 T: int = 20, seed: int = 0, max_group: int = 500,
                 top_j: int = 16, height_bound=None, prune_steps=(1, 2, 3),
                 device=None):
        if backend == "resident":
            raise NotImplementedError(
                "backend='resident' is not ported yet (ROADMAP slice C)")
        if backend not in ("numpy", "batched", "loop"):
            raise ValueError(
                f"unknown backend {backend!r}; use 'batched', 'numpy' or "
                f"'loop'")
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        if partitions > 1:
            raise NotImplementedError(
                "partitions > 1 is not ported yet (ROADMAP slice E)")
        self.partitions = 1
        self.backend = backend
        self.T = int(T)
        self.seed = seed
        self.max_group = max_group
        self.top_j = top_j
        self.height_bound = height_bound
        self.prune_steps = tuple(prune_steps)
        self.device = resolve_device(device)
        self.stats: dict = {}
        self._shingle_provider = None

    # --------------------------------------------------------------- stages
    def stage_shingle(self, ctx: IterationContext):
        """Bind this iteration's root map into the host u32 shingle
        provider; the group stage owns the rehash loop."""
        ctx.shingle_fn = self._shingle_provider(ctx.state.root_of)

    def stage_group(self, ctx: IterationContext):
        """Global candidate generation + per-group RNG stream spawning."""
        state = ctx.state
        ctx.groups = candidate_groups(
            state.g, state.root_of, state.alive, seed=ctx.ss_groups,
            shingle_fn=ctx.shingle_fn, max_group=self.max_group)
        if ctx.groups:
            ctx.group_children = ctx.ss_merge.spawn(len(ctx.groups))
            ctx.group_seeds = np.array(
                [c.generate_state(1, dtype=np.uint64)[0]
                 for c in ctx.group_children], dtype=np.uint64)

    def stage_pack(self, ctx: IterationContext):
        """Build the record-mode workspaces against the iteration-start
        snapshot."""
        ctx.plans, ctx.thunks = [], []
        if not ctx.groups:
            return
        ctx.plans, ctx.thunks = build_merge_work(
            ctx.state, ctx.groups, ctx.theta, group_seeds=ctx.group_seeds,
            rng_of=lambda i: np.random.default_rng(ctx.group_children[i]),
            top_j=self.top_j, height_bound=self.height_bound,
            backend=self.backend, device=self.device)

    def stage_merge_round(self, ctx: IterationContext):
        """Run the sweeps (ranking on the device for ``"batched"``)."""
        for thunk in ctx.thunks:
            thunk()

    def stage_exchange(self, ctx: IterationContext):
        """Replay all recorded merge rounds against the global state in
        canonical group order."""
        ctx.merges = apply_plans(ctx.state, ctx.plans)

    # ------------------------------------------------------------------ run
    def merge_forest(self, g) -> SluggerState:
        """Run the T merge iterations only; returns the merge-forest state.
        Per-stage wall seconds land in ``self.stats``, with the transfer
        ledger per iteration (``transfer_iters``) and in total."""
        state = SluggerState(g)
        transfer0 = TRANSFER.snapshot()
        self._shingle_provider = host_shingle_provider(g)
        self.stats = {name: 0.0 for name in STAGE_ORDER}
        self.stats["merges"] = 0
        self.stats["transfer_iters"] = []
        transfer_prev = transfer0
        iter_streams = np.random.SeedSequence(self.seed).spawn(max(self.T, 1))
        for t in range(1, self.T + 1):
            theta = 0.0 if t == self.T else 1.0 / (1 + t)
            ctx = IterationContext(t, theta, state)
            ctx.ss_groups, ctx.ss_merge = iter_streams[t - 1].spawn(2)
            for name, stage in zip(STAGE_ORDER, (
                    self.stage_shingle, self.stage_group, self.stage_pack,
                    self.stage_merge_round, self.stage_exchange)):
                t0 = time.perf_counter()
                stage(ctx)
                self.stats[name] += time.perf_counter() - t0
            self.stats["merges"] += ctx.merges
            snap = TRANSFER.snapshot()
            self.stats["transfer_iters"].append(
                TRANSFER.delta_since(transfer_prev, now=snap))
            transfer_prev = snap
            log.info("iter %3d: θ=%.3f groups=%d merges=%d roots=%d",
                     t, theta, len(ctx.groups), ctx.merges, state.alive.size)
        self.stats["transfer"] = TRANSFER.delta_since(transfer0)
        return state

    def run(self, g):
        """Summarize end to end; returns the (pruned) `Summary`."""
        state = self.merge_forest(g)
        t0 = time.perf_counter()
        summary = _emit_encoding(state, backend=self.backend,
                                 device=self.device)
        self.stats["emit"] = time.perf_counter() - t0
        if self.prune_steps:
            t0 = time.perf_counter()
            summary = prune(summary, steps=self.prune_steps)
            self.stats["prune"] = time.perf_counter() - t0
        return summary
