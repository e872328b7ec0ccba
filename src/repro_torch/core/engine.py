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
CUDA segment-histogram kernel, both on ``device``. ``backend="resident"``
keeps each workspace chunk's whole merge-round state on ``device``
(`core/resident.py`): ranking (the CUDA top-J kernel), exact Saving and θ̂
acceptance run there, the fold runs there (the CUDA bitset-fold kernel and
the count phases), the adjacency bank carries every root's row across
iterations so chunks are extracted on the device, and root shingles are
computed there; its emission counts on the host. The engine resolves
``device=None`` to the CUDA card and raises when there is none; a CPU
device runs the kernels' plain versions. Partitions, meshes and
checkpoints are not ported yet (ROADMAP slice E).
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from repro_torch.core.merging import apply_plans, build_merge_work
from repro_torch.core.minhash import candidate_groups, host_shingle_provider
from repro_torch.core.pruning import prune
from repro_torch.core.resident import ResidentBitmapArena, ResidentRunContext
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

    Parameters mirror `summarize()`. ``partitions`` must be 1 until ROADMAP
    slice E lands; ``backend`` is ``"batched"``, ``"resident"``,
    ``"numpy"`` or ``"loop"``.
    """

    def __init__(self, partitions: int = 1, backend: str = "batched",
                 T: int = 20, seed: int = 0, max_group: int = 500,
                 top_j: int = 16, height_bound=None, prune_steps=(1, 2, 3),
                 device=None):
        if backend not in ("numpy", "batched", "resident", "loop"):
            raise ValueError(
                f"unknown backend {backend!r}; use 'batched', 'resident', "
                f"'numpy' or 'loop'")
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
        self._run_ctx = None

    def _setup_dispatches(self, g):
        """Every backend shingles with the unified u32 family; the resident
        backend computes the shingles on the device from its run context
        (edges uploaded once, root map advanced from the applied plans),
        the others with the host twin — the same bits either way."""
        self._run_ctx = None
        if self.backend == "resident":
            self._run_ctx = ResidentRunContext(g, device=self.device)
            self._shingle_provider = self._run_ctx.for_roots
        else:
            self._shingle_provider = host_shingle_provider(g)

    def _resident_arena(self, ws):
        """A chunk's arena: extracted on the device from the adjacency bank
        (``ws`` is then a shell), or uploaded from the host-built workspace
        when the bank declined the graph."""
        rc = self._run_ctx
        if rc.bank is not None:
            return ResidentBitmapArena.from_bank(rc.bank, ws, rc.res_map,
                                                 top_j=self.top_j)
        return ResidentBitmapArena.from_workspace(ws, top_j=self.top_j,
                                                  device=self.device)

    # --------------------------------------------------------------- stages
    def stage_shingle(self, ctx: IterationContext):
        """Bind this iteration's root map into the u32 shingle provider;
        the group stage owns the rehash loop."""
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
        resident = self._run_ctx is not None
        ctx.plans, ctx.thunks = build_merge_work(
            ctx.state, ctx.groups, ctx.theta, group_seeds=ctx.group_seeds,
            rng_of=lambda i: np.random.default_rng(ctx.group_children[i]),
            top_j=self.top_j, height_bound=self.height_bound,
            backend=self.backend, device=self.device,
            resident_factory=self._resident_arena if resident else None,
            shell_workspaces=resident and self._run_ctx.bank is not None)

    def stage_merge_round(self, ctx: IterationContext):
        """Run the sweeps (ranking on the device for ``"batched"``, whole
        rounds on the device for ``"resident"``)."""
        for thunk in ctx.thunks:
            thunk()

    def stage_exchange(self, ctx: IterationContext):
        """Replay all recorded merge rounds against the global state in
        canonical group order. On the resident backend the applied
        (A, Z, M) batches, with the minted rows' lengths ``row_len[M]``
        (pristine exactly at the hook), also advance the run context's
        root map and adjacency bank on the device."""
        if self._run_ctx is None:
            ctx.merges = apply_plans(ctx.state, ctx.plans)
            return
        state = ctx.state
        batches: list = []
        ctx.merges = apply_plans(
            state, ctx.plans, on_batch=lambda A, Z, M: batches.append(
                (A, Z, M, state.row_len[M].copy())))
        self._run_ctx.advance(batches)

    # ------------------------------------------------------------------ run
    def merge_forest(self, g) -> SluggerState:
        """Run the T merge iterations only; returns the merge-forest state.
        Per-stage wall seconds land in ``self.stats``, with the transfer
        ledger per iteration (``transfer_iters``) and in total."""
        state = SluggerState(g)
        transfer0 = TRANSFER.snapshot()  # before setup: run-context init counts
        self._setup_dispatches(g)
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
