"""Partition-parallel, stage-based summarization engine (DESIGN.md §8).

`SummarizerEngine` is the engine behind `slugger.summarize()`: each of the T
iterations runs five explicit, pluggable stages

    shingle → group → pack → merge_round → exchange

over a `PartitionedGraph`, followed by the partition-aware emission DP and
pruning. Candidate generation is global and seeded; candidate GROUPS are
assigned to partitions by node ownership and swept in record mode
(`merging.MergePlan`) against the iteration-start snapshot — on a thread
pool when ``workers > 1`` — and the exchange stage replays every plan in
canonical group order (`merging.apply_plans`). So the summary is a pure
function of (graph, seed, config): ``partitions=k`` is bit-identical to
``partitions=1`` for every backend and thread schedule, and to the JAX
package's engine on the same inputs for every ported backend.

Per-iteration randomness comes from `np.random.SeedSequence(seed).spawn(T)`
— no arithmetic on raw seeds anywhere.

With ``checkpoint_dir`` the applied plan log is committed after each
iteration (`core/checkpoint.PlanCheckpointer`, the JAX package's format);
``resume=True`` replays it — through the resident run context too — and
continues, bit-identical to an uninterrupted run on any backend and
partition count (DESIGN.md §11).

Device work: ``backend="batched"`` ranks merge partners with the CUDA
bitset-intersection kernel and counts emission-DP state membership with the
CUDA segment-histogram kernel (once a partition bucket), both on
``device``. ``backend="resident"`` keeps each workspace chunk's whole
merge-round state on ``device`` (`core/resident.py`): ranking (the CUDA
top-J kernel), exact Saving and θ̂ acceptance run there, the fold runs
there (the CUDA bitset-fold kernel and the count phases), the adjacency
bank carries every root's row across iterations so chunks are extracted on
the device, and root shingles are computed there; its emission counts on
the host. Worker threads launch on the device's current stream, so their
kernels serialize and only host work overlaps. The engine resolves
``device=None`` to the CUDA card and raises when there is none; a CPU
device runs the kernels' plain versions.

Meshes (`launch/mesh.py`, `core/distributed.py`): under a mesh — passed
as ``mesh``, or `make_data_mesh()` whenever a process group of more than
one rank is up — ``"batched"`` and ``"resident"`` shard their device work
over the data axis, SPMD, every rank running the same host program. Both
shingle through `distributed.shingle_provider` (each rank segment-mins
its block of the edges, a MIN all-reduce combines them); ``"batched"``
ranks through `distributed.batched_intersections_mesh` (each rank runs
the intersection kernel on its rows of every tile, the rows are
all-gathered); ``"resident"`` builds its arenas from host workspaces with
no adjacency bank, each rank holding its block of every chunk's groups
(top-J and the fold run on the block, the per-row proposals are
all-gathered). Every host takes the same decisions, so the summary is
the no-mesh one. Collectives pair up by their order, so under a mesh of
more than one rank the merge_round thunks run in plan order on one
thread whatever ``workers`` says; the summary never depends on
``workers``. A mesh must live on the engine's device type: a ``cuda``
engine needs an NCCL group and raises without one.

Faults and degradation (DESIGN.md §11, `repro_torch.faults`): after every
stage the engine checks the site ``engine.<stage>`` with the iteration, so
an injected fault kills a run at an exact stage boundary. An injected
fault (`faults.InjectedFault`) at a device site degrades the run instead
of ending it, where the summary cannot change: a kernel op retries once on
its plain version (`core/resident.py`), a rank dispatch of ``"batched"``
falls to the host popcount (`merging.HostRankSource`), and a bank
extraction (wrapped as `faults.BankFault`) or bank advance drops the run
context — the bank, the device root map and the device shingles — for the
rest of the run: the shingles come from the host twin and each chunk
uploads its host-built workspace to an arena that still runs the kernels.
Every degradation is recorded, and ``stats["degradations"]`` counts those
of the run. Any other failure raises: a kernel that fails to build or
launch on the card ends the run rather than finishing on a plain version.
"""
from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import faults
from repro_torch.core import distributed as D
from repro_torch.core.merging import apply_plans, build_merge_work
from repro_torch.core.minhash import candidate_groups, host_shingle_provider
from repro_torch.core.pruning import prune
from repro_torch.core.resident import ResidentBitmapArena, ResidentRunContext
from repro_torch.core.slugger import SluggerState, _emit_encoding
from repro_torch.core.transfer import GLOBAL as TRANSFER
from repro_torch.graphs.partitioned import as_partitioned
from repro_torch.launch.mesh import dp_size, make_data_mesh

log = logging.getLogger("repro_torch.engine")

STAGE_ORDER = ("shingle", "group", "pack", "merge_round", "exchange")


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, which must exist; otherwise the named
    ``cuda`` or ``cpu`` device, or ``meta`` (shapes with no data: the dry
    run, `launch/dryrun.py`). Never falls back from the card to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs its kernels on a CUDA card and none is "
            "available; pass device='cpu' to run their plain versions")
    return dev


class IterationContext:
    """Mutable scratch shared by one iteration's stages."""

    __slots__ = ("t", "theta", "state", "pg", "ss_groups", "ss_merge",
                 "shingle_fn", "groups", "group_children", "group_seeds",
                 "plans", "thunks", "merges")

    def __init__(self, t: int, theta: float, state, pg):
        self.t = t
        self.theta = theta
        self.state = state
        self.pg = pg
        self.shingle_fn = None
        self.groups = []
        self.group_children = []
        self.group_seeds = np.zeros(0, dtype=np.uint64)
        self.plans = []
        self.thunks = []
        self.merges = 0


class SummarizerEngine:
    """Configured, reusable SLUGGER engine.

    Parameters mirror `summarize()` (``backend`` is ``"batched"``,
    ``"resident"``, ``"numpy"`` or ``"loop"``) plus:

    * ``partitions`` — number of node-ownership shards; ``1`` is the
      monolithic special case and the semantics never depend on the value.
    * ``workers`` — threads for the merge_round stage (record-mode sweeps
      touch no shared state, so they parallelize safely). Defaults to
      ``min(partitions, cpu count)``.
    * ``stages`` — dict overriding any of the five stage callables (each
      called as ``fn(engine, ctx)``); unknown names raise ``ValueError``.
    * ``mesh`` — a `DeviceMesh` (`launch/mesh.py`) for the sharded
      shingle/intersection dispatch (``backend="batched"``) and the
      resident arena placement (``backend="resident"``). ``None``
      auto-enables `make_data_mesh()` when a process group of more than one
      rank is initialized.
    * ``device`` — where the kernels run (`resolve_device`).
    """

    def __init__(self, partitions: int = 1, backend: str = "batched",
                 T: int = 20, seed: int = 0, max_group: int = 500,
                 top_j: int = 16, height_bound=None, prune_steps=(1, 2, 3),
                 workers: int | None = None, mesh=None,
                 stages: dict | None = None, device=None):
        if backend not in ("numpy", "batched", "resident", "loop"):
            raise ValueError(
                f"unknown backend {backend!r}; use 'batched', 'resident', "
                f"'numpy' or 'loop'")
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        self.partitions = int(partitions)
        self.backend = backend
        self.T = int(T)
        self.seed = seed
        self.max_group = max_group
        self.top_j = top_j
        self.height_bound = height_bound
        self.prune_steps = tuple(prune_steps)
        self.workers = (min(self.partitions, os.cpu_count() or 1)
                        if workers is None else max(1, int(workers)))
        self.stages = {name: getattr(type(self), f"stage_{name}")
                       for name in STAGE_ORDER}
        if stages:
            unknown = set(stages) - set(STAGE_ORDER)
            if unknown:
                raise ValueError(f"unknown stages {sorted(unknown)}; "
                                 f"valid: {STAGE_ORDER}")
            self.stages.update(stages)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.stats: dict = {}
        self._shingle_provider = None
        self._rank_dispatch = None
        self._run_ctx = None
        self._mesh = None

    def _mesh_active(self):
        """The mesh of this run, or None: ``mesh``, else a data mesh over
        every rank of a process group of more than one; only the batched
        and resident backends shard. Raises when the mesh's device type is
        not the engine's (a card engine under a gloo group)."""
        if self.backend not in ("batched", "resident"):
            return None
        mesh = self.mesh
        if mesh is None:
            if not (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1):
                return None
            mesh = make_data_mesh()
        if mesh.device_type != self.device.type:
            raise RuntimeError(
                f"a {mesh.device_type} mesh cannot drive a {self.device} "
                f"engine: the card needs an NCCL process group, the CPU a "
                f"gloo one")
        return mesh

    def _setup_dispatches(self, g):
        """Every backend shingles with the unified u32 family; the resident
        backend computes the shingles on the device from its run context
        (edges uploaded once, root map advanced from the applied plans),
        the others with the host twin — the same bits either way. Under a
        mesh the sharded provider computes them, ``"batched"`` ranks
        through the sharded intersection dispatch and ``"resident"`` has
        no run context."""
        self._run_ctx = None
        self._rank_dispatch = None
        self._mesh = self._mesh_active()
        if self._mesh is not None:
            self._shingle_provider = D.shingle_provider(g, self._mesh,
                                                        device=self.device)
            if self.backend == "batched":
                self._rank_dispatch = D.batched_intersections_mesh(
                    self._mesh, device=self.device)
        elif self.backend == "resident":
            self._run_ctx = ResidentRunContext(g, device=self.device)
            self._shingle_provider = self._run_ctx.for_roots
        else:
            self._shingle_provider = host_shingle_provider(g)

    def _resident_arena(self, ws):
        """A chunk's arena: extracted on the device from the adjacency bank
        (``ws`` is then a shell), or uploaded from the host-built workspace
        when the bank declined the graph or the run context was dropped.
        Called from the merge_round workers: it only reads the bank and the
        root map, which nothing writes before the exchange stage. A failed
        extraction raises `faults.BankFault`: the shell carries no tensors,
        so only the stage loop's rebuild can recover. Only an injected fault
        is wrapped; any other failure raises as it is."""
        rc = self._run_ctx
        if rc is not None and rc.bank is not None:
            try:
                return ResidentBitmapArena.from_bank(rc.bank, ws, rc.res_map,
                                                     top_j=self.top_j)
            except faults.InjectedFault as e:
                raise faults.BankFault(f"bank extract failed: {e!r}") from e
        return ResidentBitmapArena.from_workspace(ws, top_j=self.top_j,
                                                  device=self.device,
                                                  mesh=self._mesh)

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
        """Assign groups to partitions by node ownership and build their
        record-mode workspaces against the iteration-start snapshot. Each
        group keeps the RNG stream of its GLOBAL index."""
        groups = ctx.groups
        ctx.plans = [None] * len(groups)
        ctx.thunks = []
        if not groups:
            return
        part_of_group = self._group_partitions(ctx)
        resident = self.backend == "resident"
        shell = self._run_ctx is not None and self._run_ctx.bank is not None
        for p in np.unique(part_of_group):
            idxs = np.flatnonzero(part_of_group == p)
            plans_p, thunks_p = build_merge_work(
                ctx.state, [groups[i] for i in idxs], ctx.theta,
                group_seeds=ctx.group_seeds[idxs],
                rng_of=lambda li, idxs=idxs: np.random.default_rng(
                    ctx.group_children[idxs[li]]),
                top_j=self.top_j, height_bound=self.height_bound,
                backend=self.backend, device=self.device,
                rank_dispatch=self._rank_dispatch,
                resident_factory=self._resident_arena if resident else None,
                shell_workspaces=shell)
            for li, gi in enumerate(idxs):
                ctx.plans[int(gi)] = plans_p[li]
            ctx.thunks.extend(thunks_p)

    def stage_merge_round(self, ctx: IterationContext):
        """Run the sweeps (ranking on the device for ``"batched"``, whole
        rounds on the device for ``"resident"``) — serial, or on
        ``workers`` threads; record mode makes the schedule irrelevant to
        the outcome. Under a mesh of more than one rank the thunks issue
        collectives, which pair up by their order across ranks, so they
        run in plan order on this thread."""
        collective = self._mesh is not None and dp_size(self._mesh) > 1
        if self.workers > 1 and len(ctx.thunks) > 1 and not collective:
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                list(pool.map(lambda f: f(), ctx.thunks))
        else:
            for thunk in ctx.thunks:
                thunk()

    def stage_exchange(self, ctx: IterationContext):
        """Replay all recorded merge rounds against the global state in
        canonical group order — the only cross-partition communication."""
        ctx.merges = self._replay_plans(ctx.state, ctx.plans)

    def _replay_plans(self, state, plans: list) -> int:
        """Apply recorded plans to the global state — shared by the
        exchange stage and checkpoint-resume replay. On the resident
        backend the applied (A, Z, M) batches, with the minted rows'
        lengths ``row_len[M]`` (pristine exactly at the hook), also advance
        the run context's root map and adjacency bank on the device. The
        plans are applied to the global state first, so an injected fault
        in the advance degrades the run (`_degrade_to_host`) instead of
        ending it; any other failure raises."""
        if self._run_ctx is None:
            return apply_plans(state, plans)
        batches: list = []
        merges = apply_plans(
            state, plans, on_batch=lambda A, Z, M: batches.append(
                (A, Z, M, state.row_len[M].copy())))
        try:
            self._run_ctx.advance(batches)
        except faults.InjectedFault as e:
            self._degrade_to_host(state, "resident.bank.advance", e)
        return merges

    def _degrade_to_host(self, state, site: str, exc) -> None:
        """Drop the resident run context (bank, device root map, device
        shingles) and finish the run with host shingles and host-built
        workspaces uploaded to arenas that keep their kernels: the same
        integers, so the same summary. Recorded in the degradation
        ledger."""
        faults.DEGRADATIONS.record(site, exc)
        log.warning("degrading to host workspace path after %s fault: %r",
                    site, exc)
        self._run_ctx = None
        self._shingle_provider = host_shingle_provider(state.g)

    def _group_partitions(self, ctx: IterationContext) -> np.ndarray:
        """Partition of each group = owner of its smallest member root's
        smallest leaf (`SluggerState.root_min_leaf`, the same keying the
        partition-aware emission uses)."""
        n_groups = len(ctx.groups)
        if self.partitions == 1:
            return np.zeros(n_groups, dtype=np.int64)
        min_leaf = ctx.state.root_min_leaf()
        key_roots = np.array([int(g.min()) for g in ctx.groups],
                             dtype=np.int64)
        return ctx.pg.owner[min_leaf[key_roots]]

    # ------------------------------------------------------------------ run
    def _config(self) -> dict:
        """JSON-safe config snapshot recorded in checkpoints — the JAX
        engine's keys. `checkpoint.DECISION_KEYS` are resume-enforced;
        backend/partitions are informational."""
        height = self.height_bound
        return {
            "T": self.T,
            "seed": int(self.seed),
            "max_group": int(self.max_group),
            "top_j": int(self.top_j),
            "height_bound": None if height is None else int(height),
            "prune_steps": list(self.prune_steps),
            "backend": self.backend,
            "partitions": self.partitions,
        }

    def merge_forest(self, g, checkpoint_dir=None, resume: bool = False,
                     checkpoint_every: int = 1):
        """Run the T merge iterations only over ``g`` (a `Graph` or a
        `PartitionedGraph`); returns ``(state, pg)`` — the merge-forest
        state and the partitioned graph. Per-stage wall seconds land in
        ``self.stats``, with the transfer ledger per iteration
        (``transfer_iters``) and in total.

        With ``checkpoint_dir`` set, the plan log is committed atomically
        after every ``checkpoint_every``-th iteration and the last
        (``stats["checkpoint"]`` holds the commit seconds);
        ``resume=True`` replays the newest committed log and continues
        from the next iteration (``stats["resumed_from"]``).
        ``stats["degradations"]`` counts the ledger's events of the run."""
        pg = as_partitioned(g, self.partitions)
        state = SluggerState(pg.to_graph())
        transfer0 = TRANSFER.snapshot()  # before setup: run-context init counts
        self._setup_dispatches(state.g)
        self.stats = {name: 0.0 for name in STAGE_ORDER}
        self.stats["merges"] = 0
        self.stats["checkpoint"] = 0.0
        self.stats["transfer_iters"] = []
        deg_mark = faults.DEGRADATIONS.count()
        transfer_prev = transfer0
        ckpt = None
        fingerprint = None
        plan_log: list = []
        t_start = 1
        if checkpoint_dir is not None:
            from repro_torch.core.checkpoint import (PlanCheckpointer,
                                                     graph_fingerprint)
            fingerprint = graph_fingerprint(state.g)
            ckpt = PlanCheckpointer(checkpoint_dir)
            if resume:
                loaded = ckpt.load_latest(fingerprint, self._config())
                if loaded is not None:
                    t_done, plan_log = loaded
                    t0 = time.perf_counter()
                    for plans in plan_log:
                        self.stats["merges"] += self._replay_plans(state,
                                                                   plans)
                    self.stats["exchange"] += time.perf_counter() - t0
                    t_start = t_done + 1
                    self.stats["resumed_from"] = t_done
                    log.info("resumed from checkpoint at iter %d (%d plans "
                             "replayed)", t_done,
                             sum(len(p) for p in plan_log))
        iter_streams = np.random.SeedSequence(self.seed).spawn(max(self.T, 1))
        for t in range(t_start, self.T + 1):
            theta = 0.0 if t == self.T else 1.0 / (1 + t)
            ctx = IterationContext(t, theta, state, pg)
            ctx.ss_groups, ctx.ss_merge = iter_streams[t - 1].spawn(2)
            for name in STAGE_ORDER:
                t0 = time.perf_counter()
                try:
                    self.stages[name](self, ctx)
                except faults.BankFault as e:
                    # the bank failed mid-stage: the workspaces built for it
                    # are shells. Degrade, then rebuild from pack against
                    # the same iteration-start snapshot and streams — pure
                    # functions, so the same decisions
                    self._degrade_to_host(ctx.state, "resident.bank.extract",
                                          e)
                    self.stages["pack"](self, ctx)
                    if name == "merge_round":
                        self.stages["merge_round"](self, ctx)
                self.stats[name] += time.perf_counter() - t0
                faults.check(f"engine.{name}", iteration=t)
            self.stats["merges"] += ctx.merges
            if ckpt is not None:
                plan_log.append(ctx.plans)
                if t % max(1, checkpoint_every) == 0 or t == self.T:
                    t0 = time.perf_counter()
                    ckpt.save(t, plan_log, fingerprint, self._config())
                    self.stats["checkpoint"] += time.perf_counter() - t0
            snap = TRANSFER.snapshot()
            self.stats["transfer_iters"].append(
                TRANSFER.delta_since(transfer_prev, now=snap))
            transfer_prev = snap
            log.info(
                "iter %3d: θ=%.3f groups=%d merges=%d roots=%d parts=%d",
                t, theta, len(ctx.groups), ctx.merges, state.alive.size,
                self.partitions)
        self.stats["transfer"] = TRANSFER.delta_since(transfer0)
        self.stats["degradations"] = faults.DEGRADATIONS.count() - deg_mark
        return state, pg

    def run(self, g, checkpoint_dir=None, resume: bool = False,
            checkpoint_every: int = 1):
        """Summarize end to end; returns the (pruned) `Summary`. The
        checkpoint arguments are `merge_forest`'s."""
        state, pg = self.merge_forest(g, checkpoint_dir=checkpoint_dir,
                                      resume=resume,
                                      checkpoint_every=checkpoint_every)
        owner = pg.owner if self.partitions > 1 else None
        t0 = time.perf_counter()
        summary = _emit_encoding(state, backend=self.backend,
                                 device=self.device, owner=owner)
        self.stats["emit"] = time.perf_counter() - t0
        if self.prune_steps:
            t0 = time.perf_counter()
            summary = prune(summary, steps=self.prune_steps,
                            partition_map=owner)
            self.stats["prune"] = time.perf_counter() - t0
        return summary
