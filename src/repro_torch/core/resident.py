"""Device-resident merge rounds: persistent bitmap + count arenas (§9).

`ResidentBitmapArena` is the ``backend="resident"`` engine's device half.
One arena holds ONE batched workspace chunk's whole merge-round state on
the device for the length of an iteration — the packed bitmaps ``(B, G,
Wp)`` and the exact integer count tensors (``CNT``, column sizes, member
columns, sizes, self-counts, descendant counts, heights, row costs, the
dirty queue) — so a sweep round is two device ops
(`kernels/bitset_fold/ops.py`):

1. **proposal round** — the device derives the dirty rows from its own
   ``dirty`` mirror, ranks candidates with the `jaccard_topj` kernel,
   evaluates the EXACT integer Saving of each and the quantized-θ̂
   acceptance; only ``(n, 2)`` int8 ``[accept, partner]`` comes back;
2. **count-carrying fold** — the round's accepted pairs fold the counts,
   stats and row costs in place and the `bitset_fold` kernel folds the
   bitmaps, mirroring the host `apply_merges` bit for bit.

Only the conflict-free matching stays on the host (it needs the group-seed
hashes). `ResidentAdjacencyBank` carries every root's coalesced adjacency
row on the device ACROSS iterations, advanced straight from the applied
`MergePlan` batches, and `ResidentBitmapArena.from_bank` extracts each
chunk's tensors on the device: the host workspaces are shape-only shells
and the steady-state ``upload`` is zero. `ResidentRunContext` owns the bank,
the resident root map and the device shingles.

Every transfer reports to `core.transfer.GLOBAL` under its phase (``init``,
``upload``, ``rank``, ``fold``, ``carry``, ``candgen``, ``bank``,
``extract``, ``sync``); each proposal round-trip ticks the round counter.
The ``host_*``/``sync_rows`` downloads are the verification contract: the
engine never calls them. The v1 protocol (`topj_rows` ranking and the
bitmap-only `fold`) stays for tests and tools.

Under a mesh of more than one data rank (`from_workspace(mesh=)`, the
engine's mesh path, which has no bank) each rank uploads only its block
of the chunk's groups: the top-J and fold kernels run on the block, the
per-row proposals are all-gathered so every host takes the same
decisions, and each rank folds the accepted pairs of its own groups. A
1-rank mesh shards nothing.

Degradation (DESIGN.md §11): every round op goes through `_run_round_op`.
An op failed by an injected fault (`faults.InjectedFault`, raised at the
op's site before any device work, so the state is intact) is recorded in
`faults.DEGRADATIONS`, the arena drops ``use_kernel`` for its life and
retries the op once on the kernels' plain versions on the same device,
which give the same integers. Any other failure raises: an op that failed
part-way may have written the state, and a kernel that fails on the card
must not finish on its plain version. The bank's fault sites
(``resident.bank.extract`` at the top of `from_bank`,
``resident.bank.advance`` before the bank changes at all) raise to the
engine, which drops the run context and goes on with host-built
workspaces.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import faults
from repro_torch.core.minhash import u32_seed_consts
from repro_torch.core.transfer import GLOBAL as TRANSFER
from repro_torch.kernels._build import pow2
from repro_torch.kernels.bitset_fold import carry, ops
from repro_torch.kernels.bitset_fold.rounds import C_CLAMP
from repro_torch.launch.mesh import all_gather_rows, block, dp_group, dp_size

_COUNT_KEYS = ("CNT", "colsize", "memcol", "s", "selfc", "nd", "hgt", "cost")

log = logging.getLogger("repro_torch.engine")


def _put(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _slots(b: np.ndarray):
    """Slot of each pair within its group (``b`` sorted ascending) and the
    instruction rows per group, P = pow2 of the fullest group (≥ 2)."""
    head = np.concatenate([[True], b[1:] != b[:-1]])
    starts = np.flatnonzero(head)
    counts = np.diff(np.concatenate([starts, [b.size]]))
    return np.arange(b.size) - np.repeat(starts, counts), int(counts.max())


def _run_round_op(arena, site: str, op):
    """Run one round op, ``op(use_kernel)``. An injected fault with the
    kernels live is recorded, drops ``arena.use_kernel`` for the arena's
    life and retries once on the plain versions — the same integers, so
    the same summary. Any other failure, and any on the plain versions,
    raises."""
    try:
        return op(arena.use_kernel)
    except faults.InjectedFault as e:
        if not arena.use_kernel:
            raise
        faults.DEGRADATIONS.record(site, e)
        log.warning("kernel dispatch %s failed; retrying on the plain "
                    "versions: %r", site, e)
        arena.use_kernel = False
        return op(False)


class ResidentBitmapArena:
    """One workspace chunk's merge-round state, resident on its device."""

    def __init__(self, state: dict, B: int, G: int, *, top_j: int = 16,
                 counter=TRANSFER, group=None):
        """Wrap a chunk's device ``state`` (`_COUNT_KEYS` plus ``bits``
        ``(Bp, G, Wp)`` int32, ``alive`` and ``dirty`` ``(Bp, G)`` int8):
        ``B`` live groups of ``G`` members, padded to ``Bp`` groups that
        are all-dead and all-zero, inert in every op. Under a data
        ``group`` of n ranks, ``state`` holds this rank's block of
        ``Bp / n`` groups (`launch.mesh`; the rank's index in the group
        orders the blocks)."""
        self.state = state
        self.counter = counter
        self.device = state["bits"].device
        self.B = int(B)
        self.G = int(G)
        self.group = group
        self.shards = 1 if group is None else dist.get_world_size(group)
        Bl, _, self.Wp = state["bits"].shape
        self.Bp = Bl * self.shards
        self.lo = 0 if group is None else Bl * dist.get_rank(group)
        self.Rp = int(state["CNT"].shape[2])
        self.J = max(1, min(int(top_j), self.G - 1))
        self.rounds = 0
        self.use_kernel = True  # dropped for good by a failed round op

    @classmethod
    def from_workspace(cls, ws, *, top_j: int = 16, device, mesh=None,
                       counter=TRANSFER):
        """Upload a host-built `BatchedGroupWorkspace` chunk: its bitmaps
        (the uint32 view of its uint64 words, W padded to a power of two
        ≥ 2) and its integer count state as int32 (the workspace build
        guards every value below C_CLAMP). The batch pads to a power of
        two, times the shard count under a ``mesh`` of more than one data
        rank, where each rank uploads only its block of groups (the
        ledger counts the whole chunk, as the reference's does); a 1-rank
        mesh shards nothing. The dirty queue starts as the alive mask —
        the host sweep's initial queue."""
        group, shards = None, 1
        if mesh is not None and dp_size(mesh) > 1:
            group, shards = dp_group(mesh), dp_size(mesh)
        B, G, R = ws.CNT.shape
        Bp = shards * pow2(-(-int(B) // shards), floor=1)
        Wp = pow2(int(ws.bits.shape[2]) * 2, floor=2)
        Rp = pow2(int(R), floor=8)
        bits = np.zeros((Bp, G, Wp), dtype=np.uint32)
        bits[:B, :, : 2 * ws.bits.shape[2]] = ws.bits.view(np.uint32)
        host = {"bits": bits.view(np.int32),
                "CNT": np.zeros((Bp, G, Rp), dtype=np.int32),
                "colsize": np.zeros((Bp, Rp), dtype=np.int32)}
        host["CNT"][:B, :, :R] = ws.CNT
        host["colsize"][:B, :R] = ws.colsize
        for key, src, dt in (("alive", ws.alive, np.int8),
                             ("dirty", ws.alive, np.int8),
                             ("memcol", ws.memcol, np.int32),
                             ("s", ws.s, np.int32),
                             ("selfc", ws.selfc, np.int32),
                             ("nd", ws.nd, np.int32),
                             ("hgt", ws.hgt, np.int32),
                             ("cost", ws.cost_row, np.int32)):
            host[key] = np.zeros((Bp, G), dtype=dt)
            host[key][:B] = src
        counter.add_h2d(sum(v.nbytes for v in host.values()), phase="upload")
        rows = (slice(None) if group is None
                else block(Bp, dist.get_rank(group), shards))
        state = {k: _put(v[rows], device) for k, v in host.items()}
        return cls(state, B, G, top_j=top_j, counter=counter, group=group)

    @classmethod
    def from_bank(cls, bank, ws, res_map, *, top_j: int = 16,
                  counter=TRANSFER):
        """Build a chunk arena by EXTRACTION from the resident adjacency
        bank — no bitmap or count upload. ``ws`` is a shape-only shell
        workspace: only its member layout (``members``, ``B``, ``G``,
        ``R``) is read. The only upload is the ``(Bp, G)`` member/row
        pointer/row length slab (int32, phase ``extract``). The extracted
        state equals `from_workspace` of a host-built chunk bit for bit."""
        faults.check("resident.bank.extract")
        B, G, R = int(ws.B), int(ws.G), int(ws.R)
        Bp = pow2(B, floor=1)
        live = ws.members >= 0
        mem_c = np.where(live, ws.members, 0)
        slab = np.zeros((3, Bp, G), dtype=np.int32)
        slab[0] = -1
        slab[0, :B] = ws.members
        slab[1, :B] = np.where(live, bank.ptr_host[mem_c], 0)
        slab[2, :B] = np.where(live, bank.len_host[mem_c], 0)
        counter.add_h2d(slab.nbytes, phase="extract")
        members, ptr, lens = _put(slab, bank.device).to(torch.int64)
        state = ops.extract(
            bank.state, res_map, members, ptr, lens,
            int(slab[2].sum(dtype=np.int64)), R, pow2(R, floor=8),
            pow2(2 * max((R + 63) // 64, 1), floor=2))
        return cls(state, B, G, top_j=top_j, counter=counter)

    # ------------------------------------------------------------ round ops
    def propose_rows(self, rb: np.ndarray, theta_p: int, height_bound):
        """One fused proposal round over the resident state.

        ``rb`` are the groups of the HOST's dirty rows; the device derives
        the same list, in the same row-major order, from its own ``dirty``
        mirror (a differing count raises). Returns ``(accept, partner)``
        host arrays of length ``rb.size``. The op ranks J = min(top_j,
        G − 1) columns and masks each row to its group's alive count.
        """
        if self.group is not None:
            out = self._propose_sharded(rb, theta_p, height_bound)
        else:
            rows, ok, z = _run_round_op(
                self, "kernel.bitset_fold.round",
                lambda uk: ops.propose(self.state, self.J, theta_p,
                                       height_bound, use_kernel=uk))
            if rows.shape[0] != rb.size:
                raise RuntimeError(
                    f"device dirty queue holds {rows.shape[0]} rows, the "
                    f"host's {rb.size}: the resident state left lockstep")
            out = torch.stack([ok.to(torch.int8), z.to(torch.int8)], 1)
            out = out.cpu().numpy()
        self.counter.add_d2h(out.nbytes, phase="rank")
        self.counter.tick_round()
        self.rounds += 1
        return out[:, 0] > 0, out[:, 1].astype(np.int64)

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's block of a per-group output, in group order."""
        full = local.new_empty((local.shape[0] * self.shards,
                                *local.shape[1:]))
        all_gather_rows(full, local.contiguous(), self.group)
        return full

    def _propose_sharded(self, rb: np.ndarray, theta_p: int,
                         height_bound) -> np.ndarray:
        """The proposal round under a mesh: each rank proposes over its
        block (`ops.propose_dense`) and the ``(Bp, G, 3)`` rows are
        all-gathered, so every host reads the same ``(accept, partner)``
        of its dirty rows — which the gathered dirty mask must list, in
        the host's row-major order."""
        local = _run_round_op(
            self, "kernel.bitset_fold.round",
            lambda uk: ops.propose_dense(self.state, self.J, theta_p,
                                         height_bound, use_kernel=uk))
        full = self._gather(local).cpu().numpy()
        db, dr = np.nonzero(full[..., 0])
        if not np.array_equal(db, rb):
            raise RuntimeError(
                f"the ranks' dirty queues hold {db.size} rows, the host's "
                f"{rb.size}: the resident state left lockstep")
        return full[db, dr, 1:]

    def fold_counts(self, b: np.ndarray, a: np.ndarray, z: np.ndarray):
        """Fold one round's accepted pairs (rows z into rows a of groups b,
        b ascending) into the WHOLE resident state, in place. Member
        columns come from the resident ``memcol``: 16 bytes go up per
        pair."""
        if b.size == 0:
            return
        slot, fullest = _slots(b)
        P = min(pow2(fullest, floor=2), max(self.G // 2, 1))
        up = np.stack([b, slot, a, z]).astype(np.int32)
        self.counter.add_h2d(up.nbytes, phase="fold")
        t = _put(up, self.device).to(torch.int64)
        if self.group is not None:
            _run_round_op(self, "kernel.bitset_fold.fold_counts",
                          lambda uk: ops.fold_shard(
                              self.state, t[0], t[1], t[2], t[3], P, self.lo,
                              use_kernel=uk))
            return
        _run_round_op(self, "kernel.bitset_fold.fold_counts",
                      lambda uk: ops.fold(self.state, t[0], t[1], t[2], t[3],
                                          P, use_kernel=uk))

    # ------------------------------------------------------- v1 round ops
    def topj_rows(self, rb: np.ndarray, rr: np.ndarray) -> np.ndarray:
        """Ranked top-J candidate columns of rows (rb[i], rr[i]) over the
        resident bitmaps: the `jaccard_topj` output gathered on the device,
        ``(n, J)`` int64 on the host. The rows go up padded to a power of
        two ≥ 64 as int32 pairs and the columns come down as int8, as in
        the JAX package's ledger."""
        n = rb.size
        n_pad = pow2(n, floor=64)
        rows = np.zeros((n_pad, 2), dtype=np.int32)
        rows[:n, 0] = rb
        rows[:n, 1] = rr
        self.counter.add_h2d(rows.nbytes, phase="rank")
        if self.group is not None:
            # every row of the rank's block, all-gathered, then the host's
            out = self._gather(_run_round_op(
                self, "kernel.bitset_fold.topj",
                lambda uk: ops.topj(self.state, self._block_rows(), self.J,
                                    use_kernel=uk)))
            out = out.to(torch.int8).cpu().numpy()[rb * self.G + rr]
            out = np.concatenate([out, np.zeros((n_pad - n, self.J),
                                                dtype=np.int8)])
        else:
            t = _put(rows, self.device).to(torch.int64)
            out = _run_round_op(
                self, "kernel.bitset_fold.topj",
                lambda uk: ops.topj(self.state, t, self.J, use_kernel=uk))
            out = out.to(torch.int8).cpu().numpy()
        self.counter.add_d2h(out.nbytes, phase="rank")
        self.counter.tick_round()
        self.rounds += 1
        return out[:n].astype(np.int64)

    def fold(self, b: np.ndarray, a: np.ndarray, z: np.ndarray,
             ca: np.ndarray, cz: np.ndarray):
        """Fold one round's accepted pairs (rows z into rows a of groups b,
        b ascending, member columns ca/cz from the host) into the resident
        bitmaps and liveness, in place. The ``(Bp, P, 8)`` slab is built on
        the host and goes up as int16 while word indices fit (Wp ≤ 2^13),
        else int32."""
        if b.size == 0:
            return
        slot, fullest = _slots(b)
        P = min(pow2(fullest, floor=2), max(self.G // 2, 1))
        dtype = np.int16 if self.Wp <= (1 << 13) else np.int32
        instr = np.zeros((self.Bp, P, 8), dtype=dtype)
        instr[b, slot, 0] = a
        instr[b, slot, 1] = z
        instr[b, slot, 2] = ca >> 5
        instr[b, slot, 3] = ca & 31
        instr[b, slot, 4] = cz >> 5
        instr[b, slot, 5] = cz & 31
        instr[b, slot, 6] = 1
        self.counter.add_h2d(instr.nbytes, phase="fold")
        if self.group is not None:  # this rank's block of the slab
            instr = instr[self.lo: self.lo + self.Bp // self.shards]
        t = _put(instr, self.device).to(torch.int32)
        _run_round_op(self, "kernel.bitset_fold.fold",
                      lambda uk: ops.fold_bits(self.state, t, use_kernel=uk))

    def _block_rows(self) -> torch.Tensor:
        """``[group, row]`` of every row of the state, (Bl·G, 2) int64."""
        Bl = self.Bp // self.shards
        ids = torch.arange(Bl * self.G, device=self.device)
        return torch.stack([ids // self.G, ids % self.G], 1)

    # --------------------------------------------------- sync-back contract
    def _full(self, key) -> torch.Tensor:
        t = self.state[key]
        return t if self.group is None else self._gather(t)

    def _download(self, key):
        out = self._full(key)[: self.B].cpu().numpy()
        self.counter.add_d2h(out.nbytes, phase="sync")
        return out

    def sync_rows(self, b: np.ndarray, g: np.ndarray) -> np.ndarray:
        """Download selected bitmap rows — ``(n, Wp)`` uint32."""
        idx = tuple(torch.as_tensor(np.asarray(v, dtype=np.int64),
                                    device=self.device) for v in (b, g))
        rows = self._full("bits")[idx].cpu().numpy().view(np.uint32)
        self.counter.add_d2h(rows.nbytes, phase="sync")
        return rows

    def host_bits(self) -> np.ndarray:
        """Full ``(B, G, Wp)`` uint32 download (tests only)."""
        return self._download("bits").view(np.uint32)

    def host_alive(self) -> np.ndarray:
        return self._download("alive") > 0

    def host_counts(self):
        """``(CNT, colsize, memcol, s, selfc, nd, hgt, cost)`` host copies
        trimmed to the live batch rows (tests only)."""
        return tuple(self._download(k) for k in _COUNT_KEYS)


class ResidentAdjacencyBank:
    """Per-root adjacency rows carried ON THE DEVICE across iterations.

    Append-only ``gids``/``cnts`` int32 streams (pow2-grown) hold every
    root's coalesced external adjacency row as `SluggerState` materializes
    it when the root is minted; stored gids go stale as neighbours merge,
    and extraction re-resolves them through the current root map and
    re-coalesces — the host's `gather_rows`. Four ``(cap,)`` int32 stats
    mirror ``size``/``selfcnt``/``ndesc``/``height``. The HOST keeps only
    the row directory (``ptr_host``/``len_host``/``top``): the engine
    forwards each applied batch's ``row_len[M]``.

    Exactness guard: merges only coalesce counts or drop internal pairs,
    so every extracted count is ≤ m and every clamped row cost ≤ 3m/2 +
    2n + 16. `fits` says whether that bound stays below the clamp;
    `ResidentRunContext` builds a bank only for a graph that fits, and
    otherwise uploads host-built workspaces, whose build checks each chunk.
    """

    @staticmethod
    def fits(n: int, m: int, clamp: int = C_CLAMP) -> bool:
        return (3 * m) // 2 + 2 * n + 16 < clamp

    def __init__(self, g, *, device, counter=TRANSFER):
        self.counter = counter
        self.device = torch.device(device)
        self.n = int(g.n)
        self.cap = 2 * self.n + 8
        indices = np.asarray(g.indices, dtype=np.int32)
        m = int(indices.size)
        E0 = pow2(max(2 * m, 64))
        gids = torch.zeros(E0, dtype=torch.int32, device=self.device)
        cnts = torch.zeros(E0, dtype=torch.int32, device=self.device)
        gids[:m] = _put(indices, self.device)
        cnts[:m] = 1
        self.ptr_host = np.zeros(self.cap, dtype=np.int64)
        self.len_host = np.zeros(self.cap, dtype=np.int64)
        self.ptr_host[: self.n] = g.indptr[:-1]
        self.len_host[: self.n] = np.diff(g.indptr)
        self.top = m
        zeros = {k: torch.zeros(self.cap, dtype=torch.int32, device=self.device)
                 for k in ("selfc", "nd", "hgt")}
        self.state = {"gids": gids, "cnts": cnts,
                      "size": torch.ones(self.cap, dtype=torch.int32,
                                         device=self.device), **zeros}
        counter.add_h2d(indices.nbytes, phase="init")

    @property
    def capacity(self) -> int:
        return int(self.state["gids"].shape[0])

    def advance_batches(self, res_map: torch.Tensor, batches: list) -> None:
        """Advance the bank by one iteration's applied merge batches,
        ``(A, Z, M, lens)`` each, with ``lens == state.row_len[M]`` read at
        `apply_plans`'s ``on_batch`` hook. Batches replay IN ORDER so each
        resolves gids through the same pre-batch root map the host
        `merge_batch` used; ``res_map`` advances in place. Per batch the
        only upload is the (8, m) int32 instruction slab (32 B per pair,
        phase ``bank``); regrows stay on the device. The fault site
        ``resident.bank.advance`` is checked before anything changes, so a
        fault leaves the bank and ``res_map`` untouched."""
        faults.check("resident.bank.advance")
        for A, Z, M, lens in batches:
            m = int(A.size)
            if m == 0:
                continue
            ub = self.len_host[A] + self.len_host[Z]
            tot = int(ub.sum())
            need = self.top + tot
            if need > self.capacity:
                new_e = pow2(max(need, 2 * self.capacity))
                if new_e >= (1 << 31):
                    raise OverflowError(
                        "adjacency bank outgrew int32 addressing")
                self.state["gids"], self.state["cnts"] = carry.bank_grow(
                    self.state["gids"], self.state["cnts"], new_e)
            outp = self.top + np.cumsum(ub) - ub
            slab = np.stack([A, Z, M, outp, self.ptr_host[A],
                             self.len_host[A], self.ptr_host[Z],
                             self.len_host[Z]]).astype(np.int32)
            self.counter.add_h2d(slab.nbytes, phase="bank")
            carry.bank_advance(self.state, res_map,
                               _put(slab, self.device).to(torch.int64), tot)
            self.ptr_host[M] = outp
            self.len_host[M] = lens
            self.len_host[A] = 0  # consumed roots own no row anymore
            self.len_host[Z] = 0
            self.top = need

    def host_rows(self, roots, res_map):
        """The CURRENT coalesced adjacency rows of ``roots`` on the host —
        each stored gid resolved through ``res_map`` and re-coalesced, as
        `SluggerState.gather_rows` does. A list of ``(nbr, cnt)`` int64
        pairs sorted by nbr (tests only, phase ``sync``)."""
        gids = self.state["gids"].cpu().numpy()
        cnts = self.state["cnts"].cpu().numpy()
        rm = res_map.cpu().numpy()
        self.counter.add_d2h(gids.nbytes + cnts.nbytes + rm.nbytes,
                             phase="sync")
        out = []
        for r in np.asarray(roots, dtype=np.int64):
            p, ln = int(self.ptr_host[r]), int(self.len_host[r])
            rg = rm[gids[p:p + ln]]
            c = cnts[p:p + ln]
            order = np.argsort(rg, kind="stable")
            rg, c = rg[order], c[order]
            if ln:
                idx = np.flatnonzero(np.concatenate([[True],
                                                     rg[1:] != rg[:-1]]))
                out.append((rg[idx].astype(np.int64),
                            np.add.reduceat(c, idx).astype(np.int64)))
            else:
                out.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
        return out


class ResidentRunContext:
    """Per-run device state of the resident backend.

    * the static edge arrays, uploaded once per run (phase ``init``): root
      shingles compute on the device (`for_roots`) and only the per-root
      shingles come back (phase ``candgen``);
    * ``res_map`` (cap,) int32 — the current root of every id, advanced at
      every exchange stage from the applied merge batches;
    * a `ResidentAdjacencyBank`: the bank-advance slab names (A, Z, M), so
      ``res_map`` composes inside the bank advance. A graph past the bank's
      exactness bound (``bank_clamp``) gets no bank: ``bank`` is None, the
      root map advances from (A, Z, M) uploads (phase ``carry``) and the
      chunks upload host-built workspaces.
    """

    def __init__(self, g, *, device, counter=TRANSFER,
                 bank_clamp: int = C_CLAMP):
        self.counter = counter
        self.device = torch.device(device)
        self.n = int(g.n)
        self.cap = 2 * self.n + 8  # SluggerState's id capacity
        src = np.repeat(np.arange(g.n), np.diff(g.indptr)).astype(np.int32)
        dst = np.asarray(g.indices, dtype=np.int32)
        self._src = _put(src, self.device).to(torch.int64)
        self._dst = _put(dst, self.device).to(torch.int64)
        self.res_map = torch.arange(self.cap, dtype=torch.int32,
                                    device=self.device)
        counter.add_h2d(src.nbytes + dst.nbytes, phase="init")
        self.bank = None
        if ResidentAdjacencyBank.fits(self.n, dst.size, bank_clamp):
            self.bank = ResidentAdjacencyBank(g, device=self.device,
                                              counter=counter)

    def advance(self, batches: list):
        """Replay one iteration's applied merge batches against the root
        map — and against the bank when it is live (then each batch must
        be ``(A, Z, M, lens)``, see `ResidentAdjacencyBank.advance_batches`).
        Without a bank all (A, Z, M) triples go up in one slab."""
        if self.bank is not None:
            if any(len(b) < 4 for b in batches):
                raise ValueError(
                    "bank carry needs (A, Z, M, lens) batches — pass "
                    "state.row_len[M] captured at the on_batch hook")
            self.bank.advance_batches(self.res_map, batches)
            return
        if sum(b[0].size for b in batches) == 0:
            return
        tri = np.stack([np.concatenate([b[k] for b in batches])
                        for k in range(3)]).astype(np.int32)
        self.counter.add_h2d(tri.nbytes, phase="carry")
        A, Z, M = _put(tri, self.device).to(torch.int64)
        carry.advance_root_map(self.res_map, A, Z, M)

    def root_of_host(self) -> np.ndarray:
        """res_map[:n] on the host (tests only: the contract against
        `SluggerState.root_of`)."""
        out = self.res_map[: self.n].cpu().numpy()
        self.counter.add_d2h(out.nbytes, phase="sync")
        return out.astype(np.int64)

    def for_roots(self, root_of: np.ndarray):
        """Shingle-provider hook (`minhash.candidate_groups` protocol).
        ``root_of`` (the host map) is unused: the resident ``res_map`` is
        the same mapping, so only the per-root results cross over."""

        def shingle_fn(sub_seed: int, n_ids: int) -> np.ndarray:
            a, b = u32_seed_consts(sub_seed)
            out = carry.shingle_roots(self._src, self._dst, self.res_map,
                                      self.n, int(a), int(b), n_ids)
            out = out.cpu().numpy()
            self.counter.add_d2h(out.nbytes, phase="candgen")
            return out

        return shingle_fn
