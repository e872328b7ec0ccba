"""The ranks of a mesh as threads of one process: per-rank bodies of the
model axis run without a process group, one rank at a time.

`run_ranks(fn, model, data)` calls ``fn(rank, model_axis, data_axis)``
for every rank of a ``(data, model)`` grid, each in its own thread, with
`LocalAxis` axes (`models.sharding.Axis`) whose collectives combine the
ranks' tensors in rank order, as NCCL's would. The body enters
`models.sharding.rank_context` with them and runs the model code on the
rank's blocks. ``chip_smoke.py`` runs a model axis on one card this way,
and the CPU tests run every family's per-rank bodies this way, forward
and backward; serving and training themselves run over
`torch.distributed` (`models.sharding.GroupAxis`).

Each rank reads its own copy of a collective's result, as each NCCL rank
holds its own buffer: a body that writes into what a collective returned
changes no other rank's tensor.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.models.sharding import Axis

WAIT_S = 600  # a rank waiting longer in a collective: the bodies disagree


class LocalGroup:
    """The group of one axis over ranks of one process, one thread each.
    The threads share one lock (`run_ranks`'s scheduler) and hold it
    while they run, so the ranks' bodies never run at once: a rank gives
    the lock up only inside a collective, until every rank of its group
    has arrived. The last arrival combines the tensors in rank order (a
    sum or max, a concatenation), so every rank reads the same values, as
    NCCL's all-reduce gives every rank the same bits; every rank but the
    last reader gets a copy."""

    def __init__(self, world: int, cond: threading.Condition):
        self.world, self.cond = world, cond
        self.slots = {}      # generation -> {rank: (op, dim, tensor)}
        self.results = {}    # generation -> [result, readers left]
        self.gen = [0] * world
        self.failed = None

    def axis(self, rank: int) -> "LocalAxis":
        return LocalAxis(self, rank)

    def _combine(self, slots):
        ops = {(o, d) for o, d, _ in slots.values()}
        if len(ops) != 1:
            raise RuntimeError(f"ranks disagree on the collective: "
                               f"{sorted(map(str, ops))}")
        (op, dim), = ops
        xs = [slots[r][2] for r in range(self.world)]
        if op == "gather":
            return torch.cat(xs, dim=dim)
        res = xs[0].clone()
        for t in xs[1:]:
            res = res + t if op == "sum" else torch.maximum(res, t)
        return res

    def collective(self, rank, op, x, dim=None):
        cond = self.cond
        g = self.gen[rank]
        self.gen[rank] += 1
        slots = self.slots.setdefault(g, {})
        slots[rank] = (op, dim, x)
        if len(slots) == self.world:
            del self.slots[g]
            self.results[g] = [self._combine(slots), self.world]
            cond.notify_all()

        def ready():
            if self.failed is not None:
                return True
            return g in self.results

        if not cond.wait_for(ready, timeout=WAIT_S):
            raise RuntimeError(f"rank {rank} waited {WAIT_S} s for its "
                               f"group's collective {op}")
        if self.failed is not None:
            raise RuntimeError(f"another rank failed: {self.failed!r}")
        entry = self.results[g]
        entry[1] -= 1
        if entry[1] == 0:
            del self.results[g]
            return entry[0]
        return entry[0].clone()


class LocalAxis(Axis):
    """Rank ``rank`` of a `LocalGroup`: `Axis`'s collectives (and their
    backward passes) over the ranks' threads."""

    identity = False

    def __init__(self, group: LocalGroup, rank: int):
        self.group, self.rank, self.size = group, rank, group.world

    def _sum(self, x):
        return self.group.collective(self.rank, "sum", x.contiguous())

    def _max(self, x):
        return self.group.collective(self.rank, "max", x.contiguous())

    def _gather(self, x, dim):
        return self.group.collective(self.rank, "gather", x.contiguous(),
                                     dim % x.dim())


def run_ranks(fn, model: int, data: int = 1) -> list:
    """``[fn(rank, model_axis, data_axis) for each rank]`` over a ``(data,
    model)`` grid of ranks in one process, rank ``= data index · model +
    model index``: the per-rank bodies of a mesh without a process group.
    ``fn`` enters `models.sharding.rank_context` with the axes it is
    given. One thread a rank, one running at a time (`LocalGroup`); an
    exception on one rank fails them all and is re-raised.

    A body may differentiate through the collectives: each rank's
    backward runs on its own thread (autograd's multithreading is off in
    the rank threads), because on the card autograd would otherwise run
    every caller's backward on one worker thread a device, where a rank
    waiting in a collective would block the ranks it waits for."""
    n = data * model
    cond = threading.Condition()
    model_groups = [LocalGroup(model, cond) for _ in range(data)]
    data_groups = [LocalGroup(data, cond) for _ in range(model)]
    results, errors = [None] * n, []

    def body(r):
        di, mi = divmod(r, model)
        with cond, torch.autograd.set_multithreading_enabled(False):
            try:
                results[r] = fn(r, model_groups[di].axis(mi),
                                data_groups[mi].axis(di))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)   # the first is the cause, the rest echo it
                for g in model_groups + data_groups:
                    g.failed = g.failed or e
            cond.notify_all()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
