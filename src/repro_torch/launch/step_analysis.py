"""FLOPs, bytes and collective bytes of one rank's step, counted as it runs
(the port's counterpart of the JAX package's `launch/hlo_analysis.py`,
which parses XLA's optimized HLO).

`analyze_step(fn, *args)` runs ``fn`` under a `TorchDispatchMode` that
sees every aten and c10d op below autograd and the composite
decompositions, on whatever device the tensors live: the card, the CPU, or
``meta`` (shapes, no data: the dry run, `launch/dryrun.py`). Per op:

  * FLOPs: `torch.utils.flop_counter`'s formulas for the matmuls and
    convolutions; the input's elements for a reduction; nothing for data
    movement (copies, casts, creation, indexing, gathers and scatters,
    sorts); one per output element for every other op (the HLO
    analyzer's elementwise rule);
  * bytes: every tensor input plus every tensor output, at its elements
    times its itemsize; views and allocations are free;
  * collectives, by their c10d op: the bytes of the operand each rank
    contributes, by category (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute), and their count.

Eager execution runs every layer, so there is no trip count to recover;
`torch.utils.checkpoint`'s recompute runs again and counts twice, as XLA's
rematerialization does. A hand kernel counts as one op: its wrapper, which
launches through ctypes where the dispatcher never sees it, reports its
own FLOPs and bytes through `hand_kernel`, and the aten ops beneath it (its
CPU plain version, its output's allocation) are not counted again, so the
count is the same on the card, on the CPU and on meta. The counter also
tracks the storages alive during the step (the inputs', and every op's
outputs until freed): ``peak_bytes``, the counterpart of the HBM a
compiled program's buffers take.
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import COLLECTIVES

# c10d op -> (category, index of the operand each rank contributes)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}
# ops that neither compute nor move data
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "detach", "alias", "lift_fresh", "set_", "resize_",
    "record_stream", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
}
# ops that move or make data without arithmetic: bytes, no FLOPs
_MOVE = {
    "clone", "copy_", "_to_copy", "cat", "stack", "index", "index_select",
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "index_put", "index_put_", "_index_put_impl_",
    "index_add", "index_add_", "index_copy", "index_copy_", "embedding",
    "embedding_dense_backward", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "fill_", "fill", "zero_", "new_zeros", "new_ones",
    "new_full", "arange", "constant_pad_nd", "repeat", "flip", "roll",
    "slice_scatter", "select_scatter", "diagonal_scatter",
    "as_strided_scatter", "narrow_copy", "_unsafe_index", "masked_select",
    "scalar_tensor", "randperm", "sort", "argsort", "topk", "unique",
    "_unique2", "unique_dim", "unique_consecutive", "bincount", "nonzero",
    "repeat_interleave", "tril_indices", "triu_indices", "masked_scatter",
    "_pin_memory", "lift_fresh_copy", "view_copy", "permute_copy",
    "expand_copy", "split_with_sizes_copy", "unbind_copy", "t_copy",
    "transpose_copy", "slice_copy", "select_copy", "squeeze_copy",
    "unsqueeze_copy", "alias_copy", "detach_copy", "_reshape_copy",
}
# reductions: one FLOP per input element
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "norm", "linalg_vector_norm", "var", "var_mean", "std", "std_mean",
    "any", "all", "argmax", "argmin", "cumsum", "cumprod", "aminmax",
    "count_nonzero",
}

_ACTIVE: list = []


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """The dispatch mode `analyze_step` runs a step under (module
    docstring); read its totals with `result`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {c: 0 for c in COLLECTIVES}
        self.coll_count = {c: 0 for c in COLLECTIVES}
        self.kernels: dict = {}
        self.ops = Counter()
        self.suspended = 0
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- live storage ------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as alive until they
        are freed."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- counting ----------------------------------------------------------
    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """Count one launch of the hand kernel ``name``."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns == "c10d":
            cat, at = _C10D.get(name, (None, 0))
            if cat is None:
                return
            operand = sum(_bytes(t) for t in _tensors(args[at]))
            self.coll[cat] += operand
            self.coll_count[cat] += 1
            # the result lands in args[0] (in place for an all-reduce)
            self.bytes += operand + sum(_bytes(t) for t in _tensors(args[0]))
            self.ops[str(func)] += 1
            return
        if func.is_view or name in _FREE:
            return
        self.ops[str(func)] += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += sum(_bytes(t) for t in ins) + sum(_bytes(t)
                                                        for t in outs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        elif name in _MOVE:
            pass
        elif name in _REDUCE:
            self.flops += ins[0].numel() if ins else 0
        else:
            self.flops += sum(t.numel() for t in outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.suspended:
            self._count(func, args, kwargs, out)
            self.track(out)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def result(self) -> dict:
        """The counts: the HLO analyzer's keys (``flops``, ``bytes``,
        ``coll_bytes``, ``coll``, ``coll_count``), ``kernels`` (each hand
        kernel's launches, FLOPs and bytes), ``peak_bytes`` and ``ops``
        (counted ops by name)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": sum(self.coll.values()),
                "coll": dict(self.coll), "coll_count": dict(self.coll_count),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "peak_bytes": self.peak_bytes, "ops": dict(self.ops)}


def active():
    """The innermost `StepCounter` running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def hand_kernel(name: str, work, run):
    """``run()``, a hand kernel's launch (or its plain version, or its
    meta output), counted as one op: under a counter, ``work()`` gives
    its ``(flops, bytes)`` and the ops beneath ``run`` are not counted;
    with no counter running, only ``run()``."""
    c = active()
    if c is None:
        return run()
    c.kernel(name, *work())
    c.suspended += 1
    try:
        out = run()
    finally:
        c.suspended -= 1
    c.track(out)
    return out


def analyze_step(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a `StepCounter` and return
    its counts (`StepCounter.result`), with ``out``, ``fn``'s result. The
    storages of ``args`` count as alive from the start."""
    counter = StepCounter()
    counter.track((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    res = counter.result()
    res["out"] = out
    return res
