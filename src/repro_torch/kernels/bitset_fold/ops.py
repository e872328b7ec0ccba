"""Dispatch of the resident merge round's device ops (DESIGN.md §9).

`ResidentBitmapArena` (core/resident.py) calls, per round of a chunk:

* `propose` — the fused proposal round: the dirty-row list from the
  arena's own ``dirty`` mirror (`torch.nonzero`, row-major — exactly the
  host's ``np.nonzero``), the ranked candidates of every row from the
  `jaccard_topj` kernel, the exact integer Saving and θ̂ acceptance of the
  dirty rows (`rounds.round_from_ranked`), and the ``dirty`` update (rows
  whose best Saving fails θ̂ leave the queue, as in the host sweep).
* `fold` — the count-carrying fold of the round's accepted pairs: the
  `bitset_fold` kernel on the ``(B, P, 8)`` instruction slab built on the
  device from the resident member columns, then the count phases
  (`rounds.fold_counts`).

and, for the v1 protocol (tests and tools), `topj` — the ranked top-J
columns of selected rows — and `fold_bits` — the bitmap-only fold of a
host-built slab. The bank → arena extraction is `extract`.

Under a mesh each rank holds a block of the arena's groups and runs the
per-rank bodies on it: `propose_dense` (the proposal laid out over every
row, so the ranks can all-gather it) and `fold_shard` (the pairs of the
rank's groups, the others skipped).

Each op checks its fault site (``kernel.bitset_fold.<op>``, `faults.check`)
before any device work, so an injected fault leaves the state intact and
the arena can retry the op once on the plain versions (DESIGN.md §11).
A failure after that point may leave the state part-written (`fold`'s
count phases write in place), so the arena retries nothing else. ``use_kernel``
picks the path: True calls the wrappers in `kernel.py` (the CUDA kernel on
a card tensor, its plain version on a CPU tensor), False calls the plain
versions in `ref.py` directly on whatever device the state lives on.
"""
from __future__ import annotations

import torch

from repro_torch import faults
from repro_torch.kernels.bitset_fold import carry, ref, rounds
from repro_torch.kernels.bitset_fold.kernel import bitset_fold, jaccard_topj


def _topj_all(bits, alive, J: int, use_kernel: bool):
    return (jaccard_topj if use_kernel else ref.topj_all)(bits, alive, J)


def _fold_pairs(bits, alive, instr, use_kernel: bool) -> None:
    (bitset_fold if use_kernel else ref.fold_pairs)(bits, alive, instr)


def propose(state: dict, J: int, theta_p: int, height_bound, *,
            use_kernel: bool = True):
    """One proposal round over the resident ``state``, ranking J columns
    per row (J = min(top_j, G − 1)). Returns ``(rows, accept, partner)``
    on the device: the dirty rows (n, 2) int64 in row-major order, whether
    each row's best proposal passes θ̂, and its partner row.
    ``state["dirty"]`` is updated in place. The nonzero syncs with the
    host once."""
    faults.check("kernel.bitset_fold.round")
    rows = torch.nonzero(state["dirty"] > 0)
    cand = _topj_all(state["bits"], state["alive"], J,
                     use_kernel)[rows[:, 0], rows[:, 1]]
    has, numer, denom, z = rounds.round_from_ranked(state, rows, cand, J,
                                                    height_bound)
    ok = has & rounds.theta_accept(numer, denom, theta_p)
    # rows that were not dirty are untouched; dirty rows stay dirty iff
    # their proposal passed (the host rule)
    state["dirty"][rows[:, 0], rows[:, 1]] = ok.to(torch.int8)
    return rows, ok, z


def propose_dense(state: dict, J: int, theta_p: int, height_bound, *,
                  use_kernel: bool = True) -> torch.Tensor:
    """`propose` laid out over the whole state: ``(B, G, 3)`` int8, per row
    ``[was dirty, accept, partner]`` (zeros for rows that were not dirty).
    The per-rank body of the arena's proposal round under a mesh: its
    fixed shape lets the ranks all-gather it."""
    rows, ok, z = propose(state, J, theta_p, height_bound,
                         use_kernel=use_kernel)
    out = torch.zeros((*state["dirty"].shape, 3), dtype=torch.int8,
                      device=rows.device)
    out[rows[:, 0], rows[:, 1]] = torch.stack(
        [torch.ones_like(z), ok.to(z.dtype), z], 1).to(torch.int8)
    return out


def fold_shard(state: dict, b, slot, a, z, P: int, lo: int, *,
               use_kernel: bool = True) -> int:
    """The per-rank body of the arena's fold under a mesh: the pairs of
    groups ``lo .. lo + B`` (``B`` the state's groups; ``b`` global group
    ids) folded into ``state`` as `fold` folds them, the others skipped.
    The fault site is checked on every rank alike, pairs or none. Returns
    the pairs folded; with none, nothing launches."""
    faults.check("kernel.bitset_fold.fold_counts")
    B = state["bits"].shape[0]
    mine = (b >= lo) & (b < lo + B)
    if not bool(mine.any()):
        return 0
    _fold(state, b[mine] - lo, slot[mine], a[mine], z[mine], P, use_kernel)
    return int(mine.sum())


def fold(state: dict, b, slot, a, z, P: int, *,
         use_kernel: bool = True) -> None:
    """Fold one round's accepted pairs (``(m,)`` int64 tensors on the
    device: group, slot within the group's instruction rows, absorbing and
    absorbed row) into the whole resident state, in place. The bitmap fold
    runs first: its kernel writes only ``bits`` and ``alive``, which the
    count phases neither read nor need (both clear ``alive`` of the
    absorbed rows)."""
    faults.check("kernel.bitset_fold.fold_counts")
    _fold(state, b, slot, a, z, P, use_kernel)


def _fold(state: dict, b, slot, a, z, P: int, use_kernel: bool) -> None:
    memcol = state["memcol"]
    ca = memcol[b, a]
    cz = memcol[b, z]
    B = state["bits"].shape[0]
    instr = torch.zeros((B, P, 8), dtype=torch.int32, device=b.device)
    instr[b, slot] = torch.stack(
        [a.to(torch.int32), z.to(torch.int32), ca >> 5, ca & 31, cz >> 5,
         cz & 31, torch.ones_like(ca), torch.zeros_like(ca)], dim=1)
    _fold_pairs(state["bits"], state["alive"], instr, use_kernel)
    rounds.fold_counts(state, b, a, z)


def topj(state: dict, rows: torch.Tensor, J: int, *,
         use_kernel: bool = True) -> torch.Tensor:
    """The v1 ranking: every row's top-J columns over the resident
    bitmaps, gathered on the device at ``rows`` ((n, 2) int64 ``[group,
    row]``) → (n, J) int32."""
    faults.check("kernel.bitset_fold.topj")
    ranked = _topj_all(state["bits"], state["alive"], J, use_kernel)
    return ranked[rows[:, 0], rows[:, 1]]


def fold_bits(state: dict, instr: torch.Tensor, *,
              use_kernel: bool = True) -> None:
    """The v1 fold: a host-built ``(B, P, 8)`` int32 slab applied to the
    resident bitmaps and liveness only, in place."""
    faults.check("kernel.bitset_fold.fold")
    _fold_pairs(state["bits"], state["alive"], instr, use_kernel)


def extract(bank: dict, res_map, members, ptr, lens, total: int, R: int,
            Rp: int, Wp: int) -> dict:
    """`carry.bank_extract` behind its fault site: a chunk's arena state
    built on the device from the adjacency bank, which it only reads."""
    faults.check("kernel.bitset_fold.extract")
    return carry.bank_extract(bank, res_map, members, ptr, lens, total, R,
                              Rp, Wp)
