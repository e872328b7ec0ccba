"""Dispatch of the resident merge round's two device ops (DESIGN.md §9).

`ResidentBitmapArena` (core/resident.py) calls, per round of a chunk:

* `propose` — the fused proposal round: the dirty-row list from the
  arena's own ``dirty`` mirror (`torch.nonzero`, row-major — exactly the
  host's ``np.nonzero``), the ranked candidates of every row from the
  `jaccard_topj` kernel, the exact integer Saving and θ̂ acceptance of the
  dirty rows (`rounds.round_from_ranked`), and the ``dirty`` update (rows
  whose best Saving fails θ̂ leave the queue, as in the host sweep).
* `fold` — the count-carrying fold of the round's accepted pairs: the
  count phases (`rounds.fold_counts`), then the `bitset_fold` kernel on the
  ``(B, P, 8)`` instruction slab built on the device from the resident
  member columns.

The bank → arena extraction is `carry.bank_extract`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitset_fold import rounds
from repro_torch.kernels.bitset_fold.kernel import bitset_fold, jaccard_topj


def propose(state: dict, J: int, theta_p: int, height_bound):
    """One proposal round over the resident ``state``, ranking J columns
    per row (J = min(top_j, G − 1)). Returns ``(rows, accept, partner)``
    on the device: the dirty rows (n, 2) int64 in row-major order, whether
    each row's best proposal passes θ̂, and its partner row.
    ``state["dirty"]`` is updated in place. The nonzero syncs with the
    host once."""
    rows = torch.nonzero(state["dirty"] > 0)
    cand = jaccard_topj(state["bits"], state["alive"], J)[rows[:, 0],
                                                          rows[:, 1]]
    has, numer, denom, z = rounds.round_from_ranked(state, rows, cand, J,
                                                    height_bound)
    ok = has & rounds.theta_accept(numer, denom, theta_p)
    # rows that were not dirty are untouched; dirty rows stay dirty iff
    # their proposal passed (the host rule)
    state["dirty"][rows[:, 0], rows[:, 1]] = ok.to(torch.int8)
    return rows, ok, z


def fold(state: dict, b, slot, a, z, P: int) -> None:
    """Fold one round's accepted pairs (``(m,)`` int64 tensors on the
    device: group, slot within the group's instruction rows, absorbing and
    absorbed row) into the whole resident state, in place."""
    memcol = state["memcol"]
    ca = memcol[b, a]
    cz = memcol[b, z]
    rounds.fold_counts(state, b, a, z)
    B = state["bits"].shape[0]
    instr = torch.zeros((B, P, 8), dtype=torch.int32, device=b.device)
    instr[b, slot] = torch.stack(
        [a.to(torch.int32), z.to(torch.int32), ca >> 5, ca & 31, cz >> 5,
         cz & 31, torch.ones_like(ca), torch.zeros_like(ca)], dim=1)
    bitset_fold(state["bits"], state["alive"], instr)
