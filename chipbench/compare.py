"""The numbers that decide `correct`, worked out from what the timed path
served and left and what the reference computes from the same inputs:

- ``tok_own``: over every request answered in the window, the widest gap
  by which the program's own first-token logit of the token it served
  lies below its own best logit. Exact: a token altered between the
  logits and the answer, or read back into another slot, shows here.

Over every request of the compared batches:

- ``tok_gap``: the widest gap by which the reference's logit of a served
  token lies below the reference's best logit; ``tok_gap_med`` that gap
  of the median request (the lower middle one).
- ``tok_miss``: the share of requests whose served token is not the
  reference's best.
- ``logit_rel``: the widest relative L2 distance of a request's served
  first-token logits from the reference's; ``logit_rel_med`` the median
  request's.
- ``cache_rel``: the relative L2 distance from the reference's of the
  cache that the prefill left for the next turn, of the worst (slot,
  entry, layer); ``cache_rel0`` the worst slot's at the first layer;
  ``cache_rel_med`` the worst slot's at its median layer;
  ``cache_rel_batch`` that of the worst (batch, entry, layer), taken over
  the whole batch.

The numbers that decide `correct` are those that ``limits/<cell>.json``
gives a limit; each is held to it.
"""
from __future__ import annotations

import torch

NAMES = ("tok_own", "tok_gap", "tok_gap_med", "tok_miss", "logit_rel",
         "logit_rel_med", "cache_rel", "cache_rel0", "cache_rel_med",
         "cache_rel_batch")


def _rel_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative L2 distance of ``a`` from ``b``, one a row (leading axis)."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return (torch.linalg.vector_norm(a - b, dim=1)
            / torch.linalg.vector_norm(b, dim=1).clamp_min(1e-30))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(_rel_rows(a.reshape(1, -1), b.reshape(1, -1))[0])


def _median(xs: list) -> float:
    return sorted(xs)[(len(xs) - 1) // 2]


def own_gaps(served, logits) -> list:
    """``logits`` (b, V) that served ``served`` (b,): each row's best logit
    less its logit at the served token."""
    served = torch.as_tensor(served, device=logits.device).long().view(-1, 1)
    return (logits.max(-1).values - logits.gather(1, served)[:, 0]).tolist()


def reading(served, logits, cache, ref) -> dict:
    """One compared batch. ``served``: (b,) token ids; ``logits``: (b, V)
    over the vocabulary; ``cache``: ``{name: get(layer) -> (b, s, ·)}``;
    ``ref``: the reference's `forward` result on the same ids. Returns
    per-request gaps, misses and logit distances, per layer the worst
    slot's cache distance and the whole batch's, and per slot its median
    layer's."""
    rl = ref["logits"]
    served = torch.as_tensor(served, device=rl.device).long().view(-1, 1)
    gaps = rl.max(-1).values - rl.gather(1, served)[:, 0]
    n_layers = len(next(iter(ref["cache"].values())))
    slots = torch.stack([   # (layer, slot), the worse entry
        torch.stack([_rel_rows(cache[name](i), got[i])
                     for name, got in ref["cache"].items()]).amax(0)
        for i in range(n_layers)]).cpu()
    return {"gaps": gaps.tolist(),
            "miss": (served[:, 0] != rl.argmax(-1)).tolist(),
            "rows": _rel_rows(logits, rl).tolist(),
            "layers": slots.amax(1).tolist(),
            "batch_layers": [max(_rel(cache[name](i), got[i])
                                 for name, got in ref["cache"].items())
                             for i in range(n_layers)],
            "slot_meds": slots.quantile(0.5, dim=0,
                                        interpolation="lower").tolist()}


def numbers(readings: list, own: list) -> dict:
    """Each number: ``own`` gaps of every answered request, the compared
    requests pooled, each layer at its worst slot."""
    gaps = [g for r in readings for g in r["gaps"]]
    rows = [x for r in readings for x in r["rows"]]
    miss = [m for r in readings for m in r["miss"]]
    layers = [max(col) for col in zip(*(r["layers"] for r in readings))]
    return {"tok_own": max(own), "tok_gap": max(gaps),
            "tok_gap_med": _median(gaps), "tok_miss": sum(miss) / len(miss),
            "logit_rel": max(rows), "logit_rel_med": _median(rows),
            "cache_rel": max(layers), "cache_rel0": layers[0],
            "cache_rel_med": max(m for r in readings for m in r["slot_meds"]),
            "cache_rel_batch": max(x for r in readings
                                   for x in r["batch_layers"])}


def verdict(values: dict, limits: dict) -> tuple:
    """``(every number within its limit, {name: [value, limit]})`` over
    the numbers ``limits`` names."""
    checks = {n: [values[n], float(lim)] for n, lim in limits.items()}
    return all(v <= lim for v, lim in checks.values()), checks
