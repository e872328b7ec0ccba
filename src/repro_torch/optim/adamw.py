"""AdamW (the JAX package's `optim/adamw.py`).

State mirrors the parameters: ``{"m": tree, "v": tree, "step": int32}``,
moments in f32 or, with ``moment_dtype="bfloat16"``, stored in bf16 (the
math runs in f32 either way). Leaves are taken in the reference's flatten
order, sorted dict keys. Under ZeRO-1 (`train/train_step.py`) each rank
keeps only its slice of every moment — ``shards`` names, per leaf, the
``(dim, start, length)`` of that slice, or None where the moment is whole —
and updates only the matching slice of each parameter.

`apply_updates` updates parameters and moments IN PLACE, where the
reference returns new trees: a functional update would hold a second copy
of them on the card (≈ 34 GB more for qwen2.5-3b). Everything it reads
before the first write is computed first; a failure after the first write
raises `TornUpdate`, so a caller knows the state is half updated and must
not be stepped again (`train/fault_tolerance.ResilientLoop` restores it).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.transformer import DTYPES

# elements of a leaf updated at once: bounds the f32 temporaries of the
# update (a stacked (36, 2048, 11008) leaf would take ≈ 3.2 GB each)
SLICE_ELEMENTS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # f32 is the default; "bfloat16" halves the moments' memory and traffic
    # (only their storage: the math runs in f32)
    moment_dtype: str = "float32"


class TornUpdate(RuntimeError):
    """`apply_updates` failed after it began writing: parameters, moments
    and the step count are partly updated."""


def leaves(tree) -> list:
    """The tensors of a nested dict in the reference's flatten order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(tree, flat: list):
    """``tree``'s structure with its leaves taken from ``flat``, in
    `leaves` order (the inverse of `leaves`)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def _narrow(t: torch.Tensor, shard):
    return t if shard is None else t.narrow(*shard)


def init_state(params, moment_dtype: str = "float32", shards=None) -> dict:
    """Zero moments beside ``params`` (same shapes and devices, or the
    slices ``shards`` names) and a step count of 0."""
    dt = DTYPES[moment_dtype]
    flat = leaves(params)
    shards = shards or [None] * len(flat)

    def zeros():
        return unflatten(params, [
            torch.zeros(_narrow(p, s).shape, dtype=dt, device=p.device)
            for p, s in zip(flat, shards)])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}


def _slices(t: torch.Tensor) -> list:
    """Views of ``t`` along dim 0, each of at most `SLICE_ELEMENTS` (one
    row of dim 0 at the least)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMENTS:
        return [t]
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return list(t.split(rows))


def _sq(g: torch.Tensor) -> torch.Tensor:
    return sum(torch.square(s.float()).sum() for s in _slices(g))


def global_norm(tree, axes=None) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, squares and sums in f32. Under a model
    axis, ``axes`` names per leaf (`leaves` order) the `models.sharding.
    Axis` over which the ranks hold its blocks, or None where every rank
    holds it whole: the squares of the leaves on one axis are SUMmed over
    it (each block counted once), the whole leaves counted once."""
    flat = leaves(tree)
    if axes is None:
        return torch.sqrt(sum(torch.square(s.float()).sum()
                              for g in flat for s in _slices(g)))
    parts = {}  # id(axis) -> [axis, this rank's Σ g²]
    for g, ax in zip(flat, axes):
        entry = parts.setdefault(id(ax), [ax, 0.0])
        entry[1] = entry[1] + _sq(g)
    return torch.sqrt(sum(sq if ax is None else ax.sum(sq)
                          for ax, sq in parts.values()))


def _update(p, g, m, v, cfg, scale, b1c, b2c, lr):
    """One slice: the reference's arithmetic in f32, written back in place
    in each tensor's own dtype."""
    g = g.float() * scale
    m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v2 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
    mhat = m2 / b1c
    vhat = v2 / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
        + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)
    m.copy_(m2)
    v.copy_(v2)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig, lr_scale=1.0,
                  shards=None, norm_axes=None):
    """One AdamW step IN PLACE on ``params`` and ``opt_state`` (``grads``
    in the tree of ``params``, any float dtype): the update clipped to a
    global norm of ``cfg.grad_clip`` (over the whole ``grads``; across
    the ranks' blocks with ``norm_axes``, `global_norm`'s ``axes``),
    bias-corrected at the incremented step, learning rate ``cfg.lr ·
    lr_scale``. With ``shards`` only the named slice of each parameter is
    updated, against moments that hold that slice. Returns the metrics
    ``{"grad_norm", "lr"}`` (0-d f32 tensors). Raises `TornUpdate` if a
    write fails part way."""
    gnorm = global_norm(grads, norm_axes)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = opt_state["step"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)
    ps_, gs_ = leaves(params), leaves(grads)
    shards = shards or [None] * len(ps_)
    flat = list(zip([_narrow(p, s) for p, s in zip(ps_, shards)],
                    [_narrow(g, s) for g, s in zip(gs_, shards)],
                    leaves(opt_state["m"]), leaves(opt_state["v"])))
    try:
        for p, g, m, v in flat:
            for ps, gs, ms, vs in zip(*(_slices(t) for t in (p, g, m, v))):
                _update(ps, gs, ms, vs, cfg, scale, b1c, b2c, lr)
        opt_state["step"].copy_(step)
    except Exception as e:
        raise TornUpdate(f"AdamW update failed part way: {e!r}") from e
    return {"grad_norm": gnorm, "lr": lr}
