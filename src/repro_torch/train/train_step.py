"""The train step on one device (the JAX package's `train/train_step.py`
without the mesh and its shardings, which belong to the multi-device
slice): loss, gradients by autograd, optional microbatch accumulation in
f32, the cosine schedule and an in-place AdamW update.

State is ``{"params": tree, "opt": {"m", "v", "step"}}`` (`init_state`),
the reference's tree. The serving path (`launch/serve.py`) has its own
driver, so ``build_serve_step`` has no counterpart here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import lm_loss
from repro_torch.optim import adamw, schedules


@dataclass
class TrainPlan:
    cfg: ModelConfig
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatch: Optional[int] = None   # grad-accumulation microbatch (rows)
    warmup: int = 100
    total_steps: int = 10_000


def init_state(params, opt: adamw.AdamWConfig = adamw.AdamWConfig()) -> dict:
    """A train state around ``params`` (kept, not copied) with zero
    moments."""
    return {"params": params, "opt": adamw.init_state(params,
                                                      opt.moment_dtype)}


def train_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with ``attn_impl="xla_chunked"``: training attends through the
    plain chunked twin (the reference's default), because the flash kernel
    has no backward (it raises on inputs that require grad). Raises on an
    ``attn_impl`` that names neither path."""
    if cfg.attn_impl not in ("pallas_flash", "xla_chunked"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; use "
                         f"'pallas_flash' or 'xla_chunked'")
    return dataclasses.replace(cfg, attn_impl="xla_chunked")


def loss_and_grads(params, cfg: ModelConfig, batch):
    """`lm_loss` of ``batch`` and its gradients, one for each leaf of
    ``params`` in `adamw.leaves` order (zeros for a leaf the loss does
    not use), in the leaves' dtypes. The leaves require grad only for the
    duration of the call."""
    flat = adamw.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    try:
        loss = lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    finally:
        for t in flat:
            t.requires_grad_(False)
    return loss.detach(), list(grads)


def build_train_step(plan: TrainPlan):
    """``step(state, batch) -> (state, metrics)``: the reference's step on
    one device. ``state`` is updated IN PLACE and returned; metrics are
    ``loss``, ``grad_norm`` and ``lr`` (0-d f32 tensors). The learning
    rate's schedule reads the step count from before the update, so step
    0's is 0 under warmup. With ``plan.microbatch`` the batch's rows are
    taken ``microbatch`` at a time, gradients summed in f32 and averaged.
    Attention runs through the chunked twin (`train_config`). A failure
    before the update leaves ``state`` as it was; one during it raises
    `adamw.TornUpdate`."""
    cfg = train_config(plan.cfg)

    def step(state, batch):
        params, opt = state["params"], state["opt"]
        rows = next(iter(batch.values())).shape[0]
        mb = plan.microbatch or rows
        if rows % mb:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"microbatches of {mb}")
        nmicro = rows // mb
        if nmicro == 1:
            loss, flat = loss_and_grads(params, cfg, batch)
        else:
            flat, loss = None, 0.0
            for i in range(nmicro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = loss_and_grads(params, cfg, part)
                flat = ([t.float() for t in g] if flat is None
                        else [a + t for a, t in zip(flat, g)])
                loss = loss + l
            flat = [g / nmicro for g in flat]
            loss = loss / nmicro
        grads = adamw.unflatten(params, flat)
        lr_scale = schedules.cosine_with_warmup(
            opt["step"], warmup=plan.warmup, total=plan.total_steps)
        metrics = adamw.apply_updates(params, grads, opt, plan.opt, lr_scale)
        metrics["loss"] = loss
        return state, metrics

    return step
