"""The train step (the JAX package's `train/train_step.py`): loss,
gradients by autograd, optional microbatch accumulation in f32, the
cosine schedule and an in-place AdamW update — on one device, or
data-parallel over a mesh's data axis with ZeRO-1.

State is ``{"params": tree, "opt": {"m", "v", "step"}}`` (`init_state`),
the reference's tree. Under ``plan.mesh`` (SPMD, one rank a device) every
rank holds the whole parameters and its batch rows (`data.pipeline`'s
``mesh=``); the step runs `loss_and_grads` on those rows, SUM all-reduces
the gradients over the data group and divides them by its size (the
mean), clips by the global norm of the reduced gradients, and updates
only this rank's ZeRO-1 slice of each moment (`zero1_shards`, from
`models.sharding.zero1_spec`) and the matching parameter slice; the
parameter slices are then all-gathered, so every rank ends the step with
the same parameters. A model axis above 1 in training is slice E6b and
raises.

`build_serve_step` is the reference's serving step under a mesh (slice
E6a): prefill or decode on the rank's blocks of the parameters and the
cache, tensor- and expert-parallel over the model axis, the batch over
the data axes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import (all_gather_rows, dp_group, dp_rank,
                                     dp_size, mesh_sizes)
from repro_torch.models import sharding as SH
from repro_torch.models.api import lm_loss
from repro_torch.optim import adamw, schedules


@dataclass
class TrainPlan:
    cfg: ModelConfig
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    # grad-accumulation microbatch (rows of the global batch)
    microbatch: Optional[int] = None
    warmup: int = 100
    total_steps: int = 10_000
    mesh: object = None                # a DeviceMesh (launch/mesh.py)
    dp_axes: tuple = ("data",)


def state_specs(plan: TrainPlan, params) -> dict:
    """Specs for ``{params, opt{m, v, step}}``: `sharding.param_pspecs`
    of the parameters, `sharding.zero1_spec` of each moment."""
    pspecs = SH.param_pspecs(plan.cfg, params, plan.mesh, plan.dp_axes)
    mspecs = adamw.unflatten(params, [
        SH.zero1_spec(s, tuple(p.shape), plan.mesh, plan.dp_axes)
        for s, p in zip(adamw.leaves(pspecs), adamw.leaves(params))])
    return {"params": pspecs, "opt": {"m": mspecs, "v": mspecs, "step": ()}}


def _check_plan(plan: TrainPlan) -> None:
    if plan.mesh is not None and mesh_sizes(plan.mesh).get("model", 1) > 1:
        raise NotImplementedError(
            "a model axis above 1: tensor and expert parallelism in the "
            "train step is slice E6b (serving under a model axis is "
            "build_serve_step)")


def zero1_shards(plan: TrainPlan, params) -> list:
    """Per leaf of ``params`` (`adamw.leaves` order): ``(dim, start,
    length)`` of this rank's ZeRO-1 moment slice — the dim `zero1_spec`
    puts the data axes on, split in the data group's rank order — or None
    where the moment stays whole (no mesh, or no dim divides)."""
    flat = adamw.leaves(params)
    if plan.mesh is None:
        return [None] * len(flat)
    _check_plan(plan)
    dp = tuple(plan.dp_axes)
    n, r = dp_size(plan.mesh, dp), dp_rank(plan.mesh, dp)
    out = []
    for p, spec in zip(flat, adamw.leaves(
            state_specs(plan, params)["opt"]["m"])):
        dims = [i for i, ax in enumerate(spec) if ax is not None and set(
            ax if isinstance(ax, tuple) else (ax,)) & set(dp)]
        if not dims:
            out.append(None)
            continue
        length = p.shape[dims[0]] // n
        out.append((dims[0], r * length, length))
    return out


def init_state(params, opt: adamw.AdamWConfig = adamw.AdamWConfig(),
               plan: TrainPlan = None) -> dict:
    """A train state around ``params`` (kept, not copied) with zero
    moments — this rank's ZeRO-1 slices of them under ``plan.mesh``."""
    shards = zero1_shards(plan, params) if plan is not None else None
    return {"params": params, "opt": adamw.init_state(params,
                                                      opt.moment_dtype,
                                                      shards)}


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
    `adamw.TornUpdate`.

    Under ``plan.mesh`` the step is data-parallel with ZeRO-1 (module
    docstring): ``batch`` holds this rank's rows, ``plan.microbatch``
    counts rows of the global batch, and the loss metric is the mean of
    the ranks' losses. The state must come from ``init_state(..., plan=
    plan)``."""
    cfg = train_config(plan.cfg)
    mesh, dp = plan.mesh, tuple(plan.dp_axes)
    group, n = None, 1
    if mesh is not None:
        _check_plan(plan)
        group, n = dp_group(mesh, dp), dp_size(mesh, dp)
    shards = []  # per leaf, computed at the first step

    def grads_of(params, batch):
        rows = next(iter(batch.values())).shape[0]
        mb = plan.microbatch or rows * n
        if mb % n or rows % (mb // n):
            raise ValueError(f"batch of {rows} rows on each of {n} ranks "
                             f"does not split into microbatches of {mb}")
        mb //= n
        nmicro = rows // mb
        if nmicro == 1:
            return loss_and_grads(params, cfg, batch)
        flat, loss = None, 0.0
        for i in range(nmicro):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l, g = loss_and_grads(params, cfg, part)
            flat = ([t.float() for t in g] if flat is None
                    else [a + t for a, t in zip(flat, g)])
            loss = loss + l
        return loss / nmicro, [g / nmicro for g in flat]

    def step(state, batch):
        params, opt = state["params"], state["opt"]
        if mesh is None:
            loss, flat = grads_of(params, batch)
        else:
            with SH.mesh_context(mesh, dp, blocks=False):
                loss, flat = grads_of(params, batch)
            if not shards:
                shards.extend(zero1_shards(plan, params))
            for g in flat:  # the mean of the ranks' gradients
                dist.all_reduce(g, group=group)
                g.div_(n)
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / n
        grads = adamw.unflatten(params, flat)
        lr_scale = schedules.cosine_with_warmup(
            opt["step"], warmup=plan.warmup, total=plan.total_steps)
        metrics = adamw.apply_updates(params, grads, opt, plan.opt, lr_scale,
                                      shards=shards or None)
        if mesh is not None:
            _gather_params(params, shards, group, n)
        metrics["loss"] = loss
        return state, metrics

    return step


@torch.no_grad()
def _gather_params(params, shards, group, n) -> None:
    """After a ZeRO-1 update every rank holds its slice of each sharded
    parameter fresh: all-gather the slices back into every rank's whole
    parameter, in the group's rank order. A failure here leaves the ranks'
    parameters apart, so it raises `adamw.TornUpdate`."""
    try:
        for p, s in zip(adamw.leaves(params), shards):
            if s is None:
                continue
            dim, start, length = s
            local = p.narrow(dim, start, length).contiguous()
            if dim == 0:
                all_gather_rows(p, local, group)
                continue
            parts = [torch.empty_like(local) for _ in range(n)]
            dist.all_gather(parts, local, group=group)
            p.copy_(torch.cat(parts, dim=dim))
    except Exception as e:
        raise adamw.TornUpdate(f"ZeRO-1 parameter gather failed: {e!r}") \
            from e


def batch_specs(cfg: ModelConfig, mesh, dp_axes, batch: dict) -> dict:
    """The spec of each input of a step: its rows over the data axes
    where they divide (`sharding.batch_pspec`), the rest replicated."""
    out = {}
    for k, v in batch.items():
        rows = SH.batch_pspec(mesh, dp_axes, v[0])
        out[k] = rows + (None,) * (len(v) - 2)
    return out


def build_serve_step(cfg: ModelConfig, mesh, dp_axes, shape,
                     absorbed_mla: bool = False):
    """The reference's prefill or decode step (kind from ``shape``, a
    `configs.base.ShapeConfig`) on ``mesh``, SPMD: returns ``(fn,
    param_specs, input_specs, param_shapes)``.

    Every rank passes its blocks of the parameters (`sharding.
    shard_params`, `interop.params_from_arrays(..., mesh=)` or
    `init_params(..., mesh=)`) and its rows of each input
    (`sharding.batch_pspec` over ``shape.global_batch``). Prefill: ``fn(
    params, batch, cache_len=None) -> (logits[:, -1:], cache)``, the
    cache the rank's blocks (`sharding.cache_pspecs`) of ``cache_len``
    slots (default: the prompt's length). Decode: ``fn(params, cache,
    token, pos) -> (logits, cache)`` over a cache of ``shape.seq_len``
    slots, updated IN PLACE. Logits are the rank's rows, every vocabulary
    column. ``absorbed_mla`` sets the reference's ``_absorbed_mla``
    switch on ``cfg``, as the reference does."""
    from repro_torch.models.api import get_api, param_shapes

    api = get_api(cfg)
    dp = tuple(dp_axes)
    shapes = param_shapes(cfg)
    pspecs = SH.param_pspecs(cfg, shapes, mesh, dp)
    B, S = shape.global_batch, shape.seq_len
    if absorbed_mla:
        object.__setattr__(cfg, "_absorbed_mla", True)
    if shape.kind == "prefill":
        d = cfg.d_model
        if cfg.encoder_layers:
            inputs = {"frames": (B, S, d), "tokens": (B, S)}
        elif cfg.n_patches:
            inputs = {"embeds": (B, cfg.n_patches, d),
                      "tokens": (B, S - cfg.n_patches)}
        else:
            inputs = {"tokens": (B, S)}

        def prefill_step(params, batch, cache_len=None):
            with SH.mesh_context(mesh, dp, batch=B):
                logits, cache = api.prefill(params, cfg, batch, cache_len)
                return logits[:, -1:], cache

        return prefill_step, pspecs, batch_specs(cfg, mesh, dp, inputs), \
            shapes

    cshapes = cache_shapes(cfg, B, S)
    cspecs = SH.cache_pspecs(cfg, cshapes, mesh, dp, B)

    def decode(params, cache, token, pos):
        with SH.mesh_context(mesh, dp, batch=B, cache=cspecs):
            return api.decode_step(params, cfg, cache, token, pos)

    return decode, pspecs, {"cache": cspecs,
                            "token": SH.batch_pspec(mesh, dp, B),
                            "pos": ()}, shapes


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """The whole decode cache's shapes of ``cfg``'s family: an
    encoder-decoder's cross cache holds ``cache_len`` encoder positions,
    as the reference's ``input_specs`` makes it."""
    from repro_torch.models import encdec, transformer

    if cfg.encoder_layers:
        return encdec.cache_shapes(cfg, batch, cache_len, cache_len)
    return transformer.cache_shapes(cfg, batch, cache_len)
