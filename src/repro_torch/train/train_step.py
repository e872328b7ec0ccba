"""The train step (the JAX package's `train/train_step.py`): loss,
gradients by autograd, optional microbatch accumulation in f32, the
cosine schedule and an in-place AdamW update — on one device,
data-parallel over a mesh's data axes with ZeRO-1, or tensor- and
expert-parallel over its model axis as well.

State is ``{"params": tree, "opt": {"m", "v", "step"}}`` (`init_state`),
the reference's tree. Under ``plan.mesh`` (SPMD, one rank a device) every
rank holds its batch rows (`data.pipeline`'s ``mesh=``), and:

- with a model axis of 1, the whole parameters: the step runs
  `loss_and_grads` on its rows, SUM all-reduces the gradients over the
  data group and divides them by its size (the mean), clips by the global
  norm of the reduced gradients, and updates only this rank's ZeRO-1
  slice of each moment (`zero1_shards`, from `models.sharding.zero1_spec`)
  and the matching parameter slice; the parameter slices are then
  all-gathered over the data group, so every rank ends the step with the
  same parameters;
- with a model axis above 1, the rank's blocks of the parameters under
  `sharding.param_pspecs` (`sharding.shard_params`, `init_params(mesh=)`;
  ``cfg.fsdp``'s data blocks too) and of the moments under `zero1_spec`
  on top of them: `loss_and_grads` runs under ``mesh_context(...,
  blocks=True)`` and seeds each rank's backward with 1/m of the loss
  (`models.sharding`'s gradient convention). Each leaf's gradient is then
  SUMmed over the mesh axes its spec replicates it on (`grad_sums`): the
  leaves replicated everywhere in one collective over the whole mesh,
  the blocks over the data group, ``fsdp``'s data blocks (SUMmed over
  data by their gather's backward) over what is left; every one divided
  by the data size. The norm counts each block once (`norm_axes`), and
  the ZeRO-1 slices are cut from the local blocks and gathered back over
  the data axes only.

`build_serve_step` is the reference's serving step under a mesh (slice
E6a): prefill or decode on the rank's blocks of the parameters and the
cache, tensor- and expert-parallel over the model axis, the batch over
the data axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import (all_gather_rows, axes_group, dp_group,
                                     dp_size, mesh_sizes, model_size)
from repro_torch.models import sharding as SH
from repro_torch.models.api import lm_loss, param_shapes
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


def state_specs(plan: TrainPlan, params=None) -> dict:
    """Specs for ``{params, opt{m, v, step}}`` as the step holds them on
    ``plan.mesh``: `sharding.param_pspecs` of the parameters under a model
    axis (``()``, whole, under a model axis of 1, where the data-parallel
    step keeps them whole), `sharding.zero1_spec` of each moment on top of
    its `param_pspecs`. ``params``: the whole parameters or their shapes
    (default: ``cfg``'s)."""
    if params is None:
        params = param_shapes(plan.cfg)
    pspecs = SH.param_pspecs(plan.cfg, params, plan.mesh, plan.dp_axes)
    mspecs = adamw.unflatten(params, [
        SH.zero1_spec(s, tuple(SH._shape(p)), plan.mesh, plan.dp_axes)
        for s, p in zip(adamw.leaves(pspecs), adamw.leaves(params))])
    if not model_parallel(plan):
        pspecs = adamw.unflatten(params, [()] * len(adamw.leaves(params)))
    return {"params": pspecs, "opt": {"m": mspecs, "v": mspecs, "step": ()}}


def model_parallel(plan: TrainPlan) -> bool:
    """Whether ``plan`` trains under a model axis above 1: each rank then
    holds its blocks of the parameters and moments."""
    return plan.mesh is not None and model_size(plan.mesh) > 1


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _zero1_layout(plan: TrainPlan, params) -> list:
    """Per leaf: ``((dim, start, length), axes)`` of this rank's ZeRO-1
    slice of its local parameter and the mesh axes it is split over, or
    ``(None, ())``."""
    flat = adamw.leaves(params)
    if plan.mesh is None:
        return [(None, ())] * len(flat)
    specs = state_specs(plan)
    blocks = model_parallel(plan)
    sizes, coords = mesh_sizes(plan.mesh), SH.mesh_coords(plan.mesh)
    dp = set(plan.dp_axes)
    out = []
    for p, ps, ms in zip(flat, adamw.leaves(specs["params"]),
                         adamw.leaves(specs["opt"]["m"])):
        hit = None
        for dim, me in enumerate(ms):
            # the data axes that cut the moment further than the local
            # parameter (whole, or its blocks); under a model axis one of
            # a single rank cuts nothing
            held = _names(ps[dim]) if dim < len(ps) else ()
            names = tuple(a for a in _names(me) if a in dp and a not in held
                          and (sizes[a] > 1 or not blocks))
            if names:
                hit = dim, names
                break
        if hit is None:
            out.append((None, ()))
            continue
        dim, names = hit
        parts, idx = 1, 0
        for a in names:
            parts, idx = parts * sizes[a], idx * sizes[a] + coords[a]
        length = p.shape[dim] // parts
        out.append(((dim, idx * length, length), names))
    return out


def zero1_shards(plan: TrainPlan, params) -> list:
    """Per leaf of ``params`` (`adamw.leaves` order; this rank's blocks
    under a model axis): ``(dim, start, length)`` of this rank's ZeRO-1
    moment slice of it — the dim `zero1_spec` puts data axes on that the
    local parameter does not already split, cut in row-major order over
    them (the data group's rank order) — or None where the moment stays
    whole (no mesh, or no dim divides)."""
    return [s for s, _ in _zero1_layout(plan, params)]


def grad_sums(cfg: ModelConfig, mesh, dp_axes, params=None) -> list:
    """Per leaf (`adamw.leaves` order) of ``params`` (whole, or their
    shapes; default ``cfg``'s): the mesh axes above one rank that its spec
    (`param_pspecs`) does not split it on, in the mesh's order — the axes
    its gradient is SUMmed over (`models.sharding`'s gradient
    convention)."""
    sizes = mesh_sizes(mesh)
    params = param_shapes(cfg) if params is None else params
    return [tuple(a for a in sizes if sizes[a] > 1 and a not in set(
        n for e in spec for n in _names(e)))
        for spec in adamw.leaves(SH.param_pspecs(cfg, params, mesh,
                                                 dp_axes))]


def norm_axes(cfg: ModelConfig, mesh, dp_axes, params=None) -> list:
    """Per leaf: the mesh axes above one rank that its spec splits it on,
    whose ranks' squared norms `adamw.global_norm` SUMs (each block
    counted once)."""
    sizes = mesh_sizes(mesh)
    return [tuple(a for a in sizes if sizes[a] > 1 and a not in s)
            for s in grad_sums(cfg, mesh, dp_axes, params)]


def reduce_grads(flat: list, sums: list, n: int) -> list:
    """``flat`` (gradients in `adamw.leaves` order) SUMmed over each
    leaf's axes ``sums`` (`grad_sums`) through the active layout's axes
    (`sharding.Layout.axis`) and divided by ``n``, the data size: the
    leaves summed over every axis in one packed collective (two under
    per-rank bodies, which have no group over the model and data axes
    together: the model's, then the data's), the others a collective
    each."""
    lay = SH.layout()
    every = set(a for s in sums for a in s)
    whole = [i for i, s in enumerate(sums) if s and set(s) == every]
    if whole:
        summed = [flat[i] for i in whole]
        for names in (({"model"} & every, every - {"model"})
                      if isinstance(lay.mesh, dict) else (every,)):
            if names:
                summed = lay.axis(tuple(names)).sum_all(*summed)
        for i, g in zip(whole, summed):
            flat[i] = g
    for i, s in enumerate(sums):
        if s and set(s) != every:
            flat[i] = lay.axis(s).sum(flat[i])
    if n > 1:
        flat = [g.div_(n) for g in flat]
    return flat


def _check_blocks(plan: TrainPlan, params) -> None:
    """Under a model axis: raise unless every leaf of ``params`` has the
    shape of a rank's block under `state_specs`."""
    sizes = mesh_sizes(plan.mesh)
    shapes = adamw.leaves(param_shapes(plan.cfg))
    for p, shape, spec in zip(adamw.leaves(params), shapes, adamw.leaves(
            state_specs(plan)["params"])):
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        want = tuple(n // math.prod(sizes[a] for a in _names(e))
                     for n, e in zip(shape, spec))
        if tuple(p.shape) != want:
            raise ValueError(
                f"a leaf of shape {tuple(p.shape)} where the rank's block "
                f"is {want}: under a model axis the parameters are the "
                f"rank's blocks (sharding.shard_params, init_params(mesh=))")


def init_state(params, opt: adamw.AdamWConfig = adamw.AdamWConfig(),
               plan: TrainPlan = None) -> dict:
    """A train state around ``params`` (kept, not copied) with zero
    moments — this rank's ZeRO-1 slices of them under ``plan.mesh``.
    Under a model axis ``params`` must be the rank's blocks."""
    if plan is not None and model_parallel(plan):
        _check_blocks(plan, params)
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
    duration of the call. Under a model axis of m (the active layout's)
    the backward is seeded with 1/m of the loss, so each gradient is this
    rank's share (`models.sharding`'s convention); the loss returned is
    the whole. Under a mesh context the backward runs on the calling
    thread: the layout is thread-local, and the recompute of remat'd
    layers and loss chunks reads it, where autograd would run a CUDA
    backward on its own device thread."""
    flat = adamw.leaves(params)
    m = SH.model_axis().size
    here = (torch.autograd.set_multithreading_enabled(False)
            if SH.current() is not None else contextlib.nullcontext())
    for t in flat:
        t.requires_grad_(True)
    try:
        loss = lm_loss(params, cfg, batch)
        with here:
            grads = torch.autograd.grad(loss if m == 1 else loss / m, flat,
                                        materialize_grads=True)
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
    before the update leaves ``state`` as it was; one during the update
    or the parameter gather raises `adamw.TornUpdate`.

    Under ``plan.mesh`` the step is data-parallel with ZeRO-1, and under
    a model axis above 1 tensor- and expert-parallel too (module
    docstring): ``batch`` holds this rank's rows, ``params`` its blocks
    under a model axis, ``plan.microbatch`` counts rows of the global
    batch (one narrower than the data axis runs a row a rank at a time),
    and the loss metric is the mean of the data ranks' losses, the
    same on every rank. The state must come from ``init_state(...,
    plan=plan)``."""
    cfg = train_config(plan.cfg)
    mesh, dp = plan.mesh, tuple(plan.dp_axes)
    if isinstance(mesh, dict):
        raise ValueError(
            f"a train step on {mesh} needs a DeviceMesh over a process "
            f"group (launch.mesh.make_host_mesh); a plain mapping has no "
            f"ranks to reduce over")
    blocks = model_parallel(plan)
    group, n = None, 1
    if mesh is not None:
        group, n = dp_group(mesh, dp), dp_size(mesh, dp)
    sums = grad_sums(cfg, mesh, dp) if blocks else None
    held = norm_axes(cfg, mesh, dp) if blocks else None
    shards, groups = [], []  # per leaf, computed at the first step

    def grads_of(params, batch):
        rows = next(iter(batch.values())).shape[0]
        mb = plan.microbatch or rows * n
        # a microbatch narrower than the data axis: one row a rank at a time
        local = max(1, mb // n)
        if (mb > n and mb % n) or rows % local:
            raise ValueError(f"batch of {rows} rows on each of {n} ranks "
                             f"does not split into microbatches of {mb}")
        mb = local
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
        norms = None
        if mesh is None:
            loss, flat = grads_of(params, batch)
        elif blocks:
            with SH.mesh_context(mesh, dp):
                loss, flat = grads_of(params, batch)
                flat = reduce_grads(flat, sums, n)
                lay = SH.layout()
                norms = [lay.axis(a) if a else None for a in held]
                loss = lay.data.sum(loss) / n
        else:
            with SH.mesh_context(mesh, dp, blocks=False):
                loss, flat = grads_of(params, batch)
            for g in flat:  # the mean of the ranks' gradients
                dist.all_reduce(g, group=group)
                g.div_(n)
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / n
        if mesh is not None and not shards:
            for shard, names in _zero1_layout(plan, params):
                shards.append(shard)
                groups.append(axes_group(mesh, names) if names else None)
        grads = adamw.unflatten(params, flat)
        lr_scale = schedules.cosine_with_warmup(
            opt["step"], warmup=plan.warmup, total=plan.total_steps)
        metrics = adamw.apply_updates(params, grads, opt, plan.opt, lr_scale,
                                      shards=shards or None, norm_axes=norms)
        if mesh is not None:
            _gather_params(params, shards, groups)
        metrics["loss"] = loss
        return state, metrics

    return step


@torch.no_grad()
def _gather_params(params, shards, groups) -> None:
    """After a ZeRO-1 update every rank holds its slice of each sharded
    parameter (or block) fresh: all-gather the slices back into every
    rank's whole parameter, over the leaf's data group (``groups``), in
    its rank order. A failure here leaves the ranks' parameters apart, so
    it raises `adamw.TornUpdate`."""
    try:
        for p, s, group in zip(adamw.leaves(params), shards, groups):
            if s is None:
                continue
            dim, start, length = s
            local = p.narrow(dim, start, length).contiguous()
            if dim == 0:
                all_gather_rows(p, local, group)
                continue
            parts = [torch.empty_like(local)
                     for _ in range(dist.get_world_size(group))]
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
