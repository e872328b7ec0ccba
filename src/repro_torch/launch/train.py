"""End-to-end training driver (the JAX package's `launch/train.py`).

    python -m repro_torch.launch.train --arch mamba2-130m --smoke --steps 200 [--device cpu]

runs on the CUDA card unless ``--device cpu`` is given. Resume after a
crash (restores the latest checkpoint and replays the token stream from
its step, bit for bit):

    python -m repro_torch.launch.train --arch mamba2-130m --smoke --steps 200 --resume

Data-parallel with ZeRO-1 (`train/train_step.py`), one process a card,
NCCL (gloo with ``--device cpu``):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --data-parallel 4 ...

Tensor- and expert-parallel as well, on a ``(data, model)`` mesh:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --data-parallel 2 --model-parallel 2 ...

The world must hold exactly ``--data-parallel`` × ``--model-parallel``
ranks, or the driver raises: nothing trains on fewer devices than asked.
The process group comes from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``), or from a caller that has already
initialized one. The weights are drawn whole from ``--seed`` (the
one-device draw) and each rank keeps its blocks. Checkpoints hold whole
arrays, so ``--resume`` restores under any mesh shape, or none. Serving
under a model axis is `train.train_step.build_serve_step`.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import TokenStream, make_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.api import get_api
from repro_torch.models.sharding import shard_params
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.fault_tolerance import (FaultToleranceConfig,
                                               ResilientLoop)
from repro_torch.train.train_step import (TrainPlan, build_train_step,
                                          init_state, model_parallel,
                                          state_specs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = _mesh(args.data_parallel, args.model_parallel, device)

    cfg = get_config(args.arch, smoke=args.smoke)
    plan = TrainPlan(cfg=cfg, opt=adamw.AdamWConfig(lr=args.lr),
                     total_steps=args.steps, mesh=mesh)
    step_fn = build_train_step(plan)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, seed=args.seed)
    params = get_api(cfg).init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    specs = state_specs(plan) if mesh is not None else None
    if model_parallel(plan):
        params = shard_params(cfg, params, mesh, plan.dp_axes)
    state = init_state(params, plan.opt, plan)
    start_step = 0
    if args.resume:
        restored, at = CKPT.restore(state, args.ckpt_dir, mesh=mesh,
                                    specs=specs)
        if restored is not None:
            state, start_step = restored, at
            print(f"[train] resumed from step {start_step}")

    ckpt = CKPT.AsyncCheckpointer(args.ckpt_dir, mesh=mesh, specs=specs)
    losses = []

    def metrics_cb(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")

    def restore_fn():
        ckpt.wait()  # a save still in flight is the checkpoint to restore
        return CKPT.restore(loop.state, args.ckpt_dir, mesh=mesh,
                            specs=specs)

    loop = ResilientLoop(
        step_fn=step_fn, state=state,
        make_batch=lambda s: make_batch(cfg, stream, s, device=device,
                                        mesh=mesh),
        checkpointer=ckpt,
        ft=FaultToleranceConfig(ckpt_every=args.ckpt_every),
        restore_fn=restore_fn)
    t0 = time.perf_counter()
    try:
        state, end_step = loop.run(start_step, args.steps - start_step,
                                   metrics_cb)
    finally:
        ckpt.close()
    if ckpt.errors:
        raise RuntimeError(f"checkpoint saves failed: {ckpt.errors}")
    dt = time.perf_counter() - t0
    if losses:
        print(f"[train] finished at step {end_step} in {dt:.1f}s "
              f"({(end_step - start_step) / max(dt, 1e-9):.2f} steps/s) on "
              f"{device}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


def _mesh(data: int, model: int, device):
    """The ``(data, model)`` mesh of ``--data-parallel`` and
    ``--model-parallel`` (`make_host_mesh`): None for (1, 1) in a world of
    one; else a mesh over the world, which must hold exactly ``data ·
    model`` ranks. Under torchrun with no group up yet, the group is
    started from its environment — NCCL on the card (this rank's
    ``LOCAL_RANK``), gloo on the CPU."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method="env://")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1 and device.type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError("training on the card needs an NCCL process "
                           "group")
    if data * model != world:
        raise ValueError(
            f"--data-parallel {data} --model-parallel {model} needs a world "
            f"of {data * model} ranks (torchrun --nproc-per-node "
            f"{data * model}); this process runs in a world of {world}")
    if world == 1:
        return None
    return make_host_mesh(data, model)


if __name__ == "__main__":
    main()
