#!/usr/bin/env python3
"""Drive the port's data axis (slice E5) across ranks: one process a card
(NCCL), or CPU processes (gloo, ``--cpu``), started by torchrun:

    python3 -m torch.distributed.run --nproc-per-node 4 multi_rank_smoke.py [--cpu]

Every rank, in order:

  engine  caveman(4000, 11, 0.03) (219,999 edges; caveman(600, ...) with
          --cpu) at T=20 (6) through `SummarizerEngine(mesh=make_data_mesh())`
          — batched at partitions 1 and 4, resident at 1 and 2 — each equal
          to the `backend="numpy"` summary (which never shards), with its
          wall, merge_round seconds and kernel launches on this rank
  train   qwen2.5-3b whole (the smoke model with --cpu) through the
          data-parallel step with ZeRO-1 over `make_host_mesh(world, 1)`:
          4 steps of 4 × 1,024 tokens (× 64 with --cpu), the rank's rows;
          losses, seconds a step, peak memory and the moment bytes a rank
  ckpt    mamba2-130m whole after one such step: the parameters equal on
          every rank, `checkpoint.save(mesh=)` (rank 0 writes under
          `build/multi_rank_ckpt/`) and `restore(mesh=)` equal to the state
  psum    `compressed_psum` of 2^22 values: the same mean on every rank,
          and its largest gap to the exact mean

Rank 0 prints a JSON line a part (each rank its own `rank_*` lines); the
script exits 0 only if every check held on every rank.
"""
import json
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def emit(rank, what, **kw):
    if rank == 0 or what.startswith("rank"):
        print(json.dumps({"what": what, "rank": rank, **kw}), flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    cpu = "--cpu" in sys.argv
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if cpu:
        dev = torch.device("cpu")
        dist.init_process_group("gloo")
        torch.set_num_threads(2)
    else:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl")

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import SummarizerEngine
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.graphs import generators as GG
    from repro_torch.kernels.bitset_fold import kernel as K3
    from repro_torch.kernels.bitset_jaccard import kernel as K1
    from repro_torch.kernels.seghist import kernel as K2
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
    from repro_torch.models import transformer as TR
    from repro_torch.optim.adamw import leaves
    from repro_torch.optim.grad_compression import compressed_psum
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS

    ok = True
    g = GG.caveman(600 if cpu else 4000, 11, 0.03, seed=0)
    T = 6 if cpu else 20
    want = SummarizerEngine(backend="numpy", T=T, device=dev).run(g)
    mesh = make_data_mesh()
    runs = {}
    for backend, k in (("batched", 1), ("batched", 4), ("resident", 1),
                       ("resident", 2)):
        K1.LAUNCHES = K2.LAUNCHES = K3.TOPJ_LAUNCHES = K3.FOLD_LAUNCHES = 0
        eng = SummarizerEngine(backend=backend, partitions=k, T=T,
                               device=dev, mesh=mesh)
        t0 = time.perf_counter()
        s = eng.run(g)
        sync()
        wall = time.perf_counter() - t0
        same = bool(np.array_equal(s.parent, want.parent)
                    and np.array_equal(s.edges, want.edges))
        ok &= same and eng.stats["degradations"] == 0
        runs[f"{backend}-p{k}"] = {
            "equal_to_numpy": same, "wall": wall,
            "merge_round": eng.stats["merge_round"],
            "launches": {"inter": K1.LAUNCHES, "hist": K2.LAUNCHES,
                         "topj": K3.TOPJ_LAUNCHES, "fold": K3.FOLD_LAUNCHES}}
    emit(rank, "rank_engine", graph={"n": g.n, "m": g.m}, T=T, runs=runs)

    tmesh = make_host_mesh(world, 1)
    cfg = get_config("qwen2.5-3b", smoke=cpu)
    plan = TS.TrainPlan(cfg=cfg, total_steps=6, mesh=tmesh)
    state = TS.init_state(TR.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        plan.opt, plan)
    step = TS.build_train_step(plan)
    stream = TokenStream(cfg.vocab, 4, 64 if cpu else 1024)
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for s in range(4):
        batch = make_batch(cfg, stream, s, device=dev, mesh=tmesh)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    emit(rank, "rank_train", losses=losses, step_seconds=times,
         max_memory_allocated=0 if cpu else torch.cuda.max_memory_allocated(),
         moment_bytes_m=sum(t.numel() * t.element_size()
                            for t in leaves(state["opt"]["m"])),
         rows_per_rank=int(batch["tokens"].shape[0]))
    del state

    cfg = get_config("mamba2-130m", smoke=cpu)
    plan = TS.TrainPlan(cfg=cfg, total_steps=6, mesh=tmesh)

    def fresh(seed):
        return TS.init_state(TR.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev),
            plan.opt, plan)

    state, _ = TS.build_train_step(plan)(fresh(0), make_batch(
        cfg, TokenStream(cfg.vocab, 8, 128), 0, device=dev, mesh=tmesh))
    same_params = True
    for p in leaves(state["params"]):
        ref = p.clone()
        dist.broadcast(ref, 0)
        same_params &= bool(torch.equal(ref, p))
    d = ROOT / "build" / "multi_rank_ckpt"
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    dist.barrier()
    t0 = time.perf_counter()
    CKPT.save(state, 1, str(d), mesh=tmesh)
    back, at = CKPT.restore(fresh(1), str(d), mesh=tmesh)
    restored = at == 1 and all(torch.equal(a, b)
                               for a, b in zip(leaves(back), leaves(state)))
    ok &= same_params and restored
    emit(rank, "ckpt", same_params_on_every_rank=same_params,
         restored_equal=restored, seconds=time.perf_counter() - t0)
    del state, back

    x = torch.randn(1 << 22, generator=torch.Generator(
        device=dev).manual_seed(rank), device=dev)
    mean, _ = compressed_psum(x, torch.zeros_like(x))
    exact = x.clone()
    dist.all_reduce(exact)
    exact /= world
    means = [torch.empty_like(mean) for _ in range(world)]
    dist.all_gather(means, mean)
    same_mean = all(torch.equal(a, means[0]) for a in means)
    ok &= same_mean
    emit(rank, "psum", n=1 << 22, same_on_every_rank=same_mean,
         max_abs_err=float((mean - exact).abs().max()))

    flag = torch.tensor([int(ok)], device=dev)
    dist.all_reduce(flag, dist.ReduceOp.MIN)
    emit(rank, "done", ok=bool(flag.item()), world=world)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    dist.destroy_process_group()
    return 0 if flag.item() else 1


if __name__ == "__main__":
    sys.exit(main())
