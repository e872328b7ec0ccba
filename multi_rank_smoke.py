#!/usr/bin/env python3
"""Drive the port's data axis (slice E5) and model axis (slices E6a and
E6b) across ranks: one process a card (NCCL), or CPU processes (gloo,
``--cpu``), started by torchrun:

    python3 -m torch.distributed.run --nproc-per-node 4 multi_rank_smoke.py [--cpu] [--parts model]

``--parts`` (comma-separated: engine, train, ckpt, psum, model,
train_model, elastic, pod_data) runs those parts only; all by default.

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
          every rank, `checkpoint.save(mesh=, specs=)` (rank 0 writes
          under `build/multi_rank_ckpt/`) and `restore(mesh=, specs=)`
          equal to the state
  psum    `compressed_psum` of 2^22 values: the same mean on every rank,
          and its largest gap to the exact mean
  model   serving under a model axis through `build_serve_step` (world 4):
          qwen2.5-3b whole (the smoke model with --cpu) on
          `make_host_mesh(1, 4)` and `(2, 2)`, 16 prompts × 1,024 tokens
          (× 64 with --cpu), 32 greedy decode steps in bf16 — the same
          tokens on every rank of a batch shard, their agreement with the
          one-rank run printed, prefill tokens/s, decode ms a step and
          peak memory a card — and on its first 4 layers in f32 the
          prefill and decode logits (decoding the one-rank run's tokens)
          equal the one-rank run's within max|Δ| ≤ 1e-4·max|ref| + 1e-5;
          then qwen3-moe-235b-a22b cut to 40 of its 94 layers (its smoke
          model with --cpu), expert- and tensor-parallel over (1, 4), each
          rank drawing its own blocks on its card (`init_params(mesh=)`):
          16 × 1,024 prompts, 16 greedy decode steps; finite logits, the
          same routing checksum and tokens on every rank; prefill
          tokens/s, decode ms a step, peak memory, dropped routed pairs;
          each timed run after one untimed prefill and decode step;
          that prefill's routing by layer (the share of pairs dropped,
          the experts' load entropy, the tokens' router entropy, how
          alike a row's tokens are) is printed. Before it, the same
          model cut to 2 layers in f32 on (1, 4), 4 × 1,024 prompts and
          8 decode steps, against the same model on one card at its
          capacity factor and at one no pair can exceed: the logits
          within the bound above and every routing call's expert ids
          and slots equal

  train_model  training under a model axis (world 4): qwen2.5-3b whole
          (the smoke model with --cpu), bf16, remat full, 10 AdamW steps
          of 4 × 1,024 tokens (× 64 with --cpu) on one card (rank 0
          alone), then through `build_train_step` on `make_host_mesh(1,
          4)` and `(2, 2)` from the same weights (each rank its blocks):
          losses and their gaps to one card's, seconds a step, peak
          memory a card; its 2-layer cut in f32, two steps (warmup 1) on
          (1, 4) and (2, 2): losses, grad norms and every parameter equal
          one card's within max|Δ| ≤ 1e-4·max|ref| + 1e-5; then
          deepseek-v2-lite-16b whole on (1, 4), each rank drawing its
          blocks (`init_params(mesh=)`), 4 steps with f32 moments: finite
          losses, the state's bytes a rank, seconds a step, peak memory

  elastic  elastic re-meshing of a live train state (world 4):
          qwen2.5-3b whole (the smoke model with --cpu), bf16, f32
          moments, 2 steps of 4 × 1,024 tokens (× 64 with --cpu) on
          `make_host_mesh(1, 4)`, then `elastic.remesh_state` (no device
          named: the rank's card under NCCL) onto `make_mesh_for(range(4),
          2)` = (2, 2), back to (1, 4), and down to `make_mesh_for([0, 1],
          2)` = (1, 2), ranks 2 and 3 holding no block. At each move the
          state is first saved by `checkpoint.save(mesh=, specs=)` (under
          `build/multi_rank_elastic/`); the moved blocks must equal bit
          for bit `checkpoint.restore(mesh=, specs=)` of it on the target
          mesh, sit on the rank's device, and one step from each must
          give the same loss. Seconds a move, bytes, peak memory a card
  pod_data  two data-parallel qwen2.5-3b steps (the smoke model with
          --cpu) of one 1,024-token row a rank (64 with --cpu) on
          `make_mesh((2, 2, 1), ("pod", "data", "model"))` with
          `dp_axes=("pod", "data")`, from the same weights and batches as
          on the flat `make_host_mesh(4, 1)`: the losses within 1.4e-5

Rank 0 prints a JSON line a part (each rank its own `rank_*` lines); the
script exits 0 only if every check held on every rank.
"""
import json
import os
import shutil
import sys
import time
from pathlib import Path

from chip_smoke import bit_digest, local_tree, sorted_leaves

ROOT = Path(__file__).resolve().parent


def emit(rank, what, **kw):
    if rank == 0 or what.startswith("rank"):
        print(json.dumps({"what": what, "rank": rank, **kw}), flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    cpu = "--cpu" in sys.argv
    parts = (sys.argv[sys.argv.index("--parts") + 1].split(",")
             if "--parts" in sys.argv else
             ["engine", "train", "ckpt", "psum", "model", "train_model",
              "elastic", "pod_data"])
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

    from repro_torch.launch.mesh import make_host_mesh

    ok = True
    if "engine" in parts:
        ok &= engine_part(rank, dev, cpu, sync)
    tmesh = make_host_mesh(world, 1)
    if "train" in parts:
        ok &= train_part(rank, dev, cpu, sync, tmesh)
    if "ckpt" in parts:
        ok &= ckpt_part(rank, dev, cpu, tmesh)
    if "psum" in parts:
        ok &= psum_part(rank, world, dev)
    if "model" in parts:
        ok &= model_part(rank, world, dev, cpu, sync)
    if "train_model" in parts:
        ok &= train_model_part(rank, world, dev, cpu, sync)
    if "elastic" in parts:
        moves = elastic_part(rank, dev, cpu, sync,
                             ROOT / "build" / "multi_rank_elastic")
        ok &= all(m["ok"] for m in moves)
    if "pod_data" in parts:
        ok &= pod_data_part(rank, world, dev, cpu, sync)

    flag = torch.tensor([int(ok)], device=dev)
    dist.all_reduce(flag, dist.ReduceOp.MIN)
    emit(rank, "done", ok=bool(flag.item()), world=world, parts=parts)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if flag.item() else 1


def engine_part(rank, dev, cpu, sync):
    import numpy as np

    from repro_torch.core.engine import SummarizerEngine
    from repro_torch.graphs import generators as GG
    from repro_torch.kernels.bitset_fold import kernel as K3
    from repro_torch.kernels.bitset_jaccard import kernel as K1
    from repro_torch.kernels.seghist import kernel as K2
    from repro_torch.launch.mesh import make_data_mesh

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
    return ok


def train_part(rank, dev, cpu, sync, tmesh):
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.models import transformer as TR
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import train_step as TS

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
    return True


def ckpt_part(rank, dev, cpu, tmesh):
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.models import transformer as TR
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS

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
    specs = TS.state_specs(plan)
    CKPT.save(state, 1, str(d), mesh=tmesh, specs=specs)
    back, at = CKPT.restore(fresh(1), str(d), mesh=tmesh, specs=specs)
    restored = at == 1 and all(torch.equal(a, b)
                               for a, b in zip(leaves(back), leaves(state)))
    emit(rank, "ckpt", same_params_on_every_rank=same_params,
         restored_equal=restored, seconds=time.perf_counter() - t0)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    return same_params and restored


def psum_part(rank, world, dev):
    import torch
    import torch.distributed as dist

    from repro_torch.optim.grad_compression import compressed_psum

    x = torch.randn(1 << 22, generator=torch.Generator(
        device=dev).manual_seed(rank), device=dev)
    mean, _ = compressed_psum(x, torch.zeros_like(x))
    exact = x.clone()
    dist.all_reduce(exact)
    exact /= world
    means = [torch.empty_like(mean) for _ in range(world)]
    dist.all_gather(means, mean)
    same_mean = all(torch.equal(a, means[0]) for a in means)
    emit(rank, "psum", n=1 << 22, same_on_every_rank=same_mean,
         max_abs_err=float((mean - exact).abs().max()))
    return same_mean


# ----------------------------------------------------------- model axis
MA_RTOL, MA_ATOL = 1e-4, 1e-5   # max|Δ| ≤ 1e-4·max|ref| + 1e-5


def _prompts(cfg, rows, plen, dev):
    from repro_torch.data.pipeline import TokenStream

    import torch

    return torch.from_numpy(TokenStream(cfg.vocab, rows, plen, seed=0)
                            .batch_np(0)[:, :plen]).long().to(dev)


def _serve(params, cfg, mesh, toks, gen, sync, feed=None):
    """Prefill the rank's rows ``toks`` and decode ``gen`` greedy steps (or
    the tokens ``feed``) through `build_serve_step` on ``mesh`` (None: one
    device, no mesh), after one untimed prefill and decode step (the
    first collectives on a group set up its NCCL communicators). Returns
    (prefill logits, decode logits, tokens, prefill seconds, decode
    seconds a step)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import get_api
    from repro_torch.train import train_step as TS

    b, plen = toks.shape
    B = b if mesh is None else b * mesh.mesh.shape[0]
    slots = plen + gen
    if mesh is None:
        api = get_api(cfg)
        prefill = (lambda p, batch, cache_len: api.prefill(
            p, cfg, batch, cache_len))
        decode = (lambda p, c, t, pos: api.decode_step(p, cfg, c, t, pos))
    else:
        prefill = TS.build_serve_step(cfg, mesh, ("data",), ShapeConfig(
            "p", plen, B, "prefill"))[0]
        decode = TS.build_serve_step(cfg, mesh, ("data",), ShapeConfig(
            "d", slots, B, "decode"))[0]
    with torch.no_grad():
        _, cache = prefill(params, {"tokens": toks}, cache_len=slots)
        decode(params, cache, toks[:, :1], plen)
        del cache
        sync()
        t0 = time.perf_counter()
        lg, cache = prefill(params, {"tokens": toks}, cache_len=slots)
        sync()
        t_pre = time.perf_counter() - t0
        first = lg[:, -1].float()
        tok = first.argmax(-1, keepdim=True)
        outs, steps, t_dec = [tok], [], 0.0
        for i in range(gen - 1):
            t_in = tok if feed is None else feed[:, i:i + 1]
            sync()
            t0 = time.perf_counter()
            lg, cache = decode(params, cache, t_in, plen + i)
            sync()
            t_dec += time.perf_counter() - t0
            steps.append(lg[:, 0].float())
            tok = lg[:, 0].argmax(-1, keepdim=True)
            outs.append(tok)
    return first, steps, torch.cat(outs, 1), t_pre, t_dec / max(1, gen - 1)


def _close(got, want):
    err = (got - want).abs().max().item()
    return err, MA_RTOL * want.abs().max().item() + MA_ATOL


def _rows(mesh, B):
    from repro_torch.models import sharding as SH

    if SH.batch_pspec(mesh, ("data",), B)[0] is None:
        return slice(0, B)
    per, r = B // mesh.mesh.shape[0], mesh.get_local_rank("data")
    return slice(r * per, (r + 1) * per)


def _same_on_shard(t, rows, world):
    """Whether every rank holding rows ``rows`` holds the same ``t``."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    rr = [None] * world
    dist.all_gather_object(rr, (rows.start, rows.stop))
    mine = (rows.start, rows.stop)
    return all(torch.equal(p, t) for p, r in zip(parts, rr) if r == mine)


def model_part(rank, world, dev, cpu, sync):
    """The model axis (slice E6a): qwen2.5-3b on (1, 4) and (2, 2), then
    qwen3-moe-235b-a22b's 40-layer cut on (1, 4) (module docstring)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TR

    ok = True
    rows_all, plen = 16, 64 if cpu else 1024
    cfg = get_config("qwen2.5-3b", smoke=cpu)
    whole = TR.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    toks = _prompts(cfg, rows_all, plen, dev)
    gen = 32
    one = _serve(whole, cfg, None, toks, gen, sync)
    cfg4 = dataclasses.replace(cfg, n_layers=min(4, cfg.n_layers),
                               dtype="float32")
    whole4 = {k: ({n: {m: t[:cfg4.n_layers].float() for m, t in v.items()}
                   if isinstance(v, dict) else v[:cfg4.n_layers].float()
                   for n, v in val.items()} if k == "layers" else val.float())
              for k, val in whole.items()}
    one4 = _serve(whole4, cfg4, None, toks, 8, sync, feed=one[2])
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape)
        rows = _rows(mesh, rows_all)
        blocks = SH.shard_params(cfg, whole, mesh, ("data",))
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        got = _serve(blocks, cfg, mesh, toks[rows], gen, sync)
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        same = _same_on_shard(got[2], rows, world)
        agree = float((got[2] == one[2][rows]).float().mean())
        blocks4 = SH.shard_params(cfg4, whole4, mesh, ("data",))
        got4 = _serve(blocks4, cfg4, mesh, toks[rows], 8, sync,
                      feed=one[2][rows])
        worst, bound, f32_ok = 0.0, 0.0, True
        for g, w in zip([got4[0]] + got4[1], [one4[0]] + one4[1]):
            err, b = _close(g, w[rows])
            worst, bound = max(worst, err), max(bound, b)
            f32_ok &= err <= b
        ok &= same and f32_ok
        emit(rank, "model_qwen2.5-3b", mesh=list(shape),
             rows_per_rank=rows.stop - rows.start, prompt_len=plen,
             gen=gen, prefill_tokens_per_s=rows_all * plen / got[3],
             decode_ms_per_step=got[4] * 1e3,
             one_rank_prefill_tokens_per_s=rows_all * plen / one[3],
             one_rank_decode_ms_per_step=one[4] * 1e3,
             max_memory_allocated=peak, same_tokens_on_shard=same,
             bf16_token_agreement_with_one_rank=agree,
             f32_4_layers={"max_abs_err": worst, "bound": bound,
                           "ok": f32_ok})
        del blocks, blocks4, got, got4
    del whole, whole4
    if not cpu:
        torch.cuda.empty_cache()

    ok &= moe_f32_part(rank, dev, cpu, sync, toks[:MOE_F32_ROWS])
    if not cpu:
        torch.cuda.empty_cache()

    # qwen3-moe-235b-a22b, 40 of 94 layers, each rank its blocks
    cfg = get_config("qwen3-moe-235b-a22b", smoke=cpu)
    cfg = dataclasses.replace(cfg, n_layers=min(40, cfg.n_layers))
    mesh = make_host_mesh(1, 4)
    t0 = time.perf_counter()
    blocks = TR.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, mesh=mesh)
    sync()
    init_s = time.perf_counter() - t0
    local = sum(t.numel() for t in sorted_leaves(blocks))
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    with RouteStats(cfg.moe.n_experts) as stats:
        got = _serve(blocks, cfg, mesh, toks, 16, sync)
    peak = 0 if cpu else torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(got[0]).all()) and all(
        bool(torch.isfinite(s).all()) for s in got[1])
    rows = slice(0, rows_all)
    same_tokens = _same_on_shard(got[2], rows, world)
    same_routing = _same_on_shard(stats.checksum().to(dev), rows, world)
    ok &= finite and same_tokens and same_routing
    emit(rank, "model_qwen3-moe-235b-a22b", mesh=[1, 4],
         layers=cfg.n_layers, layers_published=94,
         params_a_rank=local, init_seconds=init_s, prompt_len=plen,
         gen=16, prefill_tokens_per_s=rows_all * plen / got[3],
         decode_ms_per_step=got[4] * 1e3, max_memory_allocated=peak,
         finite=finite, same_tokens=same_tokens,
         same_routing_checksum=same_routing,
         dropped_share=stats.dropped_share(),
         prefill_by_layer=stats.by_layer(cfg.n_layers))
    return ok


MOE_F32_LAYERS, MOE_F32_ROWS, MOE_F32_STEPS = 2, 4, 8


class RouteStats:
    """`moe.route` recorded while it is entered: every call's routing
    (``keep``: its expert ids and slots), its dropped pairs, and, on
    each call's device tensors (read only at the end, so the timed
    steps do not wait for them), what the router saw: the share of
    pairs dropped, the entropy of the experts' load and of each token's
    router distribution (both over log E: 1 is uniform), and how alike
    the tokens of a row are (|mean of their unit vectors|², 1 when they
    all point one way)."""

    def __init__(self, n_experts: int, keep: bool = False):
        self.e, self.keep, self.calls = n_experts, keep, []

    def __enter__(self):
        from repro_torch.models import moe as MOE

        self.mod, self.orig = MOE, MOE.route
        MOE.route = self._route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig

    def _route(self, p, c, x):
        import math

        import torch

        r = self.orig(p, c, x)
        w = torch.arange(1, r.top_e.numel() + 1, device=x.device)
        ids = r.top_e.reshape(-1)
        load = torch.zeros(self.e, device=x.device).index_add_(
            0, ids, torch.ones(ids.shape, device=x.device)) / ids.numel()
        ent = -(load * load.clamp_min(1e-30).log()).sum() / math.log(self.e)
        tok_ent = -(r.probs * r.probs.clamp_min(1e-30).log()).sum(-1)
        unit = torch.nn.functional.normalize(x.float(), dim=-1)
        alike = (unit.mean(1).norm(dim=-1) ** 2).mean()
        self.calls.append({
            "checksum": (r.top_e.reshape(-1).long() * w).sum(),
            "dropped": r.dropped, "pairs": r.top_e.numel(),
            "load_entropy": ent,
            "router_entropy": tok_ent.mean() / math.log(self.e),
            "tokens_alike": alike,
            "routing": (r.top_e.clone(), r.slot.clone()) if self.keep
            else None})
        return r

    def checksum(self):
        import torch

        return torch.stack([c["checksum"] for c in self.calls]).sum()[None]

    def dropped_share(self) -> float:
        import torch

        dropped = int(torch.stack([c["dropped"] for c in self.calls]).sum())
        return dropped / max(1, sum(c["pairs"] for c in self.calls))

    def by_layer(self, n_layers: int) -> dict:
        """The first prefill's calls, one a layer in order: each field's
        value by layer."""
        first = self.calls[:n_layers]
        return {"dropped_share": [int(c["dropped"]) / c["pairs"]
                                  for c in first],
                **{k: [float(c[k]) for c in first] for k in (
                    "load_entropy", "router_entropy", "tokens_alike")}}


def moe_f32_part(rank, dev, cpu, sync, toks):
    """qwen3-moe-235b-a22b at full width cut to its first
    `MOE_F32_LAYERS` layers in f32, expert- and tensor-parallel over (1,
    4) through `build_serve_step`, against the same model on one card,
    at the config's capacity factor and at ``n_experts / top_k`` (a
    capacity of the prompt's length: no pair can drop, so every routed
    pair reaches the output through its rank's expert block): the
    prefill and decode logits (decoding the one-card run's tokens) within
    max|Δ| ≤ 1e-4·max|ref| + 1e-5, and every routing call's expert ids
    and slots equal."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TR

    cut = dataclasses.replace(
        get_config("qwen3-moe-235b-a22b", smoke=cpu),
        n_layers=MOE_F32_LAYERS, dtype="float32")
    whole = TR.init_params(cut, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    mesh = make_host_mesh(1, 4)
    blocks = SH.shard_params(cut, whole, mesh, ("data",))
    mo, ok = cut.moe, True
    for factor in (mo.capacity_factor, mo.n_experts / mo.top_k):
        cfg = dataclasses.replace(cut, moe=dataclasses.replace(
            mo, capacity_factor=factor))
        with RouteStats(mo.n_experts, keep=True) as one_routes:
            one = _serve(whole, cfg, None, toks, MOE_F32_STEPS, sync)
        with RouteStats(mo.n_experts, keep=True) as routes:
            got = _serve(blocks, cfg, mesh, toks, MOE_F32_STEPS, sync,
                         feed=one[2])
        worst, bound, f32_ok = 0.0, 0.0, True
        for g, w in zip([got[0]] + got[1], [one[0]] + one[1]):
            err, b = _close(g, w)
            worst, bound = max(worst, err), max(bound, b)
            f32_ok &= err <= b
        flips = sum(int((a["routing"][0] != b["routing"][0]).sum())
                    for a, b in zip(routes.calls, one_routes.calls))
        same = len(routes.calls) == len(one_routes.calls) and all(
            torch.equal(a["routing"][0], b["routing"][0])
            and torch.equal(a["routing"][1], b["routing"][1])
            for a, b in zip(routes.calls, one_routes.calls))
        emit(rank, "model_qwen3-moe-235b-a22b_f32", mesh=[1, 4],
             layers=cfg.n_layers, capacity_factor=factor,
             rows=toks.shape[0], prompt_len=toks.shape[1],
             decode_steps=MOE_F32_STEPS - 1, max_abs_err=worst, bound=bound,
             logits_ok=f32_ok, routing_equal=same, flipped_choices=flips,
             routing_calls=len(routes.calls),
             dropped_share=routes.dropped_share(),
             one_card_dropped_share=one_routes.dropped_share())
        ok &= f32_ok and same
        del got, one, routes, one_routes
    del whole, blocks
    return ok


# ------------------------------------------------------ model-axis training
TM_STEPS, TM_BATCH, TM_SEQ = 10, 4, 1024   # qwen2.5-3b, 4 × 1,024 a step
TM_MLA_STEPS = 4                           # deepseek-v2-lite-16b at (1, 4)


def _train(state, step, cfg, mesh, steps, dev, sync, seq):
    """``steps`` steps from the same `TokenStream` batches (this rank's
    rows under ``mesh``): losses, grad norms and seconds a step."""
    from repro_torch.data.pipeline import TokenStream, make_batch

    stream = TokenStream(cfg.vocab, TM_BATCH, seq, seed=0)
    losses, norms, times = [], [], []
    for s in range(steps):
        batch = make_batch(cfg, stream, s, device=dev, mesh=mesh)
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms, times


def _peak(cpu):
    import torch

    return 0 if cpu else torch.cuda.max_memory_allocated()


def _reset_peak(cpu):
    import torch

    if not cpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def train_model_part(rank, world, dev, cpu, sync):
    """Training under a model axis (module docstring): qwen2.5-3b on one
    card (rank 0), on (1, 4) and on (2, 2); its 2-layer f32 cut against
    one card; deepseek-v2-lite-16b whole on (1, 4)."""
    import dataclasses
    import math
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TR
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    ok = True
    seq = 64 if cpu else TM_SEQ
    cfg = get_config("qwen2.5-3b", smoke=cpu)

    def whole_params(c, seed=0):
        return TR.init_params(c, torch.Generator(device=dev).manual_seed(
            seed), device=dev)

    # one card: rank 0 alone, the others wait
    one = [None]
    if rank == 0:
        plan = TS.TrainPlan(cfg=cfg, total_steps=TM_STEPS)
        state = TS.init_state(whole_params(cfg), plan.opt)
        _reset_peak(cpu)
        state, losses, norms, times = _train(
            state, TS.build_train_step(plan), cfg, None, TM_STEPS, dev, sync,
            seq)
        one[0] = {"losses": losses, "grad_norms": norms,
                  "step_seconds": times, "max_memory_allocated": _peak(cpu)}
        del state
    dist.broadcast_object_list(one, src=0)
    one = one[0]
    emit(rank, "train_model_qwen2.5-3b", mesh=[1, 1], layers=cfg.n_layers,
         tokens_per_step=TM_BATCH * seq,
         steady_step_seconds=statistics.median(one["step_seconds"][1:]),
         **one)
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape)
        plan = TS.TrainPlan(cfg=cfg, total_steps=TM_STEPS, mesh=mesh)
        state = TS.init_state(SH.shard_params(cfg, whole_params(cfg), mesh,
                                              plan.dp_axes), plan.opt, plan)
        _reset_peak(cpu)
        state, losses, norms, times = _train(
            state, TS.build_train_step(plan), cfg, mesh, TM_STEPS, dev, sync,
            seq)
        del state
        finite = all(math.isfinite(x) for x in losses)
        gaps = [abs(a - b) for a, b in zip(losses, one["losses"])]
        ok &= finite
        emit(rank, "train_model_qwen2.5-3b", mesh=list(shape),
             layers=cfg.n_layers, tokens_per_step=TM_BATCH * seq,
             losses=losses, grad_norms=norms, step_seconds=times,
             steady_step_seconds=statistics.median(times[1:]),
             one_card_steady_step_seconds=statistics.median(
                 one["step_seconds"][1:]),
             max_memory_allocated=_peak(cpu), finite=finite,
             loss_gap_to_one_card=gaps, max_loss_gap=max(gaps))

    # the 2-layer f32 cut: two steps (warmup 1) against one card
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = TS.TrainPlan(cfg=cfg2, warmup=1, total_steps=10)
    ref = TS.init_state(whole_params(cfg2, 1), plan.opt)
    ref, ref_losses, ref_norms, _ = _train(ref, TS.build_train_step(plan),
                                           cfg2, None, 2, dev, sync, seq)
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(*shape)
        mplan = dataclasses.replace(plan, mesh=mesh)
        specs = TS.state_specs(mplan)["params"]
        state = TS.init_state(SH.shard_params(cfg2, whole_params(cfg2, 1),
                                              mesh, mplan.dp_axes),
                              plan.opt, mplan)
        state, losses, norms, _ = _train(state, TS.build_train_step(mplan),
                                         cfg2, mesh, 2, dev, sync, seq)
        got = SH.gather_blocks(state["params"], specs, mesh)
        worst, bound, f32_ok = 0.0, 0.0, True
        pairs = [(torch.tensor(a), torch.tensor(b)) for a, b in zip(
            losses + norms, ref_losses + ref_norms)] + list(zip(
                adamw.leaves(got), adamw.leaves(ref["params"])))
        for g, w in pairs:
            err, b = _close(g.float(), w.float())
            worst, bound = max(worst, err), max(bound, b)
            f32_ok &= err <= b
        ok &= f32_ok
        emit(rank, "train_model_f32_2_layers", mesh=list(shape),
             losses=losses, one_card_losses=ref_losses, grad_norms=norms,
             one_card_grad_norms=ref_norms, max_abs_err=worst, bound=bound,
             ok=f32_ok)
        del state, got
    del ref
    torch.backends.cuda.matmul.allow_tf32 = tf32

    # deepseek-v2-lite-16b whole on (1, 4), each rank drawing its blocks
    cfg = get_config("deepseek-v2-lite-16b", smoke=cpu)
    mesh = make_host_mesh(1, 4)
    plan = TS.TrainPlan(cfg=cfg, total_steps=TM_MLA_STEPS, mesh=mesh)
    _reset_peak(cpu)
    t0 = time.perf_counter()
    state = TS.init_state(TR.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
        mesh=mesh), plan.opt, plan)
    sync()
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size()
                      for t in sorted_leaves(state))
    params_a_rank = sum(t.numel() for t in sorted_leaves(state["params"]))
    _reset_peak(cpu)
    state, losses, norms, times = _train(
        state, TS.build_train_step(plan), cfg, mesh, TM_MLA_STEPS, dev, sync,
        seq)
    del state
    finite = all(math.isfinite(x) for x in losses + norms)
    ok &= finite
    emit(rank, "train_model_deepseek-v2-lite-16b", mesh=[1, 4],
         layers=cfg.n_layers, params=cfg.param_count(),
         params_a_rank=params_a_rank,
         state_bytes_a_rank=state_bytes, init_seconds=init_s,
         tokens_per_step=TM_BATCH * seq, losses=losses, grad_norms=norms,
         step_seconds=times, steady_step_seconds=statistics.median(
             times[1:]), max_memory_allocated=_peak(cpu), finite=finite)
    return ok


# ------------------------------------------------------ elastic meshes
# (ranks, model_parallel) of each `make_mesh_for` after the start on (1, 4)
EL_MOVES = ((range(4), 2), (range(4), 4), ((0, 1), 2))


def _el_plan(cfg, mesh):
    from repro_torch.train import train_step as TS

    return TS.TrainPlan(cfg=cfg, total_steps=TM_STEPS, mesh=mesh)


def elastic_specs(cfg):
    """``spec_fn(state, mesh)`` for `remesh_state`: ``cfg``'s
    `train_step.state_specs` on ``mesh``."""
    from repro_torch.train import train_step as TS

    return lambda _, mesh: TS.state_specs(_el_plan(cfg, mesh))


def _el_loss(cfg, stream, dev, state, step, mesh, at):
    from repro_torch.data.pipeline import make_batch

    batch = make_batch(cfg, stream, at, device=dev, mesh=mesh)
    return float(step(state, batch)[1]["loss"])


def elastic_start(rank, dev, cpu):
    """The elastic part's start: qwen2.5-3b (the smoke model with
    ``cpu``), bf16 with f32 moments, two steps of 4 × 1,024 tokens (× 64
    with ``cpu``) on `make_host_mesh(1, 4)`. Returns ``cfg``, the token
    stream, and the train state as `elastic.Placed` leaves on that mesh
    under `elastic_specs`."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models import transformer as TR
    from repro_torch.models.api import param_shapes
    from repro_torch.train import elastic as EL
    from repro_torch.train import train_step as TS

    cfg = get_config("qwen2.5-3b", smoke=cpu)
    stream = TokenStream(cfg.vocab, TM_BATCH, 64 if cpu else TM_SEQ, seed=0)
    mesh = make_host_mesh(1, 4)
    plan = _el_plan(cfg, mesh)
    step = TS.build_train_step(plan)
    state = TS.init_state(SH.shard_params(cfg, TR.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev), mesh,
        ("data",)), plan.opt, plan)
    losses = [_el_loss(cfg, stream, dev, state, step, mesh, s)
              for s in range(2)]
    emit(rank, "elastic_start", mesh=[1, 4], layers=cfg.n_layers,
         losses=losses)

    def placed(tree, specs, shape):
        if isinstance(shape, dict):
            return {k: placed(tree[k], specs[k], shape[k]) for k in shape}
        return EL.Placed(tree, tuple(specs), mesh, tuple(shape), tree.dtype)

    shapes = param_shapes(cfg)
    return cfg, stream, placed(state, TS.state_specs(plan), {
        "params": shapes, "opt": {"m": shapes, "v": shapes, "step": ()}})


def elastic_part(rank, dev, cpu, sync, ckpt_root, moves=EL_MOVES):
    """Elastic re-meshing (module docstring): `elastic_start`, then each
    of ``moves`` gated against a checkpoint of the state before it.
    Returns a record a move (``ok``: whether its gates held on this
    rank); a member's record holds the `bit_digest` of each of its moved
    blocks (``digests``, in sorted-key order)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import axes_group
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import elastic as EL
    from repro_torch.train import train_step as TS

    def bits(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)

    cfg, stream, cur = elastic_start(rank, dev, cpu)
    specs_on = elastic_specs(cfg)
    mesh = sorted_leaves(cur)[0].mesh
    state = local_tree(cur)
    at, records = 2, []
    for k, (ranks, mp) in enumerate(moves):
        d = Path(ckpt_root) / f"move_{k}"
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
        axes_group(mesh, mesh.mesh_dim_names)  # every rank, collectively
        if state is not None:
            CKPT.save(state, at, str(d), mesh=mesh, specs=specs_on(0, mesh))
        dist.barrier()
        mesh = EL.make_mesh_for(list(ranks), mp)
        axes_group(mesh, mesh.mesh_dim_names)
        state = None
        sync()
        _reset_peak(cpu)
        t0 = time.perf_counter()
        cur = EL.remesh_state(cur, mesh, specs_on)
        sync()
        rec = {"to": list(mesh.mesh.shape), "ranks": list(ranks),
               "seconds": time.perf_counter() - t0,
               "max_memory_allocated": _peak(cpu), "member": False}
        blocks = [p.local for p in sorted_leaves(cur)]
        rec["ok"] = all(b is None for b in blocks)
        if blocks[0] is not None:
            state = local_tree(cur)
            step = TS.build_train_step(_el_plan(cfg, mesh))
            back, saved_at = CKPT.restore(state, str(d), mesh=mesh,
                                          specs=specs_on(0, mesh))
            theirs = sorted_leaves(back)
            equal = saved_at == at and len(blocks) == len(theirs) and all(
                a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                    bits(a), bits(b)) for a, b in zip(blocks, theirs))
            devices = sorted({str(b.device) for b in blocks})
            digests = [bit_digest(b) for b in blocks]
            loss_restored = _el_loss(cfg, stream, dev, back, step, mesh, at)
            del back, theirs
            loss = _el_loss(cfg, stream, dev, state, step, mesh, at)
            on_device = devices == [str(dev)]
            rec.update(member=True, bit_equal=equal, devices=devices,
                       on_rank_device=on_device, loss=loss,
                       loss_restored=loss_restored, digests=digests,
                       bytes_a_rank=sum(b.numel() * b.element_size()
                                        for b in blocks),
                       ok=equal and on_device and loss == loss_restored)
        at += 1
        dist.barrier()
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
        emit(rank, "rank_elastic_move", move=k,
             **{x: v for x, v in rec.items() if x != "digests"})
        records.append(rec)
    return records


def pod_data_part(rank, world, dev, cpu, sync):
    """Two data-parallel steps on the ``("pod", "data")`` mesh against the
    flat data mesh (module docstring)."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import transformer as TR
    from repro_torch.train import train_step as TS

    cfg = get_config("qwen2.5-3b", smoke=cpu)
    seq = 64 if cpu else TM_SEQ
    runs = {}
    for name, mesh, dp in (
            ("pod_data", make_mesh((2, 2, 1), ("pod", "data", "model")),
             ("pod", "data")),
            ("flat", make_host_mesh(world, 1), ("data",))):
        plan = TS.TrainPlan(cfg=cfg, total_steps=TM_STEPS, mesh=mesh,
                            dp_axes=dp)
        state = TS.init_state(TR.init_params(cfg, torch.Generator(
            device=dev).manual_seed(0), device=dev), plan.opt, plan)
        step = TS.build_train_step(plan)
        stream = TokenStream(cfg.vocab, world, seq, seed=0)
        _reset_peak(cpu)
        losses, times = [], []
        for s in range(2):
            batch = make_batch(cfg, stream, s, device=dev, mesh=mesh,
                               dp_axes=dp)
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        runs[name] = {"mesh": list(mesh.mesh.shape), "dp_axes": list(dp),
                      "losses": losses, "step_seconds": times,
                      "rows_a_rank": int(batch["tokens"].shape[0]),
                      "max_memory_allocated": _peak(cpu)}
        del state
    gap = max(abs(a - b) for a, b in zip(runs["pod_data"]["losses"],
                                         runs["flat"]["losses"]))
    ok = gap <= POD_DATA_TOL
    emit(rank, "pod_data", **runs, max_loss_gap=gap, tol=POD_DATA_TOL, ok=ok)
    return ok


POD_DATA_TOL = 1.4e-5  # four data ranks against one in the data-axis slice


if __name__ == "__main__":
    sys.exit(main())
