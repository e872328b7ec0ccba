"""Case functions the multi-rank tests run on every rank (`torch_dist.spawn`):
``fn(rank, world, *args)``, inside a gloo process group of ``world`` ranks,
returning picklable results. Torch and the port only — the tests hold the
results to the JAX package in the parent process."""
from __future__ import annotations

import numpy as np
import torch

CPU = "cpu"


def _summary(s, g):
    return {"parent": s.parent, "edges": s.edges,
            "lossless": bool(s.validate_lossless(g))}


def _engine(graph, backend, k, mesh, T, seed):
    from repro_torch.core.engine import SummarizerEngine

    eng = SummarizerEngine(partitions=k, backend=backend, T=T, seed=seed,
                           mesh=mesh, device=CPU)
    res = _summary(eng.run(graph), graph)
    res["degradations"] = eng.stats["degradations"]
    res["workers"] = eng.workers
    return res


# ------------------------------------------------------------ summarizer
def summarizer_world(rank, world, graph, runs, T, seed, shingle_graph,
                     sub_seeds):
    """`SummarizerEngine` under `make_data_mesh()` for each ``(backend,
    partitions, explicit mesh?)`` of ``runs`` (default workers; without
    an explicit mesh the engine builds its own), then the sharded node
    shingles of ``shingle_graph`` against the dense ones for each of
    ``sub_seeds``."""
    from repro_torch.core import distributed as D
    from repro_torch.core.minhash import u32_seed_consts
    from repro_torch.launch.mesh import block, make_data_mesh

    mesh = make_data_mesh()
    out = {"runs": [_engine(graph, b, k, mesh if explicit else None, T,
                            seed) for b, k, explicit in runs]}
    g = shingle_graph
    src = np.repeat(np.arange(g.n), np.diff(g.indptr)).astype(np.int64)
    dst = g.indices.astype(np.int64)
    pad = (-src.size) % world
    src_p = np.concatenate([src, np.full(pad, g.n)])
    dst_p = np.concatenate([dst, np.zeros(pad, np.int64)])
    own = block(src_p.size, rank, world)
    fn = D.shingles_sharded(mesh)
    out["shingles"] = []
    for s in sub_seeds:
        a, b = u32_seed_consts(s)
        got = fn(torch.from_numpy(src_p[own].copy()),
                 torch.from_numpy(dst_p[own].copy()), g.n, a, b)
        want = D.node_shingles_dense(torch.from_numpy(src),
                                     torch.from_numpy(dst), g.n, a, b)
        out["shingles"].append((got.numpy(), want.numpy()))
    return out


def intersections_world(rank, world, batches):
    """`batched_intersections_mesh` over every rank on each ``(B, G, W)``
    uint32 batch: the results, and the transfer ledger after each call."""
    from repro_torch.core import distributed as D
    from repro_torch.core.transfer import GLOBAL as TRANSFER
    from repro_torch.launch.mesh import make_data_mesh

    fn = D.batched_intersections_mesh(make_data_mesh())
    TRANSFER.reset()
    out = []
    for bits in batches:
        inter = fn(bits)
        snap = TRANSFER.snapshot()
        out.append((inter, {k: snap[k] for k in ("bytes_h2d", "bytes_d2h",
                                                 "rounds")}))
    return out


def faults_world(rank, world, graph, T, seed, cases):
    """Each ``(backend, site, hit)`` of ``cases`` under `faults.inject` on
    every rank alike, with `make_data_mesh()`: the summaries and each
    run's degradations."""
    from repro_torch import faults
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh()
    out = []
    for backend, site, hit in cases:
        with faults.inject(site, hit=hit):
            out.append(_engine(graph, backend, 2, mesh, T, seed))
    return out


# ------------------------------------------------------ elastic meshes
def elastic_world(rank, world, subsets, mps):
    """`make_mesh_for`'s shape for each rank subset and model size; then a
    state placed on 4 ranks (model_parallel 2), moved to 2 ranks and back
    (`remesh_state`): each placement's local block and whole value."""
    from repro_torch.train.elastic import (gather_full, make_mesh_for,
                                           remesh_state)

    shapes = {(n, mp): tuple(make_mesh_for(list(range(n)), mp).mesh.shape)
              for n in subsets for mp in mps}
    mesh4 = make_mesh_for(list(range(4)), 2)
    mesh2 = make_mesh_for(list(range(2)), 2)
    state = {"w": torch.arange(32.0).reshape(8, 4),
             "step": torch.tensor(3, dtype=torch.int32)}

    def spec_fn(st, mesh):
        return {"w": ("data", None), "step": ()}

    out = {"shapes": shapes, "stages": []}
    st = state
    for mesh in (mesh4, mesh2, mesh4):
        st = remesh_state(st, mesh, spec_fn)
        out["stages"].append({
            "size": int(st["w"].mesh.mesh.numel()),
            "local": None if st["w"].local is None else st["w"].local.numpy(),
            "w": gather_full(st["w"], CPU).numpy(),
            "step": gather_full(st["step"], CPU).numpy()})
    return out


def _smoke():
    """`multi_rank_smoke.py` from the repo root (it imports `chip_smoke.py`
    beside it)."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import multi_rank_smoke

    return multi_rank_smoke


def _bytes(t):
    """(dtype name, shape, bit patterns as uint8): numpy has no
    bfloat16."""
    return (str(t.dtype).split(".")[-1], tuple(t.shape),
            t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
            .copy())


def elastic_train_world(rank, world, ckpt_dir, moves):
    """`multi_rank_smoke.elastic_part` as its ``--cpu`` rehearsal runs it
    (the smoke model on gloo): a train state under `state_specs` on
    `make_host_mesh(1, 4)` moved by `remesh_state` through ``moves``,
    each gated against a checkpoint saved before it and restored on the
    target mesh; its records. Then the same start state
    (`elastic_start`) moved through ``moves`` with no step between, for
    the reference's ``remesh_state`` to move too: the start state whole
    (rank 0), the specs on the start mesh and after each move, and this
    rank's blocks after each move (None off the mesh), all in sorted-key
    order."""
    from repro_torch.train.elastic import (gather_full, make_mesh_for,
                                           remesh_state)

    smoke = _smoke()
    dev = torch.device(CPU)
    records = smoke.elastic_part(rank, dev, True, lambda: None, ckpt_dir,
                                 moves)
    cfg, _, state = smoke.elastic_start(rank, dev, True)
    spec_fn = smoke.elastic_specs(cfg)
    leaves = smoke.sorted_leaves(state)
    start = [_bytes(gather_full(p)) for p in leaves]
    specs, blocks = [[p.spec for p in leaves]], []
    for ranks, mp in moves:
        state = remesh_state(state, make_mesh_for(list(ranks), mp), spec_fn)
        leaves = smoke.sorted_leaves(state)
        specs.append([p.spec for p in leaves])
        blocks.append(None if leaves[0].local is None else
                      [_bytes(p.local) for p in leaves])
    return {"records": records, "start": start if rank == 0 else None,
            "specs": specs, "blocks": blocks}


# ------------------------------------------------------ data-parallel train
def _leaves_np(tree):
    from repro_torch.optim.adamw import leaves

    return [t.detach().float().numpy().copy() for t in leaves(tree)]


def dp_train(rank, world, archs, steps, batch, seq, ckpt_dir, ckpt_arch):
    """For each smoke arch (f32, the chunked twin): ``steps`` steps of the
    data-parallel step (ZeRO-1, this rank's rows of each batch) beside the
    single-device step on the whole batch, from one seeded init. Returns
    both runs' metrics and parameters, the ZeRO-1 slices and the
    moments (gathered whole), and each rank's rows of the batches; saves
    ``ckpt_arch``'s data-parallel state under ``ckpt_dir``."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import get_api
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS

    mesh = make_host_mesh(world, 1)
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32", attn_impl="xla_chunked")

        def fresh():
            return get_api(cfg).init_params(
                cfg, torch.Generator().manual_seed(0), device=CPU)

        plan1 = TS.TrainPlan(cfg=cfg, warmup=1, total_steps=10)
        plan = TS.TrainPlan(cfg=cfg, warmup=1, total_steps=10, mesh=mesh)
        s1 = TS.init_state(fresh(), plan1.opt)
        sd = TS.init_state(fresh(), plan.opt, plan)
        step1, stepd = TS.build_train_step(plan1), TS.build_train_step(plan)
        stream = TokenStream(cfg.vocab, batch, seq, seed=0)
        res = {"m1": [], "md": [], "rows": []}
        for s in range(steps):
            b1 = make_batch(cfg, stream, s, device=CPU)
            bd = make_batch(cfg, stream, s, device=CPU, mesh=mesh)
            res["rows"].append({k: v.float().numpy() for k, v in bd.items()})
            s1, m1 = step1(s1, b1)
            sd, md = stepd(sd, bd)
            res["m1"].append({k: float(v) for k, v in m1.items()})
            res["md"].append({k: float(v) for k, v in md.items()})
        res["p1"] = _leaves_np(s1["params"])
        res["pd"] = _leaves_np(sd["params"])
        res["shards"] = TS.zero1_shards(plan, sd["params"])
        res["specs"] = TS.state_specs(plan, sd["params"])["opt"]["m"]
        res["m_local"] = [t.shape for t in _leaves_np(sd["opt"]["m"])]
        specs = TS.state_specs(plan)
        whole = SH.gather_blocks(sd, specs, mesh)
        res["mom1"] = _leaves_np(s1["opt"]["m"]) + _leaves_np(s1["opt"]["v"])
        res["momd"] = (_leaves_np(whole["opt"]["m"])
                       + _leaves_np(whole["opt"]["v"]))
        if arch == ckpt_arch:
            CKPT.save(sd, steps, ckpt_dir, mesh=mesh, specs=specs)
            res["saved"] = {"p": _leaves_np(whole["params"]),
                            "m": _leaves_np(whole["opt"]["m"]),
                            "v": _leaves_np(whole["opt"]["v"]),
                            "step": int(whole["opt"]["step"])}
        out[arch] = res
    return out


def dp_restore(rank, world, arch, ckpt_dir):
    """``arch``'s smoke state restored under a data mesh of this world from
    ``ckpt_dir``, gathered whole."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import get_api
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS

    mesh = make_host_mesh(world, 1)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              attn_impl="xla_chunked")
    plan = TS.TrainPlan(cfg=cfg, mesh=mesh)
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(1),
                                      device=CPU)
    like = TS.init_state(params, plan.opt, plan)
    specs = TS.state_specs(plan)
    state, step = CKPT.restore(like, ckpt_dir, mesh=mesh, specs=specs)
    whole = SH.gather_blocks(state, specs, mesh)
    return {"p": _leaves_np(whole["params"]), "m": _leaves_np(whole["opt"]["m"]),
            "v": _leaves_np(whole["opt"]["v"]),
            "step": int(whole["opt"]["step"]), "at": step,
            "m_local": [t.shape for t in _leaves_np(state["opt"]["m"])]}


def dp_cli(rank, world, argv):
    """`launch.train.main(argv)` on every rank: its losses."""
    from repro_torch.launch import train as LT

    return LT.main(list(argv))


def compress_world(rank, world, g_all, reps):
    """`compressed_psum` over the world on rank ``rank``'s row of ``g_all``
    with a zero residual: rounded to nearest, then ``reps`` stochastic
    draws (each rank its own generator) averaged."""
    from repro_torch.optim.grad_compression import compressed_psum

    g = torch.from_numpy(g_all[rank].copy())
    err = torch.zeros_like(g)
    mean, new_err = compressed_psum(g, err)
    gen = torch.Generator().manual_seed(1000 + rank)
    draws = torch.stack([compressed_psum(g, err, generator=gen)[0]
                         for _ in range(reps)])
    return mean.numpy(), new_err.numpy(), draws.mean(0).numpy()


def isolation_world(rank, world):
    """A mesh summary and a data-parallel train step; then the jax, JAX
    package and ml_dtypes modules loaded in this process (none, to pass)."""
    import dataclasses
    import sys

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.graphs import generators as PG
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_api
    from repro_torch.train import train_step as TS

    g = PG.caveman(6, 5, 0.1, seed=0)
    assert _engine(g, "batched", 1, None, 2, 0)["lossless"]
    cfg = dataclasses.replace(get_config("mamba2-130m", smoke=True),
                              attn_impl="xla_chunked")
    plan = TS.TrainPlan(cfg=cfg, mesh=make_host_mesh(world, 1))
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                      device=CPU)
    state = TS.init_state(params, plan.opt, plan)
    batch = make_batch(cfg, TokenStream(cfg.vocab, 2, 24), 0, device=CPU,
                       mesh=plan.mesh)
    TS.build_train_step(plan)(state, batch)
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "repro", "ml_dtypes"))


def arena_v1(rank, world, graph):
    """One workspace chunk of ``graph``'s first iteration as an arena
    split over the data mesh and as a whole one: the v1 ranking
    (`topj_rows`) of every row, one v1 fold of the first accepted pair of
    each group, and the downloads after it, from both."""
    from repro_torch.core.merging import (BatchedGroupWorkspace, MergePlan,
                                          theta_to_p)
    from repro_torch.core.minhash import (candidate_groups,
                                          host_shingle_provider)
    from repro_torch.core.resident import ResidentBitmapArena
    from repro_torch.core.slugger import SluggerState
    from repro_torch.launch.mesh import make_data_mesh

    st = SluggerState(graph)
    groups = [g for g in candidate_groups(
        graph, st.root_of, st.alive, seed=0,
        shingle_fn=host_shingle_provider(graph)(st.root_of), max_group=16)
        if g.size <= 16]
    ws = BatchedGroupWorkspace.build_bucket(
        st, groups, 16, plans=[MergePlan(g) for g in groups],
        group_seeds=np.arange(len(groups), dtype=np.uint64))[0]
    out = {}
    for name, mesh in (("whole", None), ("split", make_data_mesh())):
        arena = ResidentBitmapArena.from_workspace(ws, top_j=4, device=CPU,
                                                   mesh=mesh)
        rb, rr = np.nonzero(ws.alive)
        ranked = arena.topj_rows(rb, rr)
        acc, part = arena.propose_rows(rb, theta_to_p(0.0), None)
        b = np.flatnonzero(np.concatenate([[True], rb[1:] != rb[:-1]])
                           & acc)
        b = b[rr[b] != part[b]]
        arena.fold(rb[b], rr[b], part[b], ws.memcol[rb[b], rr[b]],
                   ws.memcol[rb[b], part[b]])
        out[name] = {"ranked": ranked, "accept": acc, "partner": part,
                     "bits": arena.host_bits(), "alive": arena.host_alive(),
                     "counts": arena.host_counts(),
                     "rows": arena.sync_rows(rb[:5], rr[:5]),
                     "shards": arena.shards}
    return out


def world2_cases(rank, world, graph, T, seed, cases):
    return {"faults": faults_world(rank, world, graph, T, seed, cases),
            "arena": arena_v1(rank, world, graph)}


# ------------------------------------------------- the model axis (E6a)
# A serving case: {"arch", "dtype", "data", "model", "B" (global rows),
# "P" (prompt tokens), "steps" (decode steps), "S" (cache slots for text;
# a VLM's patches come on top, whisper's frames are S long), "vocab",
# "fsdp", "absorbed", "seed"}.


def serve_config(case):
    """The case's smoke config: its dtype, vocab and ``fsdp``."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                              dtype=case.get("dtype", "float32"))
    if case.get("vocab"):
        cfg = dataclasses.replace(cfg, vocab=case["vocab"])
    if case.get("fsdp"):
        cfg = dataclasses.replace(cfg, fsdp=True)
    if case.get("absorbed"):
        object.__setattr__(cfg, "_absorbed_mla", True)
    return cfg


def serve_arrays(cfg, case):
    """The case's inputs as numpy, from its seed: tokens (B, P + steps),
    whisper's frames (B, S, d), a VLM's patch embeddings."""
    rng = np.random.default_rng(case.get("seed", 0))
    B, P, n = case["B"], case["P"], case["steps"]
    out = {"tokens": rng.integers(0, cfg.vocab, (B, P + n)).astype(np.int64)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (B, case["S"], cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def serve_lengths(cfg, case):
    """(prefill length, decode cache slots, first decode position)."""
    off = cfg.n_patches
    return case["P"] + off, case["S"] + off, case["P"] + off


class RouteLog:
    """`moe.route` wrapped once a process: each call's integers (top_e,
    slot) appended to the calling thread's log while one is open."""

    def __init__(self):
        import threading

        from repro_torch.models import moe

        self.local = threading.local()
        self.orig = moe.route
        moe.route = self._route

    def _route(self, p, cfg, x):
        r = self.orig(p, cfg, x)
        log = getattr(self.local, "log", None)
        if log is not None:
            log.append((r.top_e.cpu().numpy().copy(),
                        r.slot.cpu().numpy().copy()))
        return r

    def open(self):
        self.local.log = []
        return self.local.log

    def close(self):
        from repro_torch.models import moe

        moe.route = self.orig


def _batch(cfg, arrays, rows, P, dtype):
    b = {"tokens": torch.from_numpy(arrays["tokens"][rows, :P].copy())}
    for k in ("frames", "embeds"):
        if k in arrays:
            b[k] = torch.from_numpy(arrays[k][rows].copy()).to(dtype)
    return b


def serve_single(cfg, params, case, log=None):
    """The port on one device: the prefill's last logits and each decode
    step's, (B, V) f32 numpy each, and the routing integers."""
    from repro_torch.models.api import get_api
    from repro_torch.models.transformer import DTYPES

    api = get_api(cfg)
    arrays = serve_arrays(cfg, case)
    plen, slots, pos0 = serve_lengths(cfg, case)
    routes = log.open() if log is not None else []
    toks = torch.from_numpy(arrays["tokens"])
    batch = _batch(cfg, arrays, slice(None), case["P"], DTYPES[cfg.dtype])
    with torch.no_grad():
        lg, cache = api.prefill(params, cfg, batch, cache_len=slots)
        out = [lg[:, -1].float().numpy()]
        for i in range(case["steps"]):
            t = case["P"] + i
            lg, cache = api.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                        pos0 + i)
            out.append(lg[:, 0].float().numpy())
    return {"logits": out, "routes": list(routes)}


def serve_world(rank, world, cases, trees):
    """Each case through `train_step.build_serve_step` on
    ``make_host_mesh(data, model)`` (data · model = world): the rank's
    blocks of the case's tree (numpy arrays carried by
    `params_from_arrays(mesh=)`, or tensors cut by `shard_params`), its
    rows of the inputs; prefill then ``steps`` decode steps. Returns per
    case the rank's rows, logits (f32 numpy), routing integers, and the
    local shapes of the cache blocks."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.interop import params_from_arrays
    from repro_torch.launch.mesh import (make_host_mesh, model_rank,
                                         model_size)
    from repro_torch.models import sharding as SH
    from repro_torch.models.transformer import DTYPES
    from repro_torch.train import train_step as TS

    log = RouteLog()
    out = []
    try:
        for case, tree in zip(cases, trees):
            cfg = serve_config(case)
            mesh = make_host_mesh(case["data"], case["model"])
            dp = ("data",)
            if isinstance(next(iter(_leaves(tree))), np.ndarray):
                params = params_from_arrays(cfg, tree, CPU, mesh=mesh)
            else:
                params = SH.shard_params(cfg, tree, mesh, dp)
            arrays = serve_arrays(cfg, case)
            B = case["B"]
            plen, slots, pos0 = serve_lengths(cfg, case)
            rows = slice(None)
            if SH.batch_pspec(mesh, dp, B)[0] is not None:
                per = B // case["data"]
                r = mesh.get_local_rank("data")
                rows = slice(r * per, (r + 1) * per)
            routes = log.open()
            prefill = TS.build_serve_step(
                cfg, mesh, dp, ShapeConfig("p", plen, B, "prefill"))[0]
            decode = TS.build_serve_step(
                cfg, mesh, dp, ShapeConfig("d", case["S"] if
                                           cfg.encoder_layers else slots,
                                           B, "decode"))[0]
            toks = torch.from_numpy(arrays["tokens"][rows].copy())
            with torch.no_grad():
                lg, cache = prefill(params, _batch(cfg, arrays, rows,
                                                   case["P"],
                                                   DTYPES[cfg.dtype]),
                                    cache_len=slots)
                logits = [lg[:, -1].float().numpy()]
                for i in range(case["steps"]):
                    t = case["P"] + i
                    lg, cache = decode(params, cache, toks[:, t:t + 1],
                                       pos0 + i)
                    logits.append(lg[:, 0].float().numpy())
            out.append({"rows": (rows.start, rows.stop), "logits": logits,
                        "model_rank": (model_rank(mesh), model_size(mesh)),
                        "routes": list(routes),
                        "cache": {k: {n: tuple(t.shape) for n, t in v.items()}
                                  for k, v in cache.items()}})
    finally:
        log.close()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def isolation_serve(rank, world):
    """Serving under a model axis of ``world`` through `build_serve_step`,
    each rank drawing its blocks (`init_params(mesh=)`); then the jax,
    JAX package and ml_dtypes modules loaded in this process."""
    import sys

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    mesh = make_host_mesh(1, world)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device=CPU,
                           mesh=mesh)
    toks = torch.zeros((2, 8), dtype=torch.long)
    prefill = TS.build_serve_step(cfg, mesh, ("data",),
                                  ShapeConfig("p", 8, 2, "prefill"))[0]
    decode = TS.build_serve_step(cfg, mesh, ("data",),
                                 ShapeConfig("d", 12, 2, "decode"))[0]
    lg, cache = prefill(params, {"tokens": toks}, cache_len=12)
    lg, cache = decode(params, cache, toks[:, :1], 8)
    assert bool(torch.isfinite(lg.float()).all())
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "repro", "ml_dtypes"))


# ------------------------------------------- training under a model axis
# A training case: {"arch", "shape" (mesh sizes), "names" (mesh axes),
# "B" (global rows), "S" (tokens a row), "steps", "vocab", "fsdp",
# "save" (a directory: the state after the steps is saved there, then one
# step more is taken), "restore" (a directory: the state is restored from
# it instead of drawn, and one step taken at the saved step), "remesh"
# (with "restore": the model axis the saved state is moved to),
# "resilient" (a checkpoint directory: the steps run through
# `ResilientLoop`, the parameter gather of step "fail_at" failing once)}.


def train_config(case):
    """The case's smoke config in f32, attending through the chunked
    twin (the training path), with its vocab and ``fsdp``."""
    import dataclasses

    cfg = serve_config(dict(case, dtype="float32"))
    return dataclasses.replace(cfg, attn_impl="xla_chunked")


def train_batch(cfg, case, step, mesh=None, dp_axes=("data",)):
    """Step ``step``'s batch of the case (`data.pipeline.make_batch`: the
    reference's numbers), this rank's rows under ``mesh``."""
    from repro_torch.data.pipeline import TokenStream, make_batch

    stream = TokenStream(cfg.vocab, case["B"], case["S"], seed=0)
    return make_batch(cfg, stream, step, device=CPU, mesh=mesh,
                      dp_axes=dp_axes)


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def train_single(cfg, params, case, steps):
    """The port's one-device steps from ``params`` (whole): each step's
    metrics and the parameters after them (f32 numpy, `adamw.leaves`
    order)."""
    from repro_torch.train import train_step as TS

    plan = TS.TrainPlan(cfg=cfg, warmup=1, total_steps=10)
    state = TS.init_state(params, plan.opt)
    step = TS.build_train_step(plan)
    out = []
    for s in range(steps):
        state, m = step(state, train_batch(cfg, case, s))
        out.append(_metrics(m))
    return {"metrics": out, "params": _leaves_np(state["params"])}


def _mesh_of(case):
    from repro_torch.launch.mesh import make_mesh

    names = tuple(case.get("names", ("data", "model")))
    return make_mesh(tuple(case["shape"]), names), tuple(
        a for a in names if a != "model")


def train_world(rank, world, cases, trees):
    """Each case through `build_train_step` on its mesh (the world's
    first ranks): the rank's blocks of the case's tree
    (`params_from_arrays(mesh=)`; whole at a model axis of 1, as the
    data-parallel step holds them) or of a restored checkpoint
    (``restore``: one step, at the saved step), its rows of each batch;
    ``steps`` AdamW steps with clipping. Returns per case each step's
    metrics, the parameters gathered whole (f32 numpy, `adamw.leaves`
    order), the local shapes of the parameters and moments and the
    ZeRO-1 slices. With ``save`` the state is saved after the steps (and
    returned whole) and one step more taken; with ``remesh`` (a model
    axis) the state saved by an earlier case of the same spawn is moved
    onto a mesh of that model axis by `elastic.remesh_state`, and its
    blocks compared with the restored ones."""
    from repro_torch.interop import params_from_arrays
    from repro_torch.launch.mesh import dp_rank
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import param_shapes
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import elastic as EL
    from repro_torch.train import train_step as TS

    out, kept = [], {}
    for case, tree in zip(cases, trees):
        cfg = train_config(case)
        mesh, dp = _mesh_of(case)
        plan = TS.TrainPlan(cfg=cfg, warmup=1, total_steps=10, mesh=mesh,
                            dp_axes=dp)
        specs = TS.state_specs(plan)
        cut = (dict(mesh=mesh, dp_axes=dp) if TS.model_parallel(plan)
               else {})
        if case.get("resilient"):
            out.append(_resilient(case, cfg, mesh, dp, plan, specs, TS.
                                  init_state(params_from_arrays(
                                      cfg, tree, CPU, **cut), plan.opt,
                                      plan)))
            continue
        if case.get("restore"):
            state, start = _restored(case["restore"], cfg, mesh, plan, specs)
            n = 1
        else:
            state = TS.init_state(params_from_arrays(
                cfg, tree, CPU, **cut), plan.opt, plan)
            start, n = 0, case["steps"]
        step = TS.build_train_step(plan)
        res = {"metrics": [], "dp_rank": dp_rank(mesh, dp),
               "coords": SH.mesh_coords(mesh),
               "local": [tuple(t.shape) for t in leaves(state["params"])],
               "moments": [tuple(t.shape) for t in leaves(state["opt"]["m"])],
               "shards": TS.zero1_shards(plan, state["params"])}
        if case.get("remesh"):
            placed, mcfg, mdp = kept[case["restore"]]
            new = EL.make_mesh_for(range(world), case["remesh"])
            moved = _local(EL.remesh_state(placed, new, lambda st, mesh: (
                TS.state_specs(TS.TrainPlan(cfg=mcfg, mesh=mesh,
                                            dp_axes=mdp)))))
            res["remeshed_equal"] = len(leaves(moved)) == len(leaves(
                state)) and all(torch.equal(a, b) for a, b in zip(
                    leaves(moved), leaves(state)))
        for s in range(start, start + n):
            state, m = step(state, train_batch(cfg, case, s, mesh, dp))
            res["metrics"].append(_metrics(m))
        if case.get("save"):
            CKPT.save(state, start + n, case["save"], mesh=mesh, specs=specs)
            whole = SH.gather_blocks(state, specs, mesh)
            res["saved"] = {"params": _leaves_np(whole["params"]),
                            "m": _leaves_np(whole["opt"]["m"]),
                            "v": _leaves_np(whole["opt"]["v"])}
            shapes = param_shapes(cfg)
            kept[case["save"]] = (_copy(_placed(state, specs, mesh, {
                "params": shapes, "opt": {"m": shapes, "v": shapes,
                                          "step": ()}})), cfg, dp)
            state, m = step(state, train_batch(cfg, case, start + n, mesh,
                                               dp))
            res["next"] = _metrics(m)
        res["params"] = _leaves_np(SH.gather_blocks(state["params"],
                                                    specs["params"], mesh))
        out.append(res)
    return out


def _placed(tree, specs, mesh, shapes) -> dict:
    """A tree of this rank's blocks as `elastic.Placed` leaves on ``mesh``
    under ``specs``, with the global ``shapes`` (a tree of the same
    keys)."""
    from repro_torch.train.elastic import Placed

    if isinstance(tree, dict):
        return {k: _placed(tree[k], specs[k], mesh, shapes[k]) for k in tree}
    return Placed(tree, tuple(specs), mesh, tuple(shapes), tree.dtype)


def _local(tree) -> dict:
    """The blocks of a tree of `elastic.Placed` leaves."""
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree.local


def _copy(tree):
    """A tree of `Placed` leaves with their blocks copied (the step
    updates the state in place)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree._replace(local=tree.local.clone())


def _restored(ckpt_dir, cfg, mesh, plan, specs):
    """(state, step): the latest checkpoint under ``ckpt_dir`` cut to
    this rank's blocks on ``mesh``."""
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import param_shapes
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS

    zeros = SH._map_with_path(lambda _, s: torch.zeros(s), param_shapes(cfg))
    like = TS.init_state(SH.shard_params(cfg, zeros, mesh, plan.dp_axes),
                         plan.opt, plan)
    return CKPT.restore(like, ckpt_dir, mesh=mesh, specs=specs)


def _resilient(case, cfg, mesh, dp, plan, specs, state):
    """``steps`` steps through `ResilientLoop` with a checkpoint after
    every step, the ZeRO-1 parameter gather of step ``fail_at`` failing
    once on every rank (a torn update): the loop's failures, each step's
    metrics as the loop reported them, and the parameters gathered whole
    at the end."""
    from repro_torch.models import sharding as SH
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    from repro_torch.train.fault_tolerance import (FaultToleranceConfig,
                                                   ResilientLoop)

    ckpt = CKPT.AsyncCheckpointer(case["resilient"], mesh=mesh, specs=specs)
    step_fn = TS.build_train_step(plan)
    # the first dim-0 slice gather of step ``fail_at``
    per_step = sum(s is not None and s[0] == 0 for s in TS.zero1_shards(
        plan, state["params"]))
    fail_call = case["fail_at"] * per_step + 1
    calls, orig = [0], TS.all_gather_rows

    def failing(*a, **k):
        calls[0] += 1
        if calls[0] == fail_call:
            raise RuntimeError("the gather fails once")
        return orig(*a, **k)

    def restore():
        ckpt.wait()
        return CKPT.restore(loop.state, case["resilient"], mesh=mesh,
                            specs=specs)

    metrics = {}
    loop = ResilientLoop(
        step_fn, state, lambda s: train_batch(cfg, case, s, mesh, dp),
        checkpointer=ckpt, ft=FaultToleranceConfig(ckpt_every=1),
        restore_fn=restore)
    TS.all_gather_rows = failing
    try:
        state, end = loop.run(0, case["steps"], lambda s, m: metrics.
                              __setitem__(s, _metrics(m)))
    finally:
        TS.all_gather_rows = orig
        ckpt.close()
    return {"failures": [(f["step"], f["action"]) for f in loop.failures],
            "torn": [f["error"] for f in loop.failures], "end": end,
            "per_step": per_step,
            "metrics": [metrics[s] for s in sorted(metrics)],
            "params": _leaves_np(SH.gather_blocks(state["params"],
                                                  specs["params"], mesh))}


def isolation_train(rank, world, ckpt_dir):
    """A train step under a model axis of ``world`` (each rank drawing its
    blocks), a whole-array checkpoint saved and restored; then the jax,
    JAX package and ml_dtypes modules loaded in this process."""
    import sys

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS

    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    mesh = make_host_mesh(1, world)
    plan = TS.TrainPlan(cfg=cfg, mesh=mesh)
    state = TS.init_state(T.init_params(
        cfg, torch.Generator().manual_seed(0), device=CPU, mesh=mesh),
        plan.opt, plan)
    batch = make_batch(cfg, TokenStream(cfg.vocab, 2, 24), 0, device=CPU,
                       mesh=mesh)
    state, m = TS.build_train_step(plan)(state, batch)
    assert bool(torch.isfinite(m["loss"]))
    specs = TS.state_specs(plan)
    CKPT.save(state, 1, ckpt_dir, mesh=mesh, specs=specs)
    back, at = CKPT.restore(state, ckpt_dir, mesh=mesh, specs=specs)
    assert at == 1 and all(torch.equal(a, b) for a, b in zip(
        leaves(back), leaves(state)))
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "repro", "ml_dtypes"))


# ------------------------------------------------------------ dry run
def _fill(tree, gen):
    """Give ``tree``'s tensors values a step can run on: integers 0 (ids
    in range), floats N(0, 0.02²)."""
    from torch.utils._pytree import tree_flatten

    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
            else:
                t.zero_()


def dryrun_counts(rank, world, mesh_shape, cases):
    """`launch.dryrun.step_of` of each ``(arch, ShapeConfig)`` of
    ``cases`` on a ``mesh_shape`` host mesh, on the CPU's tensors (filled
    by `_fill`), counted by `step_analysis.analyze_step`: rank 0's counts
    (FLOPs, bytes, collective bytes and counts by category, hand kernels),
    for the dry run on meta to equal."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dp_axes_of, make_host_mesh
    from repro_torch.launch.step_analysis import analyze_step

    mesh = make_host_mesh(*mesh_shape)
    out = []
    for arch, shape in cases:
        cfg = get_config(arch, smoke=True)
        fn, args = dryrun.step_of(cfg, shape, mesh, dp_axes_of(mesh),
                                  device=CPU)
        _fill(args, torch.Generator().manual_seed(rank))
        res = analyze_step(fn, *args)
        out.append({k: res[k] for k in ("flops", "bytes", "coll_bytes",
                                        "coll", "coll_count", "kernels")})
    return out


def summarize_step_world(rank, world, src, dst, root_of, n, seed):
    """`core.distributed.summarize_step_fn` under `make_data_mesh()` on
    this rank's block of the edges (padded with ``src == n``), both
    histograms, replicated and with ``sharded_out``: each output as this
    rank holds it."""
    from repro_torch.core.distributed import summarize_step_fn
    from repro_torch.launch.mesh import block, make_data_mesh

    mesh = make_data_mesh()
    E = -(-len(src) // world) * world
    pad = np.full(E - len(src), n, dtype=np.int64)
    s = torch.from_numpy(np.concatenate([src, pad])[block(E, rank, world)])
    d = torch.from_numpy(np.concatenate([dst, np.zeros_like(pad)])[
        block(E, rank, world)])
    r = torch.from_numpy(root_of)
    out = {}
    for hist in ("sort", "scatter"):
        for sharded in (False, True):
            step = summarize_step_fn(n, hist, mesh=mesh, sharded_out=sharded)
            out[hist, sharded] = [t.numpy() for t in step(s, d, r, seed)]
    return out
