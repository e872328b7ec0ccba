"""Multi-pod dry run: EVERY (architecture × applicable shape) on the
``(16, 16)`` single-pod mesh and the ``(2, 16, 16)`` multi-pod mesh, with
no allocation and no devices (the JAX package's `launch/dryrun.py`, which
lowers and compiles against ``ShapeDtypeStruct`` inputs).

How it runs: one process holds a world of 256 or 512 ranks through
PyTorch's fake process group (`fake_world`: collectives return at once and
move nothing), builds the production mesh on it
(`launch.mesh.make_production_mesh`) and runs the port's unchanged step —
`train_step.build_train_step` or `build_serve_step` — as rank 0, on
``meta`` tensors: the rank's blocks of the parameters, the optimizer state
and the cache, and its rows of the inputs (shapes and dtypes, no data).
The step's every op runs, and `launch.step_analysis` counts it; this is
the counterpart of lowering, not a CPU run of the program. Serving cells
prefill through the flash kernel (``attn_impl="pallas_flash"``, which on
meta returns its output's shape and reports its work), training attends
through the chunked twin, as on the card.

Per cell one JSON record under ``artifacts/dryrun_torch/`` (incremental:
existing records are kept unless ``--force``): `roofline.Roofline` of the
rank's counts times the number of cards (on H100 data-sheet figures),
``analytic_hbm`` (`launch/memory_model.py`), and in place of XLA's
``memory_analysis`` ``traced_peak_bytes``, the peak of the meta storages
alive during the step (``per_device_hbm``).

Usage:
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --summarize-step [--hist scatter]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from contextlib import contextmanager

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (dp_axes_of, make_host_mesh,
                                     make_production_mesh, mesh_sizes)
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import sharding as SH
from repro_torch.models.api import abstract_params, get_api, input_specs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import train_step as TS

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def cell_id(arch, shape, mesh_name, variant=""):
    v = f"_{variant}" if variant else ""
    return f"{arch}__{shape}__{mesh_name}{v}"


@contextmanager
def fake_world(world: int):
    """A process group of ``world`` ranks held by this one process as rank
    0 (PyTorch's fake backend: every collective returns at once and moves
    nothing), destroyed on exit. Raises if another group is active."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry run starts its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _blocks(tree, specs, sizes, coords):
    """Fresh empty tensors of the rank's blocks of ``tree``'s leaves (its
    dtype and device) under ``specs``: no leaf is a view of a whole one."""
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], sizes, coords)
                for k, v in tree.items()}
    blk = SH.local_block(tuple(tree.shape), specs, sizes, coords)
    return torch.empty(tuple(b.stop - b.start for b in blk),
                       dtype=tree.dtype, device=tree.device)


def _rows(batch: dict, mesh, dp, B: int) -> dict:
    """The rank's rows of each input (`sharding.batch_pspec`): a block of
    the global batch over the data axes where it divides, all of it
    otherwise."""
    spec = SH.batch_pspec(mesh, dp, B)
    n = math.prod(mesh_sizes(mesh)[a] for a in dp) if spec[0] else 1
    return {k: torch.empty((v.shape[0] // n, *v.shape[1:]), dtype=v.dtype,
                           device=v.device) for k, v in batch.items()}


def step_of(cfg, shape, mesh, dp, microbatch=None, absorbed_mla=False,
            moment_dtype="float32", device="meta", params=None,
            inputs=None):
    """``(fn, args)``: one step of ``cfg`` at ``shape`` on ``mesh`` as
    this rank runs it, on ``device`` tensors: the train step on the rank's
    train state, or prefill (through the flash kernel) or decode on its
    blocks of the parameters and the cache, with its rows of the inputs.
    ``params``: the rank's parameters, ``inputs``: its rows of a train or
    prefill batch (default: empty ones on ``device``)."""
    sizes = mesh_sizes(mesh)
    coords = SH.mesh_coords(mesh)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        plan = TS.TrainPlan(cfg=cfg, mesh=mesh, dp_axes=dp,
                            opt=AdamWConfig(moment_dtype=moment_dtype),
                            microbatch=microbatch)
        if params is None:
            whole = abstract_params(cfg, device)
            params = (_blocks(whole, TS.state_specs(plan, whole)["params"],
                              sizes, coords)
                      if TS.model_parallel(plan) else whole)
        state = TS.init_state(params, plan.opt, plan)
        rows = inputs or _rows(input_specs(cfg, shape, device), mesh, dp, B)
        return TS.build_train_step(plan), (state, rows)
    cfg = dataclasses.replace(cfg, attn_impl="pallas_flash")
    fn, pspecs, _, _ = TS.build_serve_step(cfg, mesh, dp, shape,
                                           absorbed_mla=absorbed_mla)
    if params is None:
        params = _blocks(abstract_params(cfg, device), pspecs, sizes, coords)
    if shape.kind == "prefill":
        rows = inputs or _rows(input_specs(cfg, shape, device), mesh, dp, B)
        return fn, (params, rows)
    with SH.mesh_context(mesh, dp, batch=B):
        cache = get_api(cfg).init_cache(cfg, B, S, device=device)
    token = _rows({"token": torch.empty((B, 1), dtype=torch.int32,
                                        device=device)}, mesh, dp, B)
    return fn, (params, cache, token["token"], S - 1)


def count_step(cfg, shape, mesh, dp, **kw) -> dict:
    """`step_analysis.analyze_step` of `step_of`'s step, with its seconds
    (``step_s``). The step's own result is dropped."""
    fn, args = step_of(cfg, shape, mesh, dp, **kw)
    t0 = time.perf_counter()
    counts = analyze_step(fn, *args)
    counts["step_s"] = time.perf_counter() - t0
    counts.pop("out")
    return counts


def _write(path, rec):
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             force: bool = False, variant: str = "", microbatch=None,
             remat=None, absorbed_mla=False, moment_dtype="float32",
             verbose=True):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_id(arch, shape_name, mesh_name,
                                         variant) + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name]
    app = applicable_shapes(cfg)[shape_name]
    if app != "run":
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": app}
        _write(path, rec)
        if verbose:
            print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:6s} "
                  f"SKIP ({app})")
        return rec
    if microbatch is None and shape.kind == "train" and cfg.train_microbatch:
        microbatch = cfg.train_microbatch  # per-arch default
    chips = math.prod(MESHES[mesh_name])
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
            dp = dp_axes_of(mesh)
            counts = count_step(cfg, shape, mesh, dp, microbatch=microbatch,
                                absorbed_mla=absorbed_mla,
                                moment_dtype=moment_dtype)
        peak = counts["peak_bytes"]
        rl = RL.from_counts(arch, shape_name, mesh_name, chips, counts, cfg,
                            shape, peak, counts["step_s"])
        rec = rl.to_json()
        try:
            from repro_torch.launch.memory_model import analytic_hbm
            rec["analytic_hbm"] = analytic_hbm(cfg, shape, mesh_sizes(mesh),
                                               dp, microbatch)
        except Exception as e:  # the analytic model never blocks the run
            rec["analytic_hbm"] = {"error": repr(e)}
        rec.update({"status": "ok", "variant": variant,
                    "microbatch": microbatch, "traced_peak_bytes": peak,
                    "kernels": counts["kernels"]})
        _write(path, rec)
        if verbose:
            print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:6s} OK "
                  f"hbm/dev={rec['per_device_hbm'] / 2**30:.2f}GiB "
                  f"t_comp={rec['t_compute'] * 1e3:.2f}ms "
                  f"t_mem={rec['t_memory'] * 1e3:.2f}ms "
                  f"t_coll={rec['t_collective'] * 1e3:.2f}ms "
                  f"bottleneck={rec['bottleneck']} "
                  f"({counts['step_s']:.0f}s traced)", flush=True)
        return rec
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": repr(e),
               "trace": traceback.format_exc()[-3000:]}
        _write(path, rec)
        if verbose:
            print(f"[dryrun] {arch:24s} {shape_name:12s} {mesh_name:6s} "
                  f"ERROR {e!r}", flush=True)
        return rec


def run_summarize_cell(mesh_name: str, out_dir: str, force: bool = False,
                       variant: str = "", sharded_out: bool = False,
                       hist: str = "sort", verbose=True):
    """Extra row: the paper's own distributed summarize step on the mesh
    (`core.distributed.summarize_step_fn`) over a UK-05-scale graph: each
    rank its block of the edges over the data axes, ``root_of`` whole.

    ``sharded_out=True`` is the §Perf iteration: keep the per-node shingle
    table SHARDED across the dp axes (reduce-scatter) instead of
    replicating it (all-reduce) — the downstream grouping only ever reads
    each node's shingle once, so replication is pure waste."""
    from repro_torch.core.distributed import summarize_step_fn

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_id("slugger-summarize", "edges_1b",
                                         mesh_name, variant) + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    chips = math.prod(MESHES[mesh_name])
    n_nodes, n_edges = 64_000_000, 1_024_000_000  # 0.8B undirected
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
        dp = dp_axes_of(mesh)
        shards = math.prod(mesh_sizes(mesh)[a] for a in dp)
        step = summarize_step_fn(n_nodes, hist=hist, mesh=mesh, data_axes=dp,
                                 sharded_out=sharded_out)
        edges = torch.empty((n_edges // shards,), dtype=torch.int32,
                            device="meta")
        t0 = time.perf_counter()
        res = analyze_step(step, edges, torch.empty_like(edges),
                           torch.empty((n_nodes,), dtype=torch.int32,
                                       device="meta"), 0)
    link = RL.link_bytes_per_s(chips)
    coll = dict(res["coll"])
    coll["count"] = res["coll_count"]
    rec = {
        "status": "ok", "arch": "slugger-summarize", "shape": "edges_1b",
        "mesh": mesh_name, "variant": variant, "chips": chips,
        "hlo_flops": float(res["flops"]) * chips,
        "hlo_bytes": float(res["bytes"]) * chips,
        "coll_bytes": float(res["coll_bytes"]) * chips,
        "coll_breakdown": coll, "compile_s": time.perf_counter() - t0,
        "t_compute": float(res["flops"]) / RL.PEAK_FLOPS["bfloat16"],
        "t_memory": float(res["bytes"]) / RL.HBM_BYTES_PER_S,
        "t_collective": float(res["coll_bytes"]) / link,
        "per_device_hbm": float(res["peak_bytes"]),
        "traced_peak_bytes": res["peak_bytes"],
    }
    _write(path, rec)
    if verbose:
        print(f"[dryrun] slugger-summarize edges_1b {mesh_name}"
              f"{' ' + variant if variant else ''}: OK "
              f"t_mem={rec['t_memory'] * 1e3:.1f}ms "
              f"t_coll={rec['t_collective'] * 1e3:.1f}ms "
              f"({rec['compile_s']:.0f}s)", flush=True)
    return rec


def count_one_rank(cfg, shape, device="meta", params=None, **kw) -> dict:
    """`count_step` of ``cfg`` at ``shape`` on a world of one rank (a
    ``(1, 1)`` mesh of `fake_world`): the same step on the card's tensors
    (``device="cuda"``, ``params`` the card's weights) and on meta counts
    alike."""
    with fake_world(1):
        mesh = make_host_mesh(1, 1)
        return count_step(cfg, shape, mesh, dp_axes_of(mesh), device=device,
                          params=params, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ARTIFACTS)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--variant", default="")
    ap.add_argument("--absorbed-mla", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--sharded-out", action="store_true")
    ap.add_argument("--hist", default="sort", choices=["sort", "scatter"])
    ap.add_argument("--summarize-step", action="store_true")
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.summarize_step:
        for m in meshes:
            run_summarize_cell(m, args.out, args.force, variant=args.variant,
                               sharded_out=args.sharded_out, hist=args.hist)
        return
    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for m in meshes:
                rec = run_cell(arch, shape, m, args.out, force=args.force,
                               variant=args.variant,
                               microbatch=args.microbatch, remat=args.remat,
                               absorbed_mla=args.absorbed_mla,
                               moment_dtype=args.moment_dtype)
                st = rec.get("status")
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_err += st == "error"
    print(f"[dryrun] done: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
