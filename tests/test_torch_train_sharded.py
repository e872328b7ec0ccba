"""Training under a model axis: the collectives' backward passes
(`models/sharding.py`), every family's gradients on the rank's blocks,
`train_step.build_train_step` tensor- and expert-parallel with ZeRO-1 over
model blocks, the global norm across the ranks, whole-array checkpoints,
re-meshing of blocks (`train/elastic.py`) and the driver's
``--model-parallel`` (`launch/train.py`).

- **Collectives.** `Axis.sum`, `gather`, `sum_all` and `sharding.take` on
  `local_ranks.run_ranks` at m 2 and 4, in float64: each rank's gradient
  of its input equals the gradient of the same function composed on one
  process, of the ranks' losses summed (the convention of
  `models/sharding.py`). `Axis.max`'s backward raises.
- **Per-leaf gradients.** Every family's smoke model in f32 at m 2 and 4
  (and ``fsdp`` at (2, 2)) as per-rank bodies: each leaf's gradient,
  SUMmed by `train_step.reduce_grads` and assembled from the ranks'
  blocks, equals the one-device gradient at atol 1e-5 / rtol 1e-4, with a
  vocabulary that splits (256) and one that does not (257); MoE routing
  integers equal the one-device run's.
- **Train steps.** In gloo process groups (`torch_dist.spawn`) at (1, 2),
  (1, 4) and (2, 2), and over the data axes ``("pod", "data")`` at (2, 1,
  2) and (2, 2, 1): three AdamW steps with clipping equal the port's
  one-device steps at atol 2e-4 / rtol 1e-3 (loss, grad norm, every
  parameter), and the reference's `build_train_step` on
  ``make_host_mesh(d, m)`` over 8 host devices (one subprocess) at the
  tolerance of `tests/test_torch_train.py::test_train_step_matches_jax`:
  loss and grad norm at atol 2e-4 / rtol 1e-3 (those of step 2 after
  the sharded update of step 1), each parameter within 3·Σ lr. The reference covers every family at (2, 2), ``fsdp`` at (2,
  2), and qwen2.5-3b at (1, 2) and (1, 4).
- **Checkpoints and re-meshing.** A state saved at (2, 2) holds whole
  arrays in the reference's format and restores at (1, 1) and (1, 4) to
  an equal next step, as does the data-parallel step's with ``fsdp``
  (its parameters whole) saved at (2, 1) on one device;
  `elastic.remesh_state` moves the first from model axis 2
  to 4 with the values unchanged; ``launch.train --model-parallel 2
  --data-parallel 2`` trains on 4 ranks and resumes on 2; a ZeRO-1
  parameter gather that fails at (2, 2) tears the update, and
  `ResilientLoop` restores and replays to the uninterrupted run's end.
- **Refusals and the backward's thread.** The production meshes need
  exactly their world; a state under a model axis needs the rank's
  blocks; under a mesh context the backward runs on the calling thread,
  which holds the layout that remat's recompute reads.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models.api import get_api as ref_api
from repro_torch.interop import params_from_arrays
from repro_torch.launch import train as LT
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import sharding as SH
from repro_torch.models.api import get_api, param_shapes
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS

from torch_dist import spawn
from torch_dist_cases import (RouteLog, train_batch, train_config,
                              train_single)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4  # per-rank gradients against one device
ATOL, RTOL = 2e-4, 1e-3            # train steps (the LM parity tolerance)
FAMILIES = ["qwen2.5-3b", "h2o-danube-1.8b", "qwen3-moe-235b-a22b",
            "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b",
            "whisper-small", "internvl2-26b"]
# three steps: warmup 1 gives step 0 a learning rate of 0, so the loss and
# grad norm of step 2 are the first to see a sharded update twice over
BASE = {"B": 4, "S": 24, "steps": 3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-sized tensors gain nothing from torch's intra-op pool, and the
    suite's workers share the machine: one thread for this module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------ collectives' backward
def _vjp_case(m, fn, shape=(3, 8)):
    """Each rank's gradient of its ``x_r`` under ``loss_r = Σ w_r ·
    fn(axis, x_r)`` (``run_ranks``), and the same gradients of ``Σ_r
    loss_r`` composed on one process from ``whole(xs)``, the collective's
    value."""
    gen = torch.Generator().manual_seed(m)
    xs = [torch.randn(shape, generator=gen, dtype=torch.float64)
          for _ in range(m)]
    ws = [torch.randn(1, generator=gen, dtype=torch.float64)
          for _ in range(m)]

    def body(r, model, data):
        x = xs[r].clone().requires_grad_(True)
        with SH.rank_context({"data": 1, "model": m}, ("data",), model, data):
            y = fn(SH.model_axis(), x)
        loss = sum((w * t).sum() for w, t in zip(
            torch.randn(len(y), generator=torch.Generator().manual_seed(r),
                        dtype=torch.float64), y)) * ws[r]
        return torch.autograd.grad(loss, x)[0], [t.detach() for t in y]

    return xs, ws, run_ranks(body, m)


def _composed(m, xs, ws, per_rank):
    """Gradients of ``Σ_r loss_r`` w.r.t. every ``x_r``, with rank r's
    outputs ``per_rank(r, xs)`` computed from every rank's input."""
    leaves = [x.clone().requires_grad_(True) for x in xs]
    total = 0.0
    for r in range(m):
        y = per_rank(r, leaves)
        weights = torch.randn(len(y), generator=torch.Generator().manual_seed(
            r), dtype=torch.float64)
        total = total + sum((w * t).sum() for w, t in zip(weights, y)) * ws[r]
    return torch.autograd.grad(total, leaves)


def _check(m, fn, per_rank, shape=(3, 8)):
    xs, ws, ranks = _vjp_case(m, fn, shape)
    want = _composed(m, xs, ws, per_rank)
    for r, (g, y) in enumerate(ranks):
        torch.testing.assert_close(g, want[r], atol=1e-12, rtol=1e-10)
        for got, w in zip(y, per_rank(r, xs)):
            torch.testing.assert_close(got, w.detach(), atol=1e-12,
                                       rtol=1e-12)


@pytest.mark.parametrize("m", [2, 4])
def test_sum_gather_and_sum_all_have_their_adjoints(m):
    _check(m, lambda ax, x: [ax.sum(x * x)],
           lambda r, xs: [sum(x * x for x in xs)])
    for dim in (0, 1, -1):
        _check(m, lambda ax, x, d=dim: [ax.gather(x.tanh(), d)],
               lambda r, xs, d=dim: [torch.cat([x.tanh() for x in xs], d)])
    _check(m, lambda ax, x: ax.sum_all(x, x[:1] * 3),
           lambda r, xs: [sum(xs), sum(x[:1] * 3 for x in xs)])


@pytest.mark.parametrize("m", [2, 4])
def test_take_gradient_lands_in_the_rank_block(m):
    """`sharding.take` of columns inside the rank's block (a view) and
    across blocks (gathered, each rank slicing other columns): the
    reduce-scatter of the gather's backward puts every rank's use of a
    column into the block that holds it."""
    n = 8 * m

    def spans(r):
        inside = (r * 8 + 2, r * 8 + 6)
        across = ((r * 5) % (n - 12), (r * 5) % (n - 12) + 12)
        return inside, across

    def fn(ax, x):
        return [SH.take(x, n, *span) for span in spans(ax.rank)]

    def per_rank(r, xs):
        whole = torch.cat(xs, -1)
        return [whole[..., a:b] for a, b in spans(r)]

    _check(m, fn, per_rank)


def test_max_has_no_backward():
    def body(r, model, data):
        x = torch.ones(3, requires_grad=True)
        y = model.max(x * (r + 1))
        assert torch.equal(y.detach(), torch.full((3,), 2.0))
        with pytest.raises(RuntimeError, match="no backward"):
            torch.autograd.grad(y.sum(), x)
        return True

    assert run_ranks(body, 2) == [True, True]
    # the identity axis of one rank records nothing
    x = torch.ones(2, requires_grad=True)
    assert SH.SOLO.max(x) is x and SH.SOLO.sum(x) is x


# --------------------------------------------------- per-rank gradients
GRAD_CASES = ([dict(arch=a, data=1, model=m) for a in FAMILIES
               for m in (2, 4)]
              + [dict(arch=a, data=1, model=4, vocab=256)
                 for a in ("qwen2.5-3b", "whisper-small", "mamba2-130m")]
              + [dict(arch=a, data=1, model=4, vocab=257)
                 for a in ("qwen2.5-3b", "internvl2-26b")]
              + [dict(arch=a, data=2, model=2, fsdp=True)
                 for a in ("qwen3-moe-235b-a22b", "internvl2-26b",
                           "whisper-small", "zamba2-7b")])


def _gid(c):
    extra = [f"{k}{c[k]}" if k == "vocab" else k
             for k in ("vocab", "fsdp") if c.get(k)]
    return "-".join([c["arch"], f"{c['data']}x{c['model']}", *extra])


def _grad_inputs(cfg):
    rng = np.random.default_rng(0)
    B, S = 4, 24
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32))}
    if cfg.encoder_layers:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
    if cfg.n_patches:
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return out


def _paths(tree, path=()):
    """The key paths of ``tree``'s leaves in `adamw.leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]


_LOG = []


def _route_log():
    if not _LOG:
        _LOG.append(RouteLog())
    return _LOG[0]


@pytest.fixture(scope="module", autouse=True)
def _restore_route():
    """Unwrap `moe.route` when the module is done: a wrapper left with an
    open log would log (and copy to the host) every later test's routing
    in this process, meta tensors included."""
    yield
    while _LOG:
        _LOG.pop().close()


@pytest.mark.parametrize("case", GRAD_CASES, ids=_gid)
def test_rank_gradients_assemble_to_the_one_device_gradient(case):
    cfg = train_config(dict(case, **BASE))
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    batch = _grad_inputs(cfg)
    log = _route_log()
    want_routes = log.open()
    loss1, want = TS.loss_and_grads(params, cfg, batch)
    want_routes = list(want_routes)
    d, m = case["data"], case["model"]
    sizes = {"data": d, "model": m}
    sums = TS.grad_sums(cfg, sizes, ("data",))

    def body(r, model, data):
        coords = {"data": r // m, "model": r % m}
        blocks = SH.shard_params(cfg, params, sizes, ("data",), coords)
        per = batch["tokens"].shape[0] // d
        rows = {k: v[coords["data"] * per:(coords["data"] + 1) * per]
                for k, v in batch.items()}
        routes = log.open()
        with SH.rank_context(sizes, ("data",), model, data):
            loss, raw = TS.loss_and_grads(blocks, cfg, rows)
            grads = TS.reduce_grads(list(raw), sums, d)
        return loss, raw, grads, coords, list(routes)

    ranks = run_ranks(body, m, d)
    specs = adamw.leaves(SH.param_pspecs(cfg, param_shapes(cfg), sizes,
                                         ("data",)))
    for i, (w, spec) in enumerate(zip(want, specs)):
        whole = torch.full_like(w, float("nan"))
        for _, _, grads, coords, _ in ranks:
            blk = SH.local_block(tuple(w.shape), spec, sizes, coords)
            if not torch.isnan(whole[blk]).all():  # replicas agree
                torch.testing.assert_close(whole[blk], grads[i], atol=0,
                                           rtol=0)
            whole[blk] = grads[i]
        torch.testing.assert_close(whole, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   msg=lambda e, i=i: f"leaf {i}: {e}")
    # the SUM is needed: a replicated leaf's unreduced gradient is a share
    final = _paths(params).index(("final_norm",))
    assert sums[final] and not torch.allclose(
        ranks[0][1][final], want[final], atol=GRAD_ATOL, rtol=GRAD_RTOL)
    if d == 1:  # every rank's loss is the whole batch's
        for loss, *_ in ranks:
            assert math.isclose(float(loss), float(loss1), rel_tol=1e-5)
    if cfg.moe is not None and d == 1:
        assert want_routes
        for *_, routes in ranks:
            assert len(routes) == len(want_routes)
            for (e, s), (we, ws) in zip(routes, want_routes):
                np.testing.assert_array_equal(e, we)
                np.testing.assert_array_equal(s, ws)


def test_production_meshes_need_exactly_their_world(tmp_path):
    """`make_production_mesh` builds the reference's (16, 16) and (2, 16,
    16) only on a world of exactly 256 or 512 ranks: it never clamps."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        for multi, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"a world of {n} ranks"):
                M.make_production_mesh(multi_pod=multi)
        with pytest.raises(ValueError, match="needs 4 ranks"):
            M.make_mesh((2, 1, 2), ("pod", "data", "model"))
        mesh = M.make_mesh((1, 1, 1), ("pod", "data", "model"))
        assert M.dp_axes_of(mesh) == ("pod", "data")
        assert M.dp_size(mesh) == 1 and M.dp_rank(mesh) == 0
    finally:
        dist.destroy_process_group()


def test_a_model_axis_state_needs_the_rank_blocks():
    """`init_state` under a model axis takes the rank's blocks: whole
    parameters raise, the blocks of any rank pass the check."""
    cfg = train_config(dict(BASE, arch="qwen2.5-3b"))
    whole = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    sizes = {"data": 1, "model": 2}
    plan = TS.TrainPlan(cfg=cfg, mesh=sizes)
    with pytest.raises(ValueError, match="the rank's blocks"):
        TS.init_state(whole, plan.opt, plan)
    blocks = SH.shard_params(cfg, whole, sizes, ("data",),
                             {"data": 0, "model": 1})
    TS._check_blocks(plan, blocks)


def test_backward_under_a_mesh_runs_on_the_calling_thread(monkeypatch):
    """The layout is thread-local, and the backward's recompute (remat'd
    layers, loss chunks) reads it: under a mesh context `loss_and_grads`
    runs the backward with autograd's multithreading off, so a CUDA
    backward stays on the thread that holds the layout (on the CPU it
    always does); with no context it is left as it is."""
    cfg = train_config(dict(BASE, arch="qwen2.5-3b"))
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    batch = _grad_inputs(cfg)
    seen, grad = [], torch.autograd.grad

    def spy(*a, **k):
        seen.append(torch._C._is_multithreading_enabled())
        return grad(*a, **k)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    TS.loss_and_grads(params, cfg, batch)
    with SH.mesh_context({"data": 1, "model": 1}, ("data",)):
        TS.loss_and_grads(params, cfg, batch)
    assert seen == [True, False]


def test_global_norm_counts_each_block_once():
    """`adamw.global_norm` with the ranks' axes: the blocks' squares SUMmed
    over their axis, a replicated leaf counted once — the whole tree's
    norm; with no axes it is the one-process expression bit for bit."""
    gen = torch.Generator().manual_seed(0)
    whole = {"a": torch.randn(8, 6, generator=gen),
             "b": torch.randn(5, generator=gen)}
    want = adamw.global_norm(whole)
    assert torch.equal(want, torch.sqrt(sum(
        torch.square(t.float()).sum() for t in adamw.leaves(whole))))

    def body(r, model, data):
        tree = {"a": whole["a"][:, r * 3:(r + 1) * 3], "b": whole["b"]}
        return adamw.global_norm(tree, [model, None])

    for got in run_ranks(body, 2):
        torch.testing.assert_close(got, want, atol=0, rtol=1e-6)


# ------------------------------------------------------------ the steps
def _case(arch, shape, names=("data", "model"), **kw):
    return dict(BASE, arch=arch, shape=tuple(shape), names=tuple(names),
                **kw)


def _sid(c):
    extra = [k for k in ("fsdp", "save", "restore", "resilient") if c.get(k)]
    return "-".join([c["arch"], "x".join(map(str, c["shape"])),
                     "".join(n[0] for n in c["names"]), *extra])


POD = ("pod", "data", "model")
# the data-parallel step holds fsdp's parameters whole: saved by its specs
DP_FSDP = _case("internvl2-26b", (2, 1), fsdp=True, save=True)
WORLD2 = [_case("qwen2.5-3b", (1, 2)), DP_FSDP]
FSDP = [_case("internvl2-26b", (2, 2), fsdp=True),
        _case("qwen3-moe-235b-a22b", (2, 2), fsdp=True)]
PODS = [_case("qwen2.5-3b", (2, 1, 2), POD),
        _case("qwen3-moe-235b-a22b", (2, 2, 1), POD)]
WORLD4 = ([_case(a, (2, 2)) for a in FAMILIES]
          + [_case("qwen2.5-3b", (1, 4))] + FSDP + PODS)
# the reference's cases, each compiled once in one subprocess: every family
# at (2, 2), qwen2.5-3b at (1, 2) and (1, 4), and fsdp
REFERENCE = WORLD2[:1] + WORLD4[:len(FAMILIES) + 1] + FSDP[:1]
RESILIENT = _case("qwen2.5-3b", (2, 2), resilient=True, fail_at=1, steps=3)
SAVE = _case("qwen2.5-3b", (2, 2), save=True)
RESTORE = _case("qwen2.5-3b", (1, 4), restore=True, remesh=4)


REF_TRAIN = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_config
    from repro.data import pipeline as RP
    from repro.launch.mesh import make_host_mesh
    from repro.optim import adamw as RA
    from repro.train.train_step import TrainPlan, build_train_step

    cases, wdir = json.loads(sys.argv[1]), sys.argv[2]
    out = {}

    def tree(flat):
        t = {}
        for k, v in flat.items():
            *path, leaf = k.split("/")
            node = t
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return t

    for c in cases:
        cfg = dataclasses.replace(get_config(c["arch"], smoke=True),
                                  dtype="float32", attn_impl="xla_chunked")
        if c.get("fsdp"):
            cfg = dataclasses.replace(cfg, fsdp=True)
        params = tree(dict(np.load(os.path.join(wdir, c["weights"]))))
        mesh = make_host_mesh(*c["shape"])
        plan = TrainPlan(cfg=cfg, mesh=mesh, dp_axes=("data",),
                         opt=RA.AdamWConfig(), warmup=1, total_steps=10)
        step, ssh, bsh, _ = build_train_step(
            plan, ShapeConfig("t", c["S"], c["B"], "train"))
        state = jax.device_put({"params": params,
                                "opt": RA.init_state(params)}, ssh)
        stream = RP.TokenStream(cfg.vocab, c["B"], c["S"], 0)
        metrics = []
        for s in range(c["steps"]):
            b = RP.make_batch(cfg, stream, s)
            state, m = step(state, {k: jax.device_put(v, bsh[k])
                                    for k, v in b.items()})
            metrics.append([float(m[k]) for k in ("loss", "grad_norm",
                                                  "lr")])
        out[c["id"] + "/metrics"] = np.asarray(metrics)
        for i, leaf in enumerate(jax.tree.leaves(state["params"])):
            out[f"{c['id']}/p{i}"] = np.asarray(leaf, np.float32)
    np.savez(os.path.join(wdir, "ref.npz"), **out)
    print("REF_TRAIN_OK", len(cases))
""")


def _flat_np(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{path}{k}/"))
        return out
    return {path[:-1]: np.asarray(tree)}


CLI = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
       "--ckpt-every", "2", "--log-every", "100"]
BF16 = dict(rel_tol=2e-2, abs_tol=2e-2)  # the smoke model trains in bf16


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Everything the step cases compare, built once: the reference's
    weights (jax, a tree an arch), its sharded steps (one subprocess,
    started first), the gloo worlds of 2 and 4 ranks (the checkpoint
    saved at (2, 2) and restored at (1, 4) in the second), the port's
    one-device runs, and the driver's runs."""
    wdir = tmp_path_factory.mktemp("train_ref")
    ckpt = str(tmp_path_factory.mktemp("train_ckpt"))
    trees, files = {}, {}
    for c in WORLD2 + WORLD4:
        if c["arch"] not in trees:
            rc = dataclasses.replace(ref_config(c["arch"], smoke=True),
                                     dtype="float32")
            trees[c["arch"]] = jax.tree.map(np.asarray, ref_api(
                rc).init_params(rc, jax.random.key(0)))
            files[c["arch"]] = f"w{len(files)}.npz"
            np.savez(wdir / files[c["arch"]], **_flat_np(trees[c["arch"]]))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    cases = [dict(c, id=_sid(c), weights=files[c["arch"]])
             for c in REFERENCE]
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_TRAIN, json.dumps(cases), str(wdir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        save = dict(SAVE, save=ckpt)
        restore = dict(RESTORE, restore=ckpt)
        resilient = dict(RESILIENT, resilient=str(tmp_path_factory.mktemp(
            "resilient")))
        world4 = WORLD4 + [save, restore, resilient]
        dp_ckpt = str(tmp_path_factory.mktemp("dp_fsdp_ckpt"))
        world2 = [dict(c, save=dp_ckpt) if c.get("save") else c
                  for c in WORLD2]
        ranks = {2: spawn(2, "train_world", tmp_path_factory.mktemp("tw2"),
                          world2, [trees[c["arch"]] for c in WORLD2]),
                 4: spawn(4, "train_world", tmp_path_factory.mktemp("tw4"),
                          world4, [trees[c["arch"]] for c in world4])}
        by_case = {}
        for world, cs in ((2, world2), (4, world4)):
            for i, c in enumerate(cs):
                by_case[_sid(c)] = [r[i] for r in ranks[world]]
        single = {}
        for c in WORLD2 + WORLD4 + [SAVE, RESILIENT]:
            cfg = train_config(c)
            params = params_from_arrays(cfg, trees[c["arch"]], "cpu")
            single[_sid(c)] = train_single(
                cfg, params, c, steps=c["steps"] + bool(c.get("save")))
        # the checkpoint on one device: restored whole, one step
        cfg = train_config(SAVE)
        like = TS.init_state(params_from_arrays(cfg, trees["qwen2.5-3b"],
                                                "cpu"))
        state, at = CKPT.restore(like, ckpt)
        one = TS.build_train_step(TS.TrainPlan(cfg=cfg, warmup=1,
                                               total_steps=10))(
            state, train_batch(cfg, SAVE, at))[1]
        restored = {"at": at, "metrics": {k: float(v) for k, v in
                                          one.items()}}
        cli = _cli_runs(tmp_path_factory)
        stdout, stderr = proc.communicate(timeout=900)
        assert "REF_TRAIN_OK" in stdout, stderr[-3000:]
        ref = dict(np.load(wdir / "ref.npz"))
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"ranks": by_case, "single": single, "ref": ref, "cli": cli,
            "restored": restored, "ckpt": ckpt, "dp_ckpt": dp_ckpt}


def _cli_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_ckpt"))
    four = spawn(4, "dp_cli", tmp_path_factory.mktemp("cli4"),
                 CLI + ["--data-parallel", "2", "--model-parallel", "2",
                        "--steps", "4", "--ckpt-dir", d])
    two = spawn(2, "dp_cli", tmp_path_factory.mktemp("cli2"),
                CLI + ["--model-parallel", "2", "--steps", "6", "--resume",
                       "--ckpt-dir", d])
    plain = LT.main(CLI + ["--steps", "6", "--ckpt-dir",
                           str(tmp_path_factory.mktemp("cli0"))])
    return four, two, plain


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


@pytest.mark.parametrize("case", WORLD2 + WORLD4, ids=_sid)
def test_sharded_steps_equal_the_one_device_steps(trained, case):
    want = trained["single"][_sid(case)]
    cfg = train_config(case)
    sizes = dict(zip(case["names"], case["shape"]))
    specs = adamw.leaves(TS.state_specs(TS.TrainPlan(
        cfg=cfg, mesh=sizes, dp_axes=tuple(
            a for a in case["names"] if a != "model")))["params"])
    for rank, res in enumerate(trained["ranks"][_sid(case)]):
        assert len(res["metrics"]) == case["steps"]
        for got, w in zip(res["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm", "lr"):
                _close(got[k], w[k], what=f"rank {rank} {k}")
        for i, (got, w) in enumerate(zip(res["params"], want["params"])):
            _close(got, w, what=f"rank {rank} leaf {i}")
        # the rank's blocks: each leaf's spec shape; the moments cut from
        # them by ZeRO-1 over the data axes only
        for local, moment, shard, spec, shape in zip(
                res["local"], res["moments"], res["shards"], specs,
                adamw.leaves(param_shapes(cfg))):
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            assert local == tuple(n // math.prod(
                sizes[a] for a in ((e,) if isinstance(e, str) else e or ()))
                for n, e in zip(shape, spec))
            if shard is None:
                assert moment == local
            else:
                dim, start, length = shard
                assert moment == local[:dim] + (length,) + local[dim + 1:]
    # the loss metric is the same on every rank
    losses = {tuple(m["loss"] for m in r["metrics"])
              for r in trained["ranks"][_sid(case)]}
    assert len(losses) == 1
    # the data group's ranks in row-major order over the data axes (the
    # row blocks of the batch, the ZeRO-1 slices)
    for rank, res in enumerate(trained["ranks"][_sid(case)]):
        coords = res["coords"]
        assert coords == dict(zip(case["names"], np.unravel_index(
            rank, case["shape"])))
        want_dp = 0
        for a in case["names"]:
            if a != "model":
                want_dp = want_dp * sizes[a] + coords[a]
        assert res["dp_rank"] == want_dp


@pytest.mark.parametrize("case", REFERENCE, ids=_sid)
def test_sharded_steps_equal_the_reference_steps(trained, case):
    ref = trained["ref"]
    want = ref[_sid(case) + "/metrics"]
    lrs = want[:, 2]
    for res in trained["ranks"][_sid(case)]:
        got = np.asarray([[m[k] for k in ("loss", "grad_norm", "lr")]
                          for m in res["metrics"]])
        _close(got, want)
        for i, p in enumerate(res["params"]):
            gap = np.abs(p - ref[f"{_sid(case)}/p{i}"]).max()
            # Adam moves an entry by at most ≈ 1.2·lr a step (the bound of
            # tests/test_torch_train.py::test_train_step_matches_jax)
            assert gap <= 3 * lrs.sum(), (i, gap)


def test_a_checkpoint_holds_whole_arrays_and_restores_on_other_meshes(
        trained):
    """Saved at (2, 2): the files hold the whole state in the reference's
    layout (the gathered blocks, ZeRO-1 slices whole); restored at (1, 4)
    (blocks equal to the ones `remesh_state` moved from (2, 2)) and at
    (1, 1), the next step equals the one the saving run took."""
    saved = trained["ranks"][_sid(SAVE)]
    step = SAVE["steps"]
    cfg = train_config(SAVE)
    state_like = TS.init_state(get_api(cfg).init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu"))
    whole, at = CKPT.restore(state_like, trained["ckpt"])
    assert at == step
    for name, tree in (("params", whole["params"]),
                       ("m", whole["opt"]["m"]), ("v", whole["opt"]["v"])):
        for got, want in zip(adamw.leaves(tree), saved[0]["saved"][name]):
            np.testing.assert_array_equal(got.numpy(), want)
    for res in saved:
        np.testing.assert_equal(res["saved"], saved[0]["saved"])
    want = saved[0]["next"]
    for res in trained["ranks"][_sid(RESTORE)]:
        assert res["remeshed_equal"]
        for k in ("loss", "grad_norm", "lr"):
            _close(res["metrics"][0][k], want[k], what=k)
    assert trained["restored"]["at"] == step
    for k in ("loss", "grad_norm", "lr"):
        _close(trained["restored"]["metrics"][k], want[k], what=k)
    _close(want["loss"], trained["single"][_sid(SAVE)]["metrics"][step][
        "loss"])


def test_a_data_parallel_fsdp_checkpoint_holds_whole_arrays(trained):
    """At a model axis of 1 the step holds fsdp's parameters whole and its
    moments as ZeRO-1 slices: saved at (2, 1) by `state_specs`, the files
    hold the whole state, and the next step equals one device's."""
    saved = trained["ranks"][_sid(DP_FSDP)]
    step = DP_FSDP["steps"]
    cfg = train_config(DP_FSDP)
    state_like = TS.init_state(get_api(cfg).init_params(
        cfg, torch.Generator().manual_seed(1), device="cpu"))
    whole, at = CKPT.restore(state_like, trained["dp_ckpt"])
    assert at == step
    for name, tree in (("params", whole["params"]),
                       ("m", whole["opt"]["m"]), ("v", whole["opt"]["v"])):
        for got, want in zip(adamw.leaves(tree), saved[0]["saved"][name]):
            np.testing.assert_array_equal(got.numpy(), want)
    one = trained["single"][_sid(DP_FSDP)]["metrics"][step]
    for res in saved:
        for k in ("loss", "grad_norm", "lr"):
            _close(res["next"][k], one[k], what=k)


def test_driver_trains_under_a_model_axis_and_resumes_on_two_ranks(trained):
    four, two, plain = trained["cli"]
    assert len(four[0]) == 4 and all(r == four[0] for r in four)
    assert len(two[0]) == 2 and two[0] == two[1]
    assert len(plain) == 6
    for a, b in zip(four[0] + two[0], plain):
        assert math.isfinite(a) and math.isclose(a, b, **BF16), (a, b)


def test_a_torn_update_under_a_model_axis_restores_and_replays(trained):
    """`ResilientLoop` under a model axis: the ZeRO-1 parameter gather of
    step 1 fails once on every rank, the update is torn (`adamw.
    TornUpdate`), the loop restores the checkpoint of step 1 and replays
    it, and the run ends where an uninterrupted one does."""
    want = trained["single"][_sid(RESILIENT)]
    for res in trained["ranks"][_sid(RESILIENT)]:
        assert res["per_step"] > 0
        assert res["failures"] == [(1, "restore")]
        assert "TornUpdate" in res["torn"][0]
        assert res["end"] == RESILIENT["steps"]
        for got, w in zip(res["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm", "lr"):
                _close(got[k], w[k], what=k)
        for i, (got, w) in enumerate(zip(res["params"], want["params"])):
            _close(got, w, what=f"leaf {i}")
