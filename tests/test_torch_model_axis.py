"""Slice E6a of the port, the model axis for serving, on per-rank bodies
in one process: the rank's blocks of the parameters and the cache
(`models/sharding.shard_params`, `shard_cache`, `local_block`), the
`launch.local_ranks` collectives, blocks drawn and carried by rank
(`init_params(mesh=)`, `interop.params_from_arrays(mesh=)`), and every
family's smoke model served tensor- and expert-parallel on
`local_ranks.run_ranks` (one thread a rank, ranks taking turns between
collectives) against the same model on one device.

The block cases run for every configuration in the registry, at model 2,
4 and 16 and at ``{data: 2, model: 2}`` with ``fsdp=True``: on the smoke
model's tensors (vocab 256, so the vocabulary splits), whose blocks
reassemble bit for bit, and on the published model's shapes (meta
tensors). Serving cases hold the prefill's last logits and every decode
step's to the one-device run at atol 1e-4 / rtol 1e-4 in f32 (bf16 at the
LM tests' bounds), and the MoE routing integers to it exactly; they
cover a time-sharded cache (kv heads the model axis does not divide), a
vocabulary that splits and one that does not, ``fsdp=True``, batch 1 at
(2, 2) (the cache's time over the data axis), and a decode past the
ring. `tests/test_torch_serve_sharded.py` runs the same through
`build_serve_step` in gloo process groups and against the reference.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.interop import params_from_arrays
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api, param_shapes
from repro_torch.train import train_step as TS

from torch_dist_cases import (RouteLog, _batch, serve_arrays, serve_config,
                              serve_lengths, serve_single)

DP = ("data",)
MESHES = {"m2": ({"data": 1, "model": 2}, False),
          "m4": ({"data": 1, "model": 4}, False),
          "m16": ({"data": 1, "model": 16}, False),
          "d2m2-fsdp": ({"data": 2, "model": 2}, True)}
ATOL = RTOL = 1e-4
# bf16: the LM tests' bounds (tests/test_torch_lm.py)
BF16_ATOL, BF16_REL_L2 = 0.08, 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-sized tensors gain nothing from torch's intra-op pool, and the
    suite's workers share the machine: one thread for this module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _coords(sizes):
    names = list(sizes)
    for idx in itertools.product(*(range(sizes[a]) for a in names)):
        yield dict(zip(names, idx))


def _want_shape(shape, spec, sizes):
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        out.append(dim // math.prod(sizes[a] for a in names))
    return tuple(out)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check_blocks(full, specs, sizes, cut):
    """Every rank's blocks (``cut(coords)``) have their spec's shapes,
    equal ``full`` at their slices, and together cover every element."""
    seen = {p: torch.zeros(t.shape, dtype=torch.bool)
            for p, t in _flat(full) if t.device.type != "meta"}
    for coords in _coords(sizes):
        blocks = cut(coords)
        for path, t in _flat(full):
            b, spec = _at(blocks, path), _at(specs, path)
            assert tuple(b.shape) == _want_shape(t.shape, spec, sizes), path
            if t.device.type == "meta":
                continue
            blk = SH.local_block(tuple(t.shape), spec, sizes, coords)
            assert torch.equal(b, t[blk]), path
            seen[path][blk] = True
    assert all(bool(v.all()) for v in seen.values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_blocks_have_their_spec_shapes_and_reassemble(arch, mesh):
    sizes, fsdp = MESHES[mesh]
    cfg = dataclasses.replace(get_config(arch, smoke=True), vocab=256,
                              fsdp=fsdp)
    full = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    specs = SH.param_pspecs(cfg, full, sizes, DP)
    _check_blocks(full, specs, sizes,
                  lambda c: SH.shard_params(cfg, full, sizes, DP, c))
    # the published model's shapes, on meta tensors
    pub = dataclasses.replace(get_config(arch), fsdp=fsdp or
                              get_config(arch).fsdp)
    meta = SH._map_with_path(lambda _, s: torch.empty(s, device="meta"),
                             param_shapes(pub))
    pspecs = SH.param_pspecs(pub, meta, sizes, DP)
    _check_blocks(meta, pspecs, sizes,
                  lambda c: SH.shard_params(pub, meta, sizes, DP, c))


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_blocks_have_their_spec_shapes_and_reassemble(arch, mesh,
                                                            batch):
    sizes, _ = MESHES[mesh]
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(1)
    full = SH._map_with_path(lambda _, s: torch.randn(s, generator=gen),
                             TS.cache_shapes(cfg, batch, 32))
    specs = SH.cache_pspecs(cfg, full, sizes, DP, batch)
    _check_blocks(full, specs, sizes,
                  lambda c: SH.shard_cache(cfg, full, sizes, DP, batch, c))
    pub = get_config(arch)
    meta = SH._map_with_path(lambda _, s: torch.empty(s, device="meta"),
                             TS.cache_shapes(pub, batch, 4096))
    _check_blocks(meta, SH.cache_pspecs(pub, meta, sizes, DP, batch), sizes,
                  lambda c: SH.shard_cache(pub, meta, sizes, DP, batch, c))


# ------------------------------------------------------------ collectives
def test_local_group_collectives_combine_in_rank_order():
    def body(r, model, data):
        x = torch.tensor([float(r), 10.0 * r, -float(r)])
        return (model.sum(x), model.max(x), model.gather(x[None], 0),
                model.gather(x[None], -1), model.sum_all(x, x[:1] * 2),
                model.rank, model.size, data.size)

    res = run_ranks(body, 4)
    want = torch.tensor([6.0, 60.0, -6.0])
    for r, (s, m, g0, g1, (a, b), rank, size, dsize) in enumerate(res):
        assert torch.equal(s, want) and torch.equal(m,
                                                    torch.tensor([3., 30., 0.]))
        assert g0.shape == (4, 3) and g1.shape == (1, 12)
        assert torch.equal(g0[2], torch.tensor([2.0, 20.0, -2.0]))
        assert torch.equal(a, want) and torch.equal(b, torch.tensor([12.0]))
        assert (rank, size, dsize) == (r, 4, 1)


def test_local_group_gives_each_rank_its_own_result():
    """A rank that writes into what a collective returned changes no other
    rank's tensor, as each NCCL rank holds its own buffer."""
    def body(r, model, data):
        s = model.sum(torch.ones(2))
        g = model.gather(torch.full((1,), float(r)), 0)
        s += r
        g[0] = -1.0 - r
        model.sum(torch.zeros(1))   # every rank has written before it reads
        return s, g

    res = run_ranks(body, 3)
    for r, (s, g) in enumerate(res):
        assert torch.equal(s, torch.full((2,), 3.0 + r))
        assert torch.equal(g, torch.tensor([-1.0 - r, 1.0, 2.0]))
    assert len({id(s) for s, _ in res}) == 3


def test_local_group_runs_one_rank_at_a_time_and_fails_together():
    live, most = [0], [0]

    def body(r, model, data):
        live[0] += 1
        most[0] = max(most[0], live[0])
        live[0] -= 1
        model.sum(torch.ones(1))
        live[0] += 1
        most[0] = max(most[0], live[0])
        live[0] -= 1
        return data.sum(torch.tensor([float(r)]))

    res = run_ranks(body, 2, data=2)
    assert most[0] == 1
    # ranks (0, 2) and (1, 3) share a data group
    assert [float(t) for t in res] == [2.0, 4.0, 2.0, 4.0]

    def bad(r, model, data):
        if r == 1:
            raise ValueError("rank 1 fails")
        return model.sum(torch.ones(1))

    with pytest.raises(ValueError, match="rank 1 fails"):
        run_ranks(bad, 3)

    def mismatched(r, model, data):
        return model.sum(torch.ones(1)) if r else model.max(torch.ones(1))

    with pytest.raises(RuntimeError, match="disagree"):
        run_ranks(mismatched, 2)


def test_a_model_axis_without_a_process_group_raises():
    cfg = get_config("qwen2.5-3b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with SH.mesh_context({"data": 1, "model": 2}, DP):
        assert SH.constrain(toks, ("dp", None)) is toks
        with pytest.raises(RuntimeError, match="needs a process group"):
            T.forward(params, cfg, toks)
    with SH.mesh_context({"data": 1, "model": 1}, DP):
        assert SH.model_axis().size == 1 and not SH.split(8)


def test_a_cuda_tensor_on_a_gloo_group_raises(tmp_path):
    """The model axis' collectives over a process group take a CUDA
    tensor only under NCCL: under gloo they raise, before any collective
    (a tensor that says it lives on the card stands in for one)."""
    import types

    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        ax = SH.GroupAxis(dist.group.WORLD)
        assert (ax.size, ax.rank, ax.backend) == (1, 0, "gloo")
        assert torch.equal(ax.sum(torch.ones(3)), torch.ones(3))
        card = types.SimpleNamespace(is_cuda=True)
        for op in (ax.sum, ax.max, lambda t: ax.gather(t, 0)):
            with pytest.raises(RuntimeError, match="NCCL"):
                op(card)
    finally:
        dist.destroy_process_group()


def test_training_under_a_model_axis_still_raises():
    """Training under a model axis runs on a `DeviceMesh` over a process
    group (`tests/test_torch_train_sharded.py`); on a plain mapping, which
    has no ranks to reduce the gradients over, the step refuses."""
    for mesh in ({"data": 1, "model": 2}, {"data": 2, "model": 1}):
        plan = TS.TrainPlan(cfg=get_config("qwen2.5-3b", smoke=True),
                            mesh=mesh)
        with pytest.raises(ValueError, match="needs a DeviceMesh"):
            TS.build_train_step(plan)


# --------------------------------------------------- blocks drawn by rank
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_params_on_a_mesh_draws_the_rank_blocks(arch):
    """World 1 is `init_params` itself; on {data 2, model 2} every block
    has its spec's shape, ranks that hold one block (data replicas, a
    replicated leaf) draw the same numbers, and the blocks differ from
    one another where they split a leaf."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), vocab=256,
                              fsdp=arch == "internvl2-26b")
    api = get_api(cfg)
    one = api.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    same = api.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu", mesh={"data": 1, "model": 1},
                           coords={"data": 0, "model": 0})
    for (_, a), (_, b) in zip(_flat(one), _flat(same)):
        assert torch.equal(a, b)
    sizes = {"data": 2, "model": 2}
    specs = SH.param_pspecs(cfg, one, sizes, DP)
    drawn = {tuple(c.items()): api.init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu", mesh=sizes,
        coords=c) for c in _coords(sizes)}
    for path, t in _flat(one):
        spec = _at(specs, path)
        by_block = {}
        for key, tree in drawn.items():
            b = _at(tree, path)
            coords = dict(key)
            assert tuple(b.shape) == _want_shape(t.shape, spec, sizes)
            blk = tuple((s.start, s.stop) for s in SH.local_block(
                tuple(t.shape), spec, sizes, coords))
            if blk in by_block:
                assert torch.equal(by_block[blk], b), path
            by_block[blk] = b
        if len(by_block) > 1 and t.dtype.is_floating_point \
                and t.std() > 0:
            first, *rest = by_block.values()
            assert not any(torch.equal(first, b) for b in rest), path


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "zamba2-7b", "whisper-small"])
def test_params_from_arrays_on_a_mesh_carries_the_rank_blocks(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), vocab=256,
                              fsdp=True)
    full = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    arrays = SH._map_with_path(lambda _, t: t.float().numpy(), full)
    sizes = {"data": 2, "model": 2}
    for c in _coords(sizes):
        got = params_from_arrays(cfg, arrays, "cpu", mesh=sizes, coords=c)
        want = SH.shard_params(cfg, full, sizes, DP, c)
        for (p, a), (_, b) in zip(_flat(got), _flat(want)):
            assert torch.equal(a, b.float()), p
    with pytest.raises(ValueError, match="shape"):
        bad = dict(arrays, embed=arrays["embed"][:-1])
        params_from_arrays(cfg, bad, "cpu", mesh=sizes, coords=c)


def test_build_serve_step_specs_are_the_tables():
    cfg = get_config("qwen2.5-3b", smoke=True)
    sizes = {"data": 2, "model": 4}
    fn, pspecs, ins, shapes = TS.build_serve_step(
        cfg, sizes, DP, ShapeConfig("d", 32, 8, "decode"))
    assert pspecs == SH.param_pspecs(cfg, shapes, sizes, DP)
    assert ins["cache"] == SH.cache_pspecs(
        cfg, T.cache_shapes(cfg, 8, 32), sizes, DP, 8)
    assert ins["token"] == ("data", None) and ins["pos"] == ()
    _, _, ins, _ = TS.build_serve_step(cfg, sizes, DP,
                                       ShapeConfig("p", 16, 1, "prefill"))
    assert ins == {"tokens": (None, None)}


# ------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def route_log():
    log = RouteLog()
    yield log
    log.close()


def serve_ranks(cfg, params, case, log):
    """The case on `run_ranks`: each rank its blocks (`shard_params`) and
    rows, prefill and decode under `rank_context`."""
    sizes = {"data": case["data"], "model": case["model"]}
    arrays = serve_arrays(cfg, case)
    B = case["B"]
    plen, slots, pos0 = serve_lengths(cfg, case)
    cspecs = SH.cache_pspecs(cfg, TS.cache_shapes(cfg, B, slots), sizes, DP,
                             B)
    api = get_api(cfg)
    dtype = T.DTYPES[cfg.dtype]

    def body(r, model, data):
        coords = {"data": data.rank, "model": model.rank}
        pp = SH.shard_params(cfg, params, sizes, DP, coords)
        rows = slice(None)
        if SH.batch_pspec(sizes, DP, B)[0] is not None:
            per = B // case["data"]
            rows = slice(data.rank * per, (data.rank + 1) * per)
        toks = torch.from_numpy(arrays["tokens"][rows].copy())
        routes = log.open()
        with SH.rank_context(sizes, DP, model, data, batch=B):
            lg, cache = api.prefill(pp, cfg, _batch(cfg, arrays, rows,
                                                    case["P"], dtype),
                                    cache_len=slots)
        out = [lg[:, -1].float().numpy()]
        with SH.rank_context(sizes, DP, model, data, batch=B, cache=cspecs):
            for i in range(case["steps"]):
                t = case["P"] + i
                lg, cache = api.decode_step(pp, cfg, cache,
                                            toks[:, t:t + 1], pos0 + i)
                out.append(lg[:, 0].float().numpy())
        return rows, out, list(routes), cache

    return run_ranks(body, case["model"], case["data"])


FAMILIES = ["qwen2.5-3b", "h2o-danube-1.8b", "qwen3-moe-235b-a22b",
            "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b",
            "whisper-small", "internvl2-26b"]
GRID = [(1, 2), (1, 4), (2, 2)]
BASE = {"B": 4, "P": 8, "steps": 8, "S": 16}
CASES = [dict(BASE, arch=a, data=d, model=m) for a in FAMILIES
         for d, m in GRID]
CASES += [dict(BASE, arch="deepseek-v2-lite-16b", data=d, model=m,
               absorbed=True) for d, m in GRID]
CASES += [dict(BASE, arch=a, data=2, model=2, B=1) for a in FAMILIES]
CASES += [dict(BASE, arch=a, data=1, model=4, vocab=256)
          for a in ("qwen2.5-3b", "mamba2-130m", "whisper-small")]
CASES += [dict(BASE, arch=a, data=2, model=2, fsdp=True)
          for a in ("internvl2-26b", "qwen3-moe-235b-a22b", "zamba2-7b",
                    "whisper-small")]
CASES += [dict(BASE, arch=a, data=1, model=4, S=8)  # past the ring
          for a in ("qwen2.5-3b", "deepseek-v2-lite-16b", "h2o-danube-1.8b",
                    "zamba2-7b")]
BF16_CASES = [dict(BASE, arch=a, data=d, model=m, dtype="bfloat16")
              for a, (d, m) in (("qwen2.5-3b", (1, 4)),
                                ("qwen3-moe-235b-a22b", (2, 2)),
                                ("zamba2-7b", (1, 4)),
                                ("whisper-small", (2, 2)))]


def _id(c):
    extra = [k for k in ("absorbed", "fsdp", "vocab", "dtype")
             if c.get(k)]
    return (f"{c['arch']}-{c['data']}x{c['model']}-b{c['B']}-S{c['S']}"
            + "".join(f"-{k}" for k in extra))


def _params(cfg):
    return get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sharded_serving_equals_one_device(case, route_log):
    cfg = serve_config(case)
    params = _params(cfg)
    want = serve_single(cfg, params, case, route_log)
    ranks = serve_ranks(cfg, params, case, route_log)
    for rows, logits, routes, _ in ranks:
        assert len(logits) == case["steps"] + 1
        for got, w in zip(logits, want["logits"]):
            np.testing.assert_allclose(got, w[rows], atol=ATOL, rtol=RTOL)
        assert len(routes) == len(want["routes"])
        for (e, s), (we, ws) in zip(routes, want["routes"]):
            np.testing.assert_array_equal(e, we[rows])
            np.testing.assert_array_equal(s, ws[rows])
    if cfg.moe is not None:
        assert want["routes"]


def _gap(got, want):
    return (np.abs(got - want).max(),
            np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", BF16_CASES, ids=_id)
def test_sharded_serving_bf16_within_the_lm_bounds(case, route_log):
    """bf16 at the LM tests' bounds against the one-device bf16 run; the
    hybrid (6 blocks) as `tests/test_torch_hybrid.py` holds deep models:
    its gap to the f32 run of the same weights at most 1.1 × the
    one-device bf16 run's (the rounding floor)."""
    cfg = serve_config(case)
    params = _params(cfg)
    one = np.stack(serve_single(cfg, params, case, route_log)["logits"])
    if cfg.attn_every:
        c32 = dataclasses.replace(cfg, dtype="float32")
        p32 = SH._map_with_path(lambda _, t: t.float(), params)
        f32 = np.stack(serve_single(c32, p32, case)["logits"])
    for rows, logits, _, _ in serve_ranks(cfg, params, case, route_log):
        got = np.stack(logits)
        assert np.isfinite(got).all()
        if cfg.attn_every:
            for g, floor in zip(_gap(got, f32[:, rows]),
                                _gap(one[:, rows], f32[:, rows])):
                assert g <= 1.1 * floor
        else:
            worst, rel = _gap(got, one[:, rows])
            assert worst <= BF16_ATOL and rel <= BF16_REL_L2


def test_time_sharded_cache_blocks_hold_the_one_device_cache(route_log):
    """qwen2.5-3b at model 4 (2 kv heads): each rank's cache block after
    the prefill and 8 decode steps is its slice of the one-device
    cache."""
    case = dict(BASE, arch="qwen2.5-3b", data=1, model=4)
    cfg = serve_config(case)
    params = _params(cfg)
    api = get_api(cfg)
    arrays = serve_arrays(cfg, case)
    toks = torch.from_numpy(arrays["tokens"])
    _, cache = api.prefill(params, cfg, {"tokens": toks[:, :8]},
                           cache_len=16)
    for i in range(8):
        _, cache = api.decode_step(params, cfg, cache, toks[:, 8 + i:9 + i],
                                   8 + i)
    sizes = {"data": 1, "model": 4}
    specs = SH.cache_pspecs(cfg, cache, sizes, DP, 4)
    assert specs["attn"]["k"][2] == "model"
    for r, (_, _, _, block) in enumerate(serve_ranks(cfg, params, case,
                                                     route_log)):
        want = SH.shard_cache(cfg, cache, sizes, DP, 4,
                              {"data": 0, "model": r})
        for (p, a), (_, b) in zip(_flat(block), _flat(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=str(p))
