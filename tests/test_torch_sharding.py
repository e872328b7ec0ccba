"""Slice E5 of the port: the sharding spec tables (`models/sharding.py`),
`constrain`, the mesh builders and elastic re-meshing
(`train/elastic.py`), against the JAX package.

The spec functions are pure, so they are held to the reference's on
duck-typed meshes — ``{data: 16, model: 16}``, ``{pod: 2, data: 16,
model: 16}``, ``{data: 4, model: 2}``, ``{data: 8}`` (the reference reads
only ``mesh.shape``) — for every configuration in the registry at its
published size: parameter specs from both packages' shape trees, cache
specs of short decode caches, ZeRO-1 moment specs and batch
specs. `make_mesh_for` and `remesh_state` run in a gloo group of 4 CPU
ranks (`torch_dist.spawn`); the reference's mesh shapes come from a
subprocess with 8 host devices, as its own elastic test runs.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES, get_config as ref_config
from repro.models import sharding as RS
from repro.models.api import abstract_params, get_api as ref_api
from repro_torch.configs.registry import get_config as port_config
from repro_torch.launch.local_ranks import run_ranks
from repro_torch.models import sharding as SH
from repro_torch.models.api import get_api, param_shapes

from torch_dist import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2},
          "8": {"data": 8}}


class DuckMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _dp(shape):
    return tuple(a for a in shape if a != "model")


def _norm(spec):
    return tuple(spec)


def _ref_table(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in kp):
            _norm(v) for kp, v in flat}


def _port_table(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_table(v, path + (k,)))
        return out
    return {path: tree}


@pytest.fixture(scope="module")
def shape_trees():
    return {a: (abstract_params(ref_config(a)), param_shapes(port_config(a)))
            for a in ARCH_NAMES}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_zero1_specs_equal_the_reference(shape_trees, arch, mesh):
    shape = MESHES[mesh]
    rtree, ptree = shape_trees[arch]
    rleaves = {tuple(getattr(k, "key", k) for k in kp): leaf.shape
               for kp, leaf in jax.tree_util.tree_flatten_with_path(rtree)[0]}
    if "model" in shape:
        rspec = RS.param_pspecs(ref_config(arch), rtree, DuckMesh(shape),
                                _dp(shape))
        pspec = SH.param_pspecs(port_config(arch), ptree, shape, _dp(shape))
        got = _port_table(pspec)
        assert got == _ref_table(rspec)
    else:  # both read the model axis' size, so both refuse a mesh without
        with pytest.raises(KeyError):
            RS.param_pspecs(ref_config(arch), rtree, DuckMesh(shape),
                            _dp(shape))
        with pytest.raises(KeyError):
            SH.param_pspecs(port_config(arch), ptree, shape, _dp(shape))
        got = {p: (None,) * len(s) for p, s in rleaves.items()}
    for path, spec in got.items():
        z = SH.zero1_spec(spec, rleaves[path], shape, _dp(shape))
        rz = RS.zero1_spec(jax.sharding.PartitionSpec(*spec), rleaves[path],
                           DuckMesh(shape), _dp(shape))
        assert z == _norm(rz), (path, z, rz)


def _caches(arch, batch, length):
    """(reference cache shapes, the port's cache)."""
    rc, pc = ref_config(arch), port_config(arch)
    rapi, papi = ref_api(rc), get_api(pc)
    rcache = jax.eval_shape(lambda: rapi.init_cache(rc, batch, length))
    pcache = papi.init_cache(pc, batch, length, device="cpu")
    return rcache, pcache


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_reference(arch, batch):
    rcache, pcache = _caches(arch, batch, 256)
    for name, shape in MESHES.items():
        if "model" not in shape:  # the reference's rules read "model"
            continue
        rspec = RS.cache_pspecs(ref_config(arch), rcache, DuckMesh(shape),
                                _dp(shape), batch)
        pspec = SH.cache_pspecs(port_config(arch), pcache, shape,
                                _dp(shape), batch)
        assert _port_table(pspec) == _ref_table(rspec), name


@pytest.mark.parametrize("batch", [1, 3, 8, 16, 32, 64])
def test_batch_specs_equal_the_reference(batch):
    for shape in MESHES.values():
        want = RS.batch_pspec(DuckMesh(shape), _dp(shape), batch)
        assert SH.batch_pspec(shape, _dp(shape), batch) == _norm(want)


def test_constrain_is_the_identity_on_a_data_axis_and_raises_past_it():
    """`constrain` is the identity on the local tensor under every axis,
    the model axis too (the layout is explicit); past it, model code under
    a model axis above 1 with no process group behind it raises."""
    x = torch.ones(2, 3)
    assert SH.constrain(x, ("dp", None)) is x  # no context
    with SH.mesh_context({"data": 4, "model": 1}, ("data",)):
        assert SH.constrain(x, ("dp", None)) is x
    with SH.mesh_context({"data": 2, "model": 2}, ("data",)):
        assert SH.constrain(x, ("dp", None)) is x
        assert SH.constrain(x, ("model", "dp")) is x
        with pytest.raises(RuntimeError, match="process group"):
            SH.model_axis().sum(x)
    assert SH.current() is None


def _constrain_calls(monkeypatch, modules):
    """Each module's ``constrain`` replaced by a recorder: returns the
    list of (module, spec) calls, in order."""
    calls = []
    for mod in modules:
        orig = mod.constrain

        def rec(x, spec, _name=mod.__name__.rsplit(".", 1)[-1],
                _orig=orig):
            calls.append((_name, tuple(spec)))
            return _orig(x, spec)

        monkeypatch.setattr(mod, "constrain", rec)
    return calls


def test_the_model_code_calls_constrain_where_the_reference_does(
        monkeypatch):
    """Smoke forwards of the dense and the MoE family under a model axis
    of 2 (per-rank bodies, `run_ranks`) reach `constrain` where the
    reference's forwards do, module by module (the embedding, twice a
    block, twice an MoE layer), and equal the one-device forward; under a
    data axis alone the port runs unchanged."""
    import dataclasses

    from repro.models import moe as RM
    from repro.models import transformer as RT
    from repro_torch.models import moe as PM
    from repro_torch.models import transformer as T

    for arch in ("qwen2.5-3b", "qwen3-moe-235b-a22b"):
        cfg = dataclasses.replace(port_config(arch, smoke=True),
                                  dtype="float32")
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        toks = torch.zeros((1, 8), dtype=torch.long)
        plain = T.forward(params, cfg, toks)[0]
        with SH.mesh_context({"data": 1, "model": 1}, ("data",)):
            assert torch.equal(T.forward(params, cfg, toks)[0], plain)

        with monkeypatch.context() as mp:
            ref_calls = _constrain_calls(mp, [RT, RM])
            rcfg = ref_config(arch, smoke=True)
            RT.forward(RT.init_params(rcfg, jax.random.key(0)), rcfg,
                       jax.numpy.zeros((1, 8), jax.numpy.int32))
        with monkeypatch.context() as mp:
            port_calls = _constrain_calls(mp, [T, PM])
            sizes = {"data": 1, "model": 2}

            def body(r, model, data):
                blocks = SH.shard_params(cfg, params, sizes, ("data",),
                                         {"data": 0, "model": r})
                with SH.rank_context(sizes, ("data",), model, data):
                    return T.forward(blocks, cfg, toks)[0]

            for out in run_ranks(body, 2):
                torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)

        def count(calls):
            return {m: sum(1 for n, _ in calls if n == m)
                    for m in ("transformer", "moe")}

        # the reference traces its scanned layer body once: the embedding's
        # call, then one layer's; the port runs every layer
        per_rank, want = count(port_calls[:len(port_calls) // 2]), count(
            ref_calls)
        L = cfg.n_layers
        assert per_rank["transformer"] == 1 + L * (want["transformer"] - 1)
        assert per_rank["moe"] == L * want["moe"]
        assert want["transformer"] == 3 and want["moe"] == (
            2 if cfg.moe else 0), arch


# ---------------------------------------------------------------- world 4
SUBSETS, MPS = (1, 2, 3, 4), (1, 2, 3, 4)

REF_MESH_SHAPES = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.train.elastic import make_mesh_for

    devs = jax.devices()
    out = {f"{n},{mp}": list(make_mesh_for(devs[:n], mp).devices.shape)
           for n in json.loads(sys.argv[1]) for mp in json.loads(sys.argv[2])}
    print("SHAPES" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(4, "elastic_world", tmp_path_factory.mktemp("el4"),
                 SUBSETS, MPS)


def test_make_mesh_for_shapes_equal_the_reference(world4):
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", REF_MESH_SHAPES,
                        json.dumps(SUBSETS), json.dumps(MPS)],
                       capture_output=True, text=True, env=env, cwd=ROOT)
    line = [x for x in r.stdout.splitlines() if x.startswith("SHAPES")]
    assert line, r.stderr[-2000:]
    want = json.loads(line[0][len("SHAPES"):])
    for res in world4:
        got = {f"{n},{mp}": list(s) for (n, mp), s in res["shapes"].items()}
        assert got == want


@pytest.mark.parametrize("stage", [0, 1, 2], ids=["to4", "to2", "back4"])
def test_elastic_remesh_4_to_2_to_4_keeps_every_value(world4, stage):
    w = np.arange(32.0).reshape(8, 4)
    size = (4, 2, 4)[stage]
    for rank, res in enumerate(world4):
        st = res["stages"][stage]
        assert st["size"] == size
        np.testing.assert_array_equal(st["w"], w)
        assert int(st["step"]) == 3
        if rank >= size:
            assert st["local"] is None  # off the mesh
        else:  # data axis = rank // 2 on a (size // 2, 2) mesh
            n_data = size // 2
            blk = 8 // n_data
            d = rank // 2
            np.testing.assert_array_equal(st["local"],
                                          w[d * blk:(d + 1) * blk])
