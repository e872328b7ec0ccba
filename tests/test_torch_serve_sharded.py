"""Slice E6a of the port: `train_step.build_serve_step` under a model
axis, in gloo process groups of 2 and 4 CPU ranks (`torch_dist.spawn`),
against the port's one-device run and against the reference's
`build_serve_step` on ``make_host_mesh(d, m)`` over 8 host devices.

Every family's smoke model in f32 — dense (qwen2.5-3b), sliding window
(h2o-danube), MoE (qwen3-moe), MLA + MoE (deepseek-v2-lite, both decode
forms), SSM (mamba2), hybrid (zamba2), encoder-decoder (whisper) and VLM
(internvl2) — is served at meshes (1, 2), (1, 4) and (2, 2): each rank
carries its blocks of the reference's weights
(`interop.params_from_arrays(mesh=)`) and its rows of the inputs,
prefills and decodes 8 steps. The prefill's last logits and every decode
step's equal the port's one-device run at atol 1e-4 / rtol 1e-4 and the
reference's sharded steps at atol 2e-4 / rtol 1e-3 (the f32 tolerance of
the LM parity tests), and the MoE routing integers equal the one-device
run's exactly on every rank. The cases reach a time-sharded cache (kv
heads the model axis does not divide), a vocabulary that splits (256)
and one that does not (257), ``fsdp=True`` at (2, 2), batch 1 at (2, 2)
(the cache's time over the data axis) and a decode past the ring.

The reference runs in one subprocess with
``--xla_force_host_platform_device_count=8``, as
`tests/test_sharded_decode.py` runs it, its attention on its chunked
path (its Pallas kernel cannot run MLA); the reference's weights come
from the test process as ``.npz``.
"""
import dataclasses
import json
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
from repro_torch.models import sharding as SH
from repro_torch.train import train_step as TS

from torch_dist import spawn
from torch_dist_cases import serve_config, serve_lengths, serve_single

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-4, 1e-4            # the port's one-device run
REF_ATOL, REF_RTOL = 2e-4, 1e-3    # the reference's sharded steps
FAMILIES = ["qwen2.5-3b", "h2o-danube-1.8b", "qwen3-moe-235b-a22b",
            "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b",
            "whisper-small", "internvl2-26b"]
BASE = {"B": 4, "P": 8, "steps": 8, "S": 16}


def _grid(d, m):
    out = [dict(BASE, arch=a, data=d, model=m) for a in FAMILIES]
    out.append(dict(BASE, arch="deepseek-v2-lite-16b", data=d, model=m,
                    absorbed=True))
    return out


# the one case of each branch the reference also runs
BRANCH = [dict(BASE, arch="qwen2.5-3b", data=2, model=2, B=1),
          dict(BASE, arch="qwen2.5-3b", data=1, model=4, vocab=256),
          dict(BASE, arch="internvl2-26b", data=2, model=2, fsdp=True),
          dict(BASE, arch="h2o-danube-1.8b", data=1, model=4, S=8)]
WORLD2 = _grid(1, 2)
WORLD4 = _grid(1, 4) + _grid(2, 2) + BRANCH + [
    dict(BASE, arch=a, data=2, model=2, B=1)
    for a in ("deepseek-v2-lite-16b", "zamba2-7b", "whisper-small",
              "mamba2-130m")] + [
    dict(BASE, arch=a, data=1, model=4, vocab=256)
    for a in ("mamba2-130m", "whisper-small")] + [
    dict(BASE, arch=a, data=2, model=2, fsdp=True)
    for a in ("qwen3-moe-235b-a22b", "zamba2-7b", "whisper-small")] + [
    dict(BASE, arch=a, data=1, model=4, S=8)
    for a in ("qwen2.5-3b", "deepseek-v2-lite-16b", "zamba2-7b")]
REFERENCE = WORLD2 + _grid(1, 4) + _grid(2, 2) + BRANCH


def _id(c):
    extra = [k for k in ("absorbed", "fsdp", "vocab") if c.get(k)]
    return (f"{c['arch']}-{c['data']}x{c['model']}-b{c['B']}-S{c['S']}"
            + "".join(f"-{k}" for k in extra))


def _key(c):
    return (c["arch"], c.get("vocab") or 0)


REF_SERVE = textwrap.dedent("""
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
    from repro.launch.mesh import make_host_mesh
    from repro.models.api import get_api
    from repro.train.train_step import build_serve_step

    cases, wdir = json.loads(sys.argv[1]), sys.argv[2]
    out, caches = {}, {}

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
        if c.get("vocab"):
            cfg = dataclasses.replace(cfg, vocab=c["vocab"])
        if c.get("fsdp"):
            cfg = dataclasses.replace(cfg, fsdp=True)
        api = get_api(cfg)
        params = tree(dict(np.load(os.path.join(wdir, c["weights"]))))
        rng = np.random.default_rng(c.get("seed", 0))
        B, P, n, S = c["B"], c["P"], c["steps"], c["S"]
        toks = rng.integers(0, cfg.vocab, (B, P + n)).astype(np.int64)
        batch = {"tokens": jnp.asarray(toks[:, :P], jnp.int32)}
        if cfg.encoder_layers:
            batch["frames"] = jnp.asarray(rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32))
        if cfg.n_patches:
            batch["embeds"] = jnp.asarray(rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
        plen = pos0 = P + cfg.n_patches
        slots = S + cfg.n_patches
        mesh = make_host_mesh(c["data"], c["model"])
        dp = ("data",)
        absorbed = bool(c.get("absorbed"))
        step, psh, bsh, _ = build_serve_step(
            cfg, mesh, dp, ShapeConfig("p", plen, B, "prefill"),
            absorbed_mla=absorbed)
        pp = jax.device_put(params, psh)
        lg, _ = step(pp, {k: jax.device_put(v, bsh[k])
                          for k, v in batch.items()})
        res = [np.asarray(lg[:, -1], np.float32)]
        ckey = (c["weights"], B, P, S, c.get("seed", 0))
        if ckey not in caches:  # the one-device cache, as the reference's
            caches[ckey] = api.prefill(params, cfg, batch,  # own test
                                       cache_len=slots)[1]
        step, psh, insh, _ = build_serve_step(
            cfg, mesh, dp, ShapeConfig("d", slots, B, "decode"),
            absorbed_mla=absorbed)
        pp = jax.device_put(params, psh)
        cc = jax.device_put(caches[ckey], insh["cache"])
        for i in range(n):
            t = jnp.asarray(toks[:, P + i:P + i + 1], jnp.int32)
            lg, cc = step(pp, cc, jax.device_put(t, insh["token"]),
                          jnp.int32(pos0 + i))
            res.append(np.asarray(lg[:, 0], np.float32))
        out[c["id"]] = np.stack(res)
    np.savez(os.path.join(wdir, sys.argv[3]), **out)
    print("REF_SERVE_OK", len(cases))
""")


def _flat_np(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{path}{k}/"))
        return out
    return {path[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Everything the cases compare, built once: the reference's weights
    (jax), its sharded steps (one subprocess, started first), the gloo
    worlds of 2 and 4 ranks, and the port's one-device runs."""
    wdir = tmp_path_factory.mktemp("serve_ref")
    trees = {}
    for c in WORLD2 + WORLD4:
        k = _key(c)
        if k not in trees:
            rc = dataclasses.replace(ref_config(c["arch"], smoke=True),
                                     dtype="float32")
            if c.get("vocab"):
                rc = dataclasses.replace(rc, vocab=c["vocab"])
            trees[k] = jax.tree.map(np.asarray, ref_api(rc).init_params(
                rc, jax.random.key(0)))
            np.savez(wdir / f"w{len(trees)}.npz", **_flat_np(trees[k]))
            trees[k, "file"] = f"w{len(trees)}.npz"
    # the suite's workers share the machine: one thread a process
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    cases = [dict(c, id=_id(c), weights=trees[_key(c), "file"])
             for c in REFERENCE]
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SERVE, json.dumps(cases), str(wdir),
         "ref.npz"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        worlds = {}
        for world, cases in ((2, WORLD2), (4, WORLD4)):
            worlds[world] = spawn(world, "serve_world",
                                  tmp_path_factory.mktemp(f"serve{world}"),
                                  cases, [trees[_key(c)] for c in cases])
        single = {}
        for c in WORLD2 + WORLD4:
            cfg = serve_config(c)
            single[_id(c)] = serve_single(
                cfg, params_from_arrays(cfg, trees[_key(c)], "cpu"), c,
                _route_log())
        stdout, stderr = proc.communicate(timeout=900)
        assert "REF_SERVE_OK" in stdout, stderr[-3000:]
        ref = dict(np.load(wdir / "ref.npz"))
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
    by_case = {}
    for world, cases in ((2, WORLD2), (4, WORLD4)):
        for i, c in enumerate(cases):
            by_case[_id(c)] = [rank_res[i] for rank_res in worlds[world]]
    return {"ranks": by_case, "single": single, "ref": ref}


_LOG = []


def _route_log():
    from torch_dist_cases import RouteLog

    if not _LOG:
        _LOG.append(RouteLog())
    return _LOG[0]


def _rows(res):
    a, b = res["rows"]
    return slice(a, b)


@pytest.mark.parametrize("case", WORLD2 + WORLD4, ids=_id)
def test_serve_step_equals_the_one_device_run(served, case):
    want = served["single"][_id(case)]
    cfg = serve_config(case)
    _, slots, _ = serve_lengths(cfg, case)
    cspecs = SH.cache_pspecs(cfg, TS.cache_shapes(cfg, case["B"], slots),
                             {"data": case["data"], "model": case["model"]},
                             ("data",), case["B"])
    for rank, res in enumerate(served["ranks"][_id(case)]):
        rows = _rows(res)
        # make_host_mesh lays the ranks out row-major over (data, model)
        assert res["model_rank"] == (rank % case["model"], case["model"])
        assert len(res["logits"]) == case["steps"] + 1
        for got, w in zip(res["logits"], want["logits"]):
            np.testing.assert_allclose(got, w[rows], atol=ATOL, rtol=RTOL)
        assert len(res["routes"]) == len(want["routes"])
        for (e, s), (we, ws) in zip(res["routes"], want["routes"]):
            np.testing.assert_array_equal(e, we[rows])
            np.testing.assert_array_equal(s, ws[rows])
        for kind, by in res["cache"].items():
            for name, shape in by.items():
                full = TS.cache_shapes(cfg, case["B"], slots)[kind][name]
                spec = cspecs[kind][name]
                sizes = {"data": case["data"], "model": case["model"]}
                want_shape = tuple(
                    n // (1 if ax is None else sizes[ax])
                    for n, ax in zip(full, spec))
                assert shape == want_shape, (kind, name)
    if cfg.moe is not None:
        assert want["routes"]


@pytest.mark.parametrize("case", REFERENCE, ids=_id)
def test_serve_step_equals_the_reference_serve_step(served, case):
    want = served["ref"][_id(case)]
    for res in served["ranks"][_id(case)]:
        got = np.stack(res["logits"])
        np.testing.assert_allclose(got, want[:, _rows(res)], atol=REF_ATOL,
                                   rtol=REF_RTOL)


@pytest.mark.parametrize("case", [c for c in WORLD2 + WORLD4
                                  if c["arch"] in ("qwen3-moe-235b-a22b",
                                                   "deepseek-v2-lite-16b")],
                         ids=_id)
def test_routing_is_the_same_on_every_rank_of_a_batch_shard(served, case):
    ranks = served["ranks"][_id(case)]
    for res in ranks:
        same = [r for r in ranks if r["rows"] == res["rows"]]
        for other in same:
            for (e, s), (oe, os_) in zip(res["routes"], other["routes"]):
                assert np.array_equal(e, oe) and np.array_equal(s, os_)
