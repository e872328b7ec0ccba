"""The port's SSM and hybrid families (`models/transformer.py` over
`models/ssm.py`; slice F4) against the JAX package's, on the CPU:
mamba2-130m's and zamba2-7b's smoke configs, and zamba2 cut to 5 layers
at ``attn_every=2`` (groups of 2, 2 and 1: a trailing partial group, still
followed by the shared block).

The reference initialises each model (`jax.random`); its weights come
across through `interop.params_from_arrays`. Token inputs are drawn with
numpy. Float32 at the reference's tolerance between its two attention
paths (atol 2e-4, rtol 1e-3; under ``attn_impl="pallas_flash"`` the JAX
kernel runs in interpret mode); bf16 at the LM tests' bounds for 2-block
models and single blocks, and deeper ones at the reference's own bf16
distance from its f32 run (the rounding floor). Decode
against a teacher-forced forward is held, as in the reference's own
`tests/test_serving.py`, at atol 5e-2 for these families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config as port_config
from repro_torch.interop import params_from_arrays
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as PT
from repro_torch.models.api import get_api as port_api

MODELS = ["mamba2-130m", "zamba2-7b", "zamba2-5"]
IMPLS = ["pallas_flash", "xla_chunked"]
ATOL, RTOL = 2e-4, 1e-3
BF16_ATOL, BF16_REL_L2 = 0.08, 2e-2
SSM_DECODE_ATOL = 5e-2  # tests/test_serving.py:62-69


def _configs(name, dtype="float32", impl="pallas_flash"):
    """(reference config, port config); ``zamba2-5`` is zamba2-7b's smoke
    config at 5 layers."""
    arch, layers = ("zamba2-7b", 5) if name == "zamba2-5" else (name, None)
    out = []
    for get in (ref_config, port_config):
        c = dataclasses.replace(get(arch, smoke=True), dtype=dtype,
                                attn_impl=impl)
        out.append(c if layers is None
                   else dataclasses.replace(c, n_layers=layers))
    return tuple(out)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(name, dtype="float32"):
        if (name, dtype) not in cache:
            rc, pc = _configs(name, dtype)
            rp = RT.init_params(rc, jax.random.key(0))
            pp = params_from_arrays(pc, jax.tree.map(np.asarray, rp),
                                    device="cpu")
            cache[name, dtype] = (rp, pp)
        return cache[name, dtype]

    return get


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_groups_and_cache_layout():
    """81 = 13·6 + 3: fourteen groups, the last partial, so fourteen
    shared-block applications and fourteen attention cache entries."""
    full = port_config("zamba2-7b")
    groups = PT._hybrid_groups(full)
    assert groups == RT._hybrid_groups(ref_config("zamba2-7b"))
    assert len(groups) == 14 and groups[-1] == (78, 3)
    _, pc = _configs("zamba2-5")
    assert PT._hybrid_groups(pc) == [(0, 2), (2, 2), (4, 1)]
    cache = PT.init_cache(pc, 2, 10, device="cpu")
    want = jax.eval_shape(lambda: RT.init_cache(_configs("zamba2-5")[0], 2,
                                                10))
    got = {k: tuple(t.shape) for k, t in _leaves(cache)}
    assert got == {k: tuple(s.shape) for k, s in _leaves(want)}
    assert cache["attn"]["k"].shape[0] == 3
    assert cache["mamba"]["state"].dtype == torch.float32


# --------------------------------------------------------------- weights
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_params_from_arrays_round_trips(name, dtype):
    """The reference's tree bit for bit, its dtypes kept: A_log, D and
    dt_bias stay float32 in a bf16 model; the shared block is unstacked."""
    rc, pc = _configs(name, dtype)
    tree = jax.tree.map(np.asarray, RT.init_params(rc, jax.random.key(3)))
    params = params_from_arrays(pc, tree, device="cpu")
    flat = dict(_leaves(tree))
    got = dict(_leaves(params))
    assert set(got) == set(flat)
    for path, a in flat.items():
        t = got[path]
        assert tuple(t.shape) == a.shape
        f32 = path.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias")
        assert t.dtype == (torch.float32 if f32 else getattr(torch, dtype))
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.uint16).view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)
    if pc.attn_every:
        assert params["shared_attn"]["attn"]["wq"].dim() == 2
    bad = dict(tree, layers=dict(tree["layers"], ln=tree["layers"]["ln"][1:]))
    with pytest.raises(ValueError, match="ln"):
        params_from_arrays(pc, bad, device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_init_params_shapes_dtypes_and_distributions(name):
    rc, pc = _configs(name, "bfloat16")
    params = PT.init_params(pc, torch.Generator().manual_seed(0),
                            device="cpu")
    want = jax.eval_shape(lambda k: RT.init_params(rc, k), jax.random.key(0))
    got = dict(_leaves(params))
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in got.items()} == \
        {k: (tuple(s.shape), str(s.dtype)) for k, s in _leaves(want)}
    m = params["layers"]["mamba"]
    assert (m["A_log"] == 0).all() and (m["dt_bias"] == 0).all()
    assert (m["D"] == 1).all() and (m["norm_w"] == 1).all()
    assert (m["conv_b"] == 0).all() and (params["layers"]["ln"] == 1).all()
    assert abs(m["conv_w"].float().std().item() - 0.1) < 0.02
    din = pc.d_model
    assert abs(m["in_proj"].float().std().item() * np.sqrt(din) - 1) < 0.05
    again = PT.init_params(pc, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["layers"]["mamba"]["conv_w"], m["conv_w"])


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(models, name, impl):
    """Logits and every cache: the Mamba2 states and conv histories
    stacked on L, the shared block's K/V on its applications."""
    rc, pc = _configs(name, impl=impl)
    rp, pp = models(name)
    toks = np.random.default_rng(1).integers(0, rc.vocab, size=(2, 19))
    want, waux, rcache = RT.forward(rp, rc, jnp.asarray(toks, jnp.int32),
                                    return_caches=True)
    n = flash_kernel.LAUNCHES
    got, aux, pcache = PT.forward(pp, pc, torch.from_numpy(toks),
                                  return_caches=True)
    assert flash_kernel.LAUNCHES == n  # the CPU runs the plain version
    assert got.shape == want.shape and aux == 0.0 and float(waux) == 0.0
    _close(got, want)
    assert set(pcache) == set(rcache)
    got_c, want_c = dict(_leaves(pcache)), dict(_leaves(rcache))
    assert set(got_c) == set(want_c)
    for path, t in got_c.items():
        assert tuple(t.shape) == want_c[path].shape, path
        _close(t, want_c[path])


def _bf16_gap(got, want):
    got, want = _np(got), _np(want)
    return (np.abs(got - want).max(),
            np.linalg.norm(got - want) / np.linalg.norm(want))


def test_forward_bf16_matches_jax(models):
    """mamba2-130m's smoke model (2 blocks) in bf16 at the LM tests'
    bounds."""
    rc, pc = _configs("mamba2-130m", "bfloat16")
    rp, pp = models("mamba2-130m", "bfloat16")
    toks = np.random.default_rng(2).integers(0, rc.vocab, size=(2, 24))
    want = RT.forward(rp, rc, jnp.asarray(toks, jnp.int32))[0]
    got = PT.forward(pp, pc, torch.from_numpy(toks))[0]
    assert got.dtype == torch.bfloat16
    worst, rel = _bf16_gap(got, want)
    assert worst <= BF16_ATOL and rel <= BF16_REL_L2


def test_shared_block_bf16_matches_jax(models):
    """zamba2's two kinds of block in bf16 on the same input, each at the
    LM tests' bounds: the first Mamba2 block and the shared attention
    block (`tests/test_torch_ssm.py` holds the Mamba2 block's parts)."""
    rc, pc = _configs("zamba2-7b", "bfloat16")
    rp, pp = models("zamba2-7b", "bfloat16")
    x = np.random.default_rng(0).standard_normal(
        (2, 24, pc.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    want = RT.attn_block_full(rp["shared_attn"], rc, xj, jnp.asarray(pos))[0]
    got = PT.attn_block_full(pp["shared_attn"], pc, xt,
                             torch.from_numpy(pos))[0]
    worst, rel = _bf16_gap(got.float() - xt.float(), want.astype(
        jnp.float32) - xj.astype(jnp.float32))
    assert worst <= BF16_ATOL and rel <= BF16_REL_L2
    want = RT.ssm_block_full(jax.tree.map(lambda a: a[0], rp["layers"]), rc,
                             xj)[0]
    got = PT.ssm_block_full(PT.layer(pp["layers"], 0), pc, xt)[0]
    worst, rel = _bf16_gap(got.float() - xt.float(), want.astype(
        jnp.float32) - xj.astype(jnp.float32))
    assert worst <= BF16_ATOL and rel <= BF16_REL_L2


@pytest.mark.parametrize("name", MODELS)
def test_forward_bf16_is_as_close_to_f32_as_the_jax_one(models, name):
    """The whole model in bf16 against the reference's f32 run of the same
    weights: the port's error is at most the reference's own bf16 error
    (× 1.1). At 6–8 blocks the two packages' bf16 logits sit 0.09–0.13
    apart (relative L2 1.9–2.3%), each as far from the f32 model: the
    rounding floor, past the 2-layer bounds above."""
    rc, pc = _configs(name, "bfloat16")
    rp, pp = models(name, "bfloat16")
    rc32 = dataclasses.replace(rc, dtype="float32")
    toks = jnp.asarray(np.random.default_rng(2).integers(
        0, rc.vocab, size=(2, 24)), jnp.int32)
    f32 = RT.forward(jax.tree.map(lambda a: a.astype(jnp.float32), rp),
                     rc32, toks)[0]
    ref = RT.forward(rp, rc, toks)[0]
    got = PT.forward(pp, pc, torch.from_numpy(np.array(toks)))[0]
    assert got.dtype == torch.bfloat16
    for port_gap, ref_gap in zip(_bf16_gap(got, f32), _bf16_gap(ref, f32)):
        assert port_gap <= 1.1 * ref_gap


@pytest.mark.parametrize("plen", [5, 11])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_teacher_forced_decode_match_jax(models, name, impl,
                                                     plen):
    """Prefill (a prompt inside one chunk of 8 and one past it), then
    teacher-forced decode steps: logits and caches after each step."""
    rc, pc = _configs(name, impl=impl)
    rp, pp = models(name)
    rng = np.random.default_rng(plen)
    extra = 5
    toks = rng.integers(0, rc.vocab, size=(2, plen))
    forced = rng.integers(0, rc.vocab, size=(2, extra))
    want, rcache = RT.prefill(rp, rc, jnp.asarray(toks, jnp.int32),
                              cache_len=plen + extra)
    got, pcache = PT.prefill(pp, pc, torch.from_numpy(toks),
                             cache_len=plen + extra)
    assert got.shape == want.shape == (2, 1, rc.padded_vocab)
    _close(got, want)
    ref_step = jax.jit(lambda p, c, t, pos: RT.decode_step(p, rc, c, t, pos))
    for s in range(extra):
        tok = forced[:, s:s + 1]
        want, rcache = ref_step(rp, rcache, jnp.asarray(tok, jnp.int32),
                                jnp.int32(plen + s))
        got, pcache = PT.decode_step(pp, pc, pcache, torch.from_numpy(tok),
                                     plen + s)
        _close(got, want)
    want_c = dict(_leaves(rcache))
    for path, t in _leaves(pcache):
        assert tuple(t.shape) == want_c[path].shape, path
        _close(t, want_c[path])


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_teacher_forced_forward(models, name):
    """Port alone: each decode step is the forward's row at its position
    (the reference's own check for these families, at its tolerance)."""
    rc, pc = _configs(name)
    _, pp = models(name)
    seq = torch.from_numpy(np.random.default_rng(5).integers(
        0, pc.vocab, size=(2, 14)))
    full = PT.forward(pp, pc, seq)[0]
    logits, cache = PT.prefill(pp, pc, seq[:, :6], cache_len=14)
    _close(logits[:, 0], full[:, 5], atol=SSM_DECODE_ATOL, rtol=0)
    for pos in range(6, 14):
        logits, cache = PT.decode_step(pp, pc, cache, seq[:, pos:pos + 1],
                                       pos)
        _close(logits[:, 0], full[:, pos], atol=SSM_DECODE_ATOL, rtol=0)


def test_bf16_caches_keep_their_dtypes(models):
    """In a bf16 hybrid the Mamba2 state stays f32, the conv history and
    the attention K/V are bf16, through prefill and decode."""
    _, pc = _configs("zamba2-5", "bfloat16")
    _, pp = models("zamba2-5", "bfloat16")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, pc.vocab, size=(2, 7)))
    _, cache = PT.prefill(pp, pc, toks, cache_len=9)
    _, cache = PT.decode_step(pp, pc, cache, toks[:, :1], 7)
    assert cache["mamba"]["state"].dtype == torch.float32
    assert cache["mamba"]["conv"].dtype == torch.bfloat16
    assert cache["attn"]["k"].dtype == torch.bfloat16
    assert all(torch.isfinite(t.float()).all() for _, t in _leaves(cache))


# ---------------------------------------------------------------- serving
def _record(server, logs):
    api, decode = server.api, server.decode

    def prefill(*a, **k):
        logits, cache = api.prefill(*a, **k)
        logs.append(_np(logits[:, -1]))
        return logits, cache

    def step(*a):
        logits, cache = decode(*a)
        logs.append(_np(logits[:, -1]))
        return logits, cache

    server.api = dataclasses.replace(api, prefill=prefill)
    server.decode = step


@pytest.mark.parametrize("name", MODELS)
def test_batch_server_matches_jax(models, name):
    """Both packages' `BatchServer`s on the same prompts (2 slots, 3
    prompts): every step's logits within tolerance, and the same greedy
    tokens up to the first near-tie."""
    rc, pc = _configs(name)
    rp, pp = models(name)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, rc.vocab, size=10) for _ in range(3)]
    gen = 5
    ref_logs, port_logs = [], []
    ref = ref_serve.BatchServer(rc, rp, batch_slots=2)
    port = port_serve.BatchServer(pc, pp, batch_slots=2, device="cpu")
    _record(ref, ref_logs)
    _record(port, port_logs)
    want = ref.run(prompts, gen_tokens=gen)
    got = port.run(prompts, gen_tokens=gen)
    assert len(port_logs) == len(ref_logs) == 2 * gen
    for batch in range(2):
        rows = [i for i in (2 * batch, 2 * batch + 1) if i < 3]
        for step in range(gen):
            r = ref_logs[batch * gen + step][:len(rows), :rc.vocab]
            p = port_logs[batch * gen + step][:len(rows), :rc.vocab]
            _close(p, r)
            for j, i in enumerate(rows):
                assert got[i].dtype == np.int32
                assert got[i][step] == want[i][step] == r[j].argmax()
            top2 = np.sort(r, axis=-1)[:, -2:]
            if (top2[:, 1] - top2[:, 0]).min() <= 1e-3:
                break


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_serve_cli_runs_the_families_on_the_cpu(arch):
    n = flash_kernel.LAUNCHES
    outs = port_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                            "--requests", "3", "--prompt-len", "6",
                            "--gen", "3"])
    assert len(outs) == 3 and all(o.shape == (3,) for o in outs)
    assert flash_kernel.LAUNCHES == n
    assert port_api(port_config(arch, smoke=True)).decode_step \
        is PT.decode_step
