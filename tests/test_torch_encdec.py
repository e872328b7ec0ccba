"""The port's encoder-decoder (`models/encdec.py`, and the cross-attention
of `models/attention.py`; slice F5) against the JAX package's, on the CPU,
at whisper-small's smoke config: 2 encoder and 2 decoder layers, d 64,
GQA 4/2 heads of 16 in self-attention, 4 cross heads.

The reference initialises the model (`jax.random`); its weights come
across through `interop.params_from_arrays`. Frames and tokens are drawn
with numpy. Float32 at the reference's tolerance between its two attention
paths (atol 2e-4, rtol 1e-3); under ``attn_impl="pallas_flash"`` the JAX
kernel runs in interpret mode, as the reference's test runs it, and the
port's flash kernel's plain version runs here. The JAX kernel takes a
call only when one block size divides both lengths (``bq = bk =
min(512, Sq, Sk)``), which a cross call of Sq = 9 over Sk = 12, or
whisper's 64 over 1,500, does not: there the port under either
``attn_impl`` is held to the reference's ``xla_chunked`` (ROADMAP
Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models import attention as RA
from repro.models import encdec as RE
from repro.models.api import get_api as ref_api
from repro_torch.configs.registry import get_config as port_config
from repro_torch.interop import params_from_arrays
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.models import attention as PA
from repro_torch.models import encdec as PE
from repro_torch.models import transformer as PT
from repro_torch.models.api import get_api as port_api

ARCH = "whisper-small"
IMPLS = ["pallas_flash", "xla_chunked"]
ATOL, RTOL = 2e-4, 1e-3
BF16_ATOL, BF16_REL_L2 = 0.08, 2e-2
ENC_LEN = 12


def _ref_impl(impl, sq, sk=ENC_LEN):
    """``impl``, or the reference's chunked path where its kernel cannot
    take a (sq, sk) cross call."""
    b = min(512, sq, sk)
    return impl if sq % b == 0 and sk % b == 0 else "xla_chunked"


def _configs(impl="pallas_flash", dtype="float32", ref_impl=None):
    """(reference config, port config); the reference on ``ref_impl``
    (default ``impl``)."""
    return tuple(dataclasses.replace(get(ARCH, smoke=True), dtype=dtype,
                                     attn_impl=i)
                 for get, i in ((ref_config, ref_impl or impl),
                                (port_config, impl)))


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(dtype="float32"):
        if dtype not in cache:
            rc, pc = _configs(dtype=dtype)
            rp = RE.init_params(rc, jax.random.key(0))
            pp = params_from_arrays(pc, jax.tree.map(np.asarray, rp),
                                    device="cpu")
            cache[dtype] = (rp, pp)
        return cache[dtype]

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


def _inputs(cfg, b, s, seed, enc_len=ENC_LEN):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, enc_len, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(b, s))
    return ((jnp.asarray(frames), jnp.asarray(toks, jnp.int32)),
            (torch.from_numpy(frames), torch.from_numpy(toks)))


def _layer(model, i=0):
    rp, pp = model
    return (jax.tree.map(lambda a: a[i], rp["layers"]),
            PT.layer(pp["layers"], i))


# ------------------------------------------------------------ weights
def test_param_tree_is_the_references(models):
    rc, pc = _configs()
    want = jax.eval_shape(lambda k: RE.init_params(rc, k), jax.random.key(0))
    assert {k: tuple(t) for k, t in _leaves(PE.param_shapes(pc))} == \
        {k: tuple(s.shape) for k, s in _leaves(want)}
    shapes = jax.eval_shape(lambda k: RA.init_cross(k, rc, jnp.float32),
                            jax.random.key(0))
    assert PA.cross_param_shapes(pc) == {k: v.shape
                                         for k, v in shapes.items()}
    assert pc.n_kv_heads < pc.n_heads  # cross K/V are n_heads wide


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_arrays_round_trips(dtype):
    rc, pc = _configs(dtype=dtype)
    tree = jax.tree.map(np.asarray, RE.init_params(rc, jax.random.key(3)))
    params = params_from_arrays(pc, tree, device="cpu")
    got = dict(_leaves(params))
    for path, a in _leaves(tree):
        t = got.pop(path)
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == a.shape
        if dtype == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.uint16).view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)
    assert not got
    with pytest.raises(ValueError, match="keys"):
        params_from_arrays(pc, {k: v for k, v in tree.items()
                                if k != "frontend"}, device="cpu")


def test_init_params_and_cache_shapes():
    rc, pc = _configs(dtype="bfloat16")
    params = port_api(pc).init_params(pc, torch.Generator().manual_seed(0),
                                      device="cpu")
    want = jax.eval_shape(lambda k: RE.init_params(rc, k), jax.random.key(0))
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in _leaves(params)} == \
        {k: (tuple(s.shape), str(s.dtype)) for k, s in _leaves(want)}
    assert (params["enc_norm"] == 1).all()
    assert (params["layers"]["lnx"] == 1).all()
    cache = port_api(pc).init_cache(pc, 3, 7, device="cpu")
    want = jax.eval_shape(lambda: ref_api(rc).init_cache(rc, 3, 7))
    assert {k: tuple(t.shape) for k, t in _leaves(cache)} == \
        {k: tuple(s.shape) for k, s in _leaves(want)}


# ---------------------------------------------------- cross-attention
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sq", [1, 4, 7])
def test_cross_attention_matches_jax(models, sq, impl):
    """`cross_precompute` and `cross_full`, one query row (decode) and a
    prompt's, non-causal over the encoder's keys. On the card the flash
    kernel takes this call; here its plain version."""
    rc, pc = _configs(impl, ref_impl=_ref_impl(impl, sq))
    lr, lp = _layer(models())
    rng = np.random.default_rng(sq)
    enc = rng.standard_normal((2, ENC_LEN, pc.d_model)).astype(np.float32)
    x = rng.standard_normal((2, sq, pc.d_model)).astype(np.float32)
    want_kv = RA.cross_precompute(lr["xattn"], rc, jnp.asarray(enc))
    got_kv = PA.cross_precompute(lp["xattn"], pc, torch.from_numpy(enc))
    for name in ("k", "v"):
        assert got_kv[name].shape == (2, ENC_LEN, pc.n_heads,
                                      pc.resolved_head_dim)
        _close(got_kv[name], want_kv[name])
    want = RA.cross_full(lr["xattn"], rc, jnp.asarray(x), want_kv)
    got = PA.cross_full(lp["xattn"], pc, torch.from_numpy(x), got_kv)
    assert got.shape == (2, sq, pc.d_model)
    _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(models, impl):
    """The encoder: frontend projection, non-causal self-attention without
    RoPE, the final norm."""
    rc, pc = _configs(impl)
    rp, pp = models()
    (fj, _), (ft, _) = _inputs(pc, 2, 4, 0)
    want = RE.encode(rp, rc, fj)
    got = PE.encode(pp, pc, ft)
    assert got.shape == (2, ENC_LEN, pc.d_model)
    _close(got, want)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("s", [12, 9])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(models, impl, s):
    rc, pc = _configs(impl, ref_impl=_ref_impl(impl, s))
    rp, pp = models()
    (fj, tj), (ft, tt) = _inputs(pc, 2, s, 1)
    want, waux, rcache = RE.forward(rp, rc, fj, tj, return_caches=True)
    n = flash_kernel.LAUNCHES
    got, aux, pcache = PE.forward(pp, pc, ft, tt, return_caches=True)
    assert flash_kernel.LAUNCHES == n  # the CPU runs the plain version
    assert got.shape == want.shape and aux == 0.0
    _close(got, want)
    for name in ("k", "v"):
        assert pcache["attn"][name].shape == rcache["attn"][name].shape
        _close(pcache["attn"][name], rcache["attn"][name])
    hidden, _, _ = PE.forward(pp, pc, ft, tt, return_hidden=True,
                              enc=PE.encode(pp, pc, ft))
    _close(hidden, RE.forward(rp, rc, fj, tj, return_hidden=True)[0])
    # through the API's batch
    got_api = port_api(pc).forward(pp, pc, {"frames": ft, "tokens": tt})[0]
    assert torch.equal(got_api, got)


def test_forward_bf16_matches_jax(models):
    rc, pc = _configs(dtype="bfloat16")
    rp, pp = models("bfloat16")
    (fj, tj), (ft, tt) = _inputs(pc, 2, 12, 2)
    want = _np(RE.forward(rp, rc, fj.astype(jnp.bfloat16), tj)[0])
    got = PE.forward(pp, pc, ft.bfloat16(), tt)[0]
    assert got.dtype == torch.bfloat16
    got = _np(got)
    assert np.abs(got - want).max() <= BF16_ATOL
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("plen,extra", [(6, 5), (4, 3), (9, 3)])
def test_prefill_and_teacher_forced_decode_match_jax(models, impl, plen,
                                                     extra):
    """Prefill (self K/V fitted to the cache, cross K/V whole), then
    teacher-forced decode steps, each attending across through
    `cross_full` at one query row: logits and every cache."""
    rc, pc = _configs(impl, ref_impl=_ref_impl(impl, plen))
    rp, pp = models()
    (fj, tj), (ft, tt) = _inputs(pc, 2, plen + extra, plen)
    cache_len = plen + extra
    want, rcache = RE.prefill(rp, rc, fj, tj[:, :plen], cache_len)
    got, pcache = PE.prefill(pp, pc, ft, tt[:, :plen], cache_len)
    assert got.shape == want.shape == (2, 1, rc.padded_vocab)
    _close(got, want)
    want_c = dict(_leaves(rcache))
    assert {k for k, _ in _leaves(pcache)} == set(want_c)
    for path, t in _leaves(pcache):
        assert tuple(t.shape) == want_c[path].shape, path
        _close(t, want_c[path])
    ref_step = jax.jit(lambda p, c, t, pos: RE.decode_step(p, rc, c, t, pos))
    for s in range(plen, plen + extra):
        want, rcache = ref_step(rp, rcache, tj[:, s:s + 1], jnp.int32(s))
        got, pcache = PE.decode_step(pp, pc, pcache, tt[:, s:s + 1], s)
        assert got.shape == want.shape == (2, 1, rc.padded_vocab)
        _close(got, want)
    want_c = dict(_leaves(rcache))
    for path, t in _leaves(pcache):
        _close(t, want_c[path])


def test_api_prefill_and_decode_match_teacher_forced_forward(models):
    """Port alone, through `get_api` as a serving loop drives it: each
    decode step is the teacher-forced forward's row at its position (the
    reference's own check, `tests/test_serving.py`, at ATOL here)."""
    _, pc = _configs()
    _, pp = models()
    api = port_api(pc)
    _, (ft, tt) = _inputs(pc, 2, 12, 5)
    full = api.forward(pp, pc, {"frames": ft, "tokens": tt})[0]
    logits, cache = api.prefill(pp, pc, {"frames": ft, "tokens": tt[:, :6]},
                                cache_len=12)
    _close(logits[:, 0], full[:, 5])
    for pos in range(6, 12):
        logits, cache = api.decode_step(pp, pc, cache, tt[:, pos:pos + 1],
                                        pos)
        _close(logits[:, 0], full[:, pos])


def test_reference_kernel_cannot_take_a_ragged_cross_call(models):
    """The reference's Pallas path refuses a cross call whose lengths no
    one block divides (Sq 9 over Sk 12 here; whisper's prompt of 64 over
    1,500 frames on the card), where the port's flash path takes it and
    equals the reference's chunked path."""
    rc, pc = _configs("pallas_flash")
    lr, lp = _layer(models())
    x = np.random.default_rng(0).standard_normal(
        (2, 9, pc.d_model)).astype(np.float32)
    enc = np.random.default_rng(1).standard_normal(
        (2, ENC_LEN, pc.d_model)).astype(np.float32)
    kv = RA.cross_precompute(lr["xattn"], rc, jnp.asarray(enc))
    with pytest.raises(AssertionError):
        RA.cross_full(lr["xattn"], rc, jnp.asarray(x), kv)
    want = RA.cross_full(lr["xattn"], dataclasses.replace(
        rc, attn_impl="xla_chunked"), jnp.asarray(x), kv)
    got = PA.cross_full(lp["xattn"], pc, torch.from_numpy(x),
                        PA.cross_precompute(lp["xattn"], pc,
                                            torch.from_numpy(enc)))
    _close(got, want)


def test_no_card_means_no_fallback(monkeypatch):
    """The encoder-decoder's entry points default to the card and raise
    without one, as the decoder-only ones do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = _configs()
    for call in (lambda: PE.init_params(pc),
                 lambda: PE.init_cache(pc, 1, 4, 6),
                 lambda: port_api(pc).init_cache(pc, 1, 4),
                 lambda: params_from_arrays(pc, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
