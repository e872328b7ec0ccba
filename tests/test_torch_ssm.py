"""The port's Mamba2 block (`models/ssm.py`) against the JAX package's, on
the CPU: the chunked SSD scan, the causal conv, and the block's
full-sequence and single-token paths.

Inputs are drawn with numpy from a seed; the block's weights are the
reference's (`RT.init_params` of mamba2-130m's smoke config) carried by
`interop.params_from_arrays`. Float32 at the reference's tolerance between
its attention paths (atol 2e-4, rtol 1e-3); bf16 at the LM tests' bounds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config as port_config
from repro_torch.interop import params_from_arrays
from repro_torch.models import ssm as PS

ATOL, RTOL = 2e-4, 1e-3
BF16_ATOL, BF16_REL_L2 = 0.08, 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= BF16_ATOL
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


def _pair(a, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch,
                                                                 dtype)))


def _scan_inputs(seed, b=2, s=16, nh=4, hp=8, g=1, ds=8, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nh, hp)).astype(np.float32),
            (rng.uniform(0.1, 0.9, (b, s, nh)) * dt_scale).astype(np.float32),
            -rng.uniform(0.1, 1.0, nh).astype(np.float32),
            rng.standard_normal((b, s, g, ds)).astype(np.float32),
            rng.standard_normal((b, s, g, ds)).astype(np.float32))


# -------------------------------------------------------------- the scan
@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_ssd_chunked_matches_jax(chunk, g, h0):
    """Chunks that divide s and one that does not (5 of 16: zero-dt
    padding), one group and two (head h reads group h // (nh / g))."""
    arrs = _scan_inputs(chunk * 10 + g, g=g)
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    kw_j, kw_t = {}, {}
    if h0:
        state = np.random.default_rng(7).standard_normal(
            (2, 4, 8, 8)).astype(np.float32)
        kw_j["h0"], kw_t["h0"] = jnp.asarray(state), torch.from_numpy(state)
    want_y, want_h = RS.ssd_chunked(*j, chunk, **kw_j)
    got_y, got_h = PS.ssd_chunked(*t, chunk, **kw_t)
    assert got_y.dtype == got_h.dtype == torch.float32
    assert got_y.shape == want_y.shape and got_h.shape == want_h.shape
    _close(got_y, want_y)
    _close(got_h, want_h)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_survives_overflowing_decay(g):
    """dt·A large enough that exp(cum_i − cum_j) above the diagonal
    overflows to inf: masked by `where`, the output is finite and equal
    to the reference's (a product with the mask would give NaN)."""
    xh, dt, A, B, C = _scan_inputs(3, g=g, dt_scale=200.0)
    A = A * 10.0
    cum = np.cumsum(dt * A, axis=1)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[:, None, :16] - cum[:, :16, None])).any()
    args = (xh, dt, A, B, C)
    want_y, want_h = RS.ssd_chunked(*map(jnp.asarray, args), 16)
    got_y, got_h = PS.ssd_chunked(*map(torch.from_numpy, args), 16)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_h).all()
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_ssd_chunked_is_chunk_invariant():
    """The reference's own identity (`test_ssd_chunk_invariance`), on the
    port: the chunk size does not change the result."""
    args = [torch.from_numpy(a) for a in _scan_inputs(11, s=23, g=2)]
    y1, h1 = PS.ssd_chunked(*args, 1)
    for chunk in (4, 7, 23, 32):
        y, h = PS.ssd_chunked(*args, chunk)
        _close(y, y1, atol=1e-4, rtol=1e-4)
        _close(h, h1, atol=1e-4, rtol=1e-4)


# -------------------------------------------------------------- the conv
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,with_state", [(6, False), (6, True), (2, True),
                                          (1, True), (2, False)])
def test_causal_conv_matches_jax(s, with_state, dtype):
    """With and without history, including s < K − 1 (the new history
    then keeps part of the old)."""
    rng = np.random.default_rng(s + 10 * with_state)
    b, c, K = 2, 12, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    w = rng.standard_normal((c, K)).astype(np.float32) * 0.5
    bias = rng.standard_normal(c).astype(np.float32) * 0.1
    state = rng.standard_normal((b, K - 1, c)).astype(np.float32)
    (xj, xt), (wj, wt), (bj, bt) = (_pair(a, dtype) for a in (x, w, bias))
    sj, st = _pair(state, dtype) if with_state else (None, None)
    want, want_state = RS._causal_conv(xj, wj, bj, sj)
    got, got_state = PS._causal_conv(xt, wt, bt, st)
    assert got.dtype == got_state.dtype == getattr(torch, dtype)
    assert got_state.shape == (b, K - 1, c) and got_state.is_contiguous()
    if dtype == "float32":
        _close(got, want)
        _close(got_state, want_state, atol=0, rtol=0)  # a copy of inputs
    else:
        _close_bf16(got, want)
        assert np.array_equal(_np(got_state), _np(want_state))


# ------------------------------------------------------------- the block
def _cfgs(n_groups, dtype):
    """mamba2-130m's smoke config with ``n_groups`` (2: two B/C groups
    over its 8 heads)."""
    out = []
    for get in (ref_config, port_config):
        c = get("mamba2-130m", smoke=True)
        out.append(dataclasses.replace(c, dtype=dtype, ssm=dataclasses.replace(
            c.ssm, n_groups=n_groups)))
    return out


@pytest.fixture(scope="module")
def blocks():
    cache = {}

    def get(n_groups, dtype):
        if (n_groups, dtype) not in cache:
            rc, pc = _cfgs(n_groups, dtype)
            rp = RT.init_params(rc, jax.random.key(n_groups))
            pp = params_from_arrays(pc, jax.tree.map(np.asarray, rp),
                                    device="cpu")
            cache[n_groups, dtype] = (
                rc, pc, jax.tree.map(lambda a: a[0], rp["layers"]["mamba"]),
                {k: v[0] for k, v in pp["layers"]["mamba"].items()})
        return cache[n_groups, dtype]

    return get


def test_smoke_block_shapes_are_the_references():
    rc, pc = _cfgs(2, "float32")
    assert PS.dims(pc) == RS.dims(rc)
    shapes = jax.eval_shape(lambda k: RS.init_mamba2(k, rc, jnp.float32),
                            jax.random.key(0))
    assert PS.param_shapes(pc) == {k: v.shape for k, v in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 13])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_full_matches_jax(blocks, n_groups, s, dtype):
    """Out and both caches, one chunk (8) and a ragged two (13), with and
    without carried history."""
    rc, pc, rp, pp = blocks(n_groups, dtype)
    rng = np.random.default_rng(s)
    xj, xt = _pair(rng.standard_normal((2, s, pc.d_model)).astype(
        np.float32), dtype)
    want, wc = RS.mamba2_full(rp, rc, xj)
    got, gc = PS.mamba2_full(pp, pc, xt)
    assert got.dtype == getattr(torch, dtype)
    assert gc["state"].dtype == torch.float32
    assert gc["conv"].dtype == getattr(torch, dtype)
    # carried history: the second half of the sequence after the first
    want2, wc2 = RS.mamba2_full(rp, rc, xj, wc["conv"], wc["state"])
    got2, gc2 = PS.mamba2_full(pp, pc, xt, gc["conv"], gc["state"])
    for g_, w_ in ((got, want), (gc["state"], wc["state"]),
                   (gc["conv"], wc["conv"]), (got2, want2),
                   (gc2["state"], wc2["state"])):
        if dtype == "float32":
            _close(g_, w_)
        else:
            _close_bf16(g_, w_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_decode_matches_jax(blocks, n_groups, dtype):
    """Decode steps from a prefill's caches: out and the caches, which the
    port updates in place."""
    rc, pc, rp, pp = blocks(n_groups, dtype)
    rng = np.random.default_rng(n_groups)
    xj, xt = _pair(rng.standard_normal((2, 6, pc.d_model)).astype(
        np.float32), dtype)
    _, wc = RS.mamba2_full(rp, rc, xj)
    _, gc = PS.mamba2_full(pp, pc, xt)
    for step in range(4):
        yj, yt = _pair(rng.standard_normal((2, 1, pc.d_model)).astype(
            np.float32), dtype)
        want, wc = RS.mamba2_decode(rp, rc, yj, wc)
        state = gc["state"]
        got, gc2 = PS.mamba2_decode(pp, pc, yt, gc)
        assert gc2 is gc and gc["state"] is state  # in place
        for g_, w_ in ((got, want), (gc["state"], wc["state"]),
                       (gc["conv"], wc["conv"])):
            if dtype == "float32":
                _close(g_, w_)
            else:
                _close_bf16(g_, w_)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_decode_continues_the_scan(blocks, n_groups):
    """Port alone, f32: decoding token by token after a prefill gives the
    full-sequence block's rows (the recurrence is the scan's)."""
    _, pc, _, pp = blocks(n_groups, "float32")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 12, pc.d_model)).astype(np.float32))
    full, fc = PS.mamba2_full(pp, pc, x)
    _, cache = PS.mamba2_full(pp, pc, x[:, :5])
    for pos in range(5, 12):
        out, cache = PS.mamba2_decode(pp, pc, x[:, pos:pos + 1], cache)
        _close(out[:, 0], full[:, pos])
    _close(cache["state"], fc["state"])
    _close(cache["conv"], fc["conv"])
