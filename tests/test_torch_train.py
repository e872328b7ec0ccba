"""The port's single-device training (slice F7) against the JAX package's,
on the CPU: the custom backward passes, `lm_loss`, AdamW and its
schedules, int8 gradient compression, the train step on all six model
families, remat, checkpoints in both directions, the fault-tolerant loop
and the `launch.train` driver.

Both packages start from one state: the reference initialises it and
`interop.train_state_from_arrays` carries it across. Batches come from
each package's `make_batch` (equal bit for bit, `tests/test_torch_vlm.py`).
The reference's step is its `build_train_step` on a one-device host mesh
(its sharded path fails on this jax, ROADMAP Queue 3 item 2). Losses,
gradient norms and gradients are held to atol 2e-4 / rtol 1e-3, the
reference's tolerance between its two attention paths.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig
from repro.configs.registry import get_config as ref_config
from repro.data import pipeline as RP
from repro.launch.mesh import dp_axes_of, make_host_mesh
from repro.models import layers as RL
from repro.models.api import get_api as ref_api
from repro.models.api import lm_loss as ref_lm_loss
from repro.optim import adamw as RA
from repro.optim import grad_compression as RG
from repro.optim import schedules as RS
from repro.train import checkpoint as RCK
from repro.train.train_step import TrainPlan as RefPlan
from repro.train.train_step import build_train_step as ref_build
from repro_torch.configs.registry import get_config as port_config
from repro_torch.data import pipeline as PP
from repro_torch.interop import train_state_from_arrays
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.launch import train as port_train
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.api import lm_loss as port_lm_loss
from repro_torch.optim import adamw as PA
from repro_torch.optim import grad_compression as PG
from repro_torch.optim import schedules as PS
from repro_torch.train import checkpoint as PCK
from repro_torch.train import train_step as PTS
from repro_torch.train.fault_tolerance import (FaultToleranceConfig,
                                               ResilientLoop, StragglerWatch)

ATOL, RTOL = 2e-4, 1e-3
FAMILIES = ["qwen2.5-3b", "internvl2-26b", "mamba2-130m",
            "deepseek-v2-lite-16b", "zamba2-7b", "whisper-small"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _configs(arch, dtype="float32", **kw):
    """(reference config, port config): the smoke model, both attending
    through the chunked twin (the reference's default, the port's train
    path)."""
    rc = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype,
                             attn_impl="xla_chunked", **kw)
    pc = dataclasses.replace(port_config(arch, smoke=True), dtype=dtype,
                             attn_impl="xla_chunked", **kw)
    return rc, pc


def _state(rc, pc, moment_dtype="float32", seed=0):
    """(reference state, port state) from one reference init."""
    params = ref_api(rc).init_params(rc, jax.random.key(seed))
    rstate = {"params": params, "opt": RA.init_state(params, moment_dtype)}
    pstate = train_state_from_arrays(pc, jax.tree.map(np.asarray, rstate),
                                     device="cpu")
    return rstate, pstate


def _batches(rc, pc, b, s, step, seed=0):
    return (RP.make_batch(rc, RP.TokenStream(rc.vocab, b, s, seed), step),
            PP.make_batch(pc, PP.TokenStream(pc.vocab, b, s, seed), step,
                          device="cpu"))


# ------------------------------------------------------ custom backward
def _vjp_inputs(dtype, shape=(2, 5, 16), e=24):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    w = 1 + 0.1 * rng.standard_normal(shape[-1]).astype(np.float32)
    wm = rng.standard_normal((shape[-1], e)).astype(np.float32) * 0.3
    dy = rng.standard_normal(shape).astype(np.float32)
    dz = rng.standard_normal((*shape[:-1], e)).astype(np.float32)
    return x, w, wm, dy, dz


# bf16: both packages round the same elementwise steps to bf16, but XLA
# may keep a fused intermediate in f32 where torch rounds it, so an entry
# can differ by one bf16 ulp (2^-7 relative) of its magnitude
BF16_TOL = dict(atol=2e-2, rtol=2 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_backward_matches_jax_vjp(dtype):
    x, w, _, dy, _ = _vjp_inputs(dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, b: RL.rms_norm(a, b, 1e-6),
                       jnp.asarray(x, jd), jnp.asarray(w, jd))
    want_dx, want_dw = vjp(jnp.asarray(dy, jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    wt = torch.from_numpy(w).to(td).requires_grad_()
    got = PL.rms_norm(xt, wt, 1e-6)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(dy).to(td))
    assert dx.dtype == dw.dtype == td
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16_TOL
    _close(got, out, **tol)
    _close(dx, want_dx, **tol)
    # dw sums over 10 rows in f32 before its one rounding
    _close(dw, want_dw, **(tol if dtype == "float32"
                           else dict(atol=2e-2, rtol=2 ** -7)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lowp_matmul_backward_matches_jax_vjp(dtype):
    """x in the model's dtype, w the f32 router: dx in x's dtype, dw
    accumulated in f32."""
    x, _, wm, _, dz = _vjp_inputs(dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(RL.lowp_matmul_f32, jnp.asarray(x, jd),
                       jnp.asarray(wm))
    want_dx, want_dw = vjp(jnp.asarray(dz))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    wt = torch.from_numpy(wm).requires_grad_()
    got = PL.lowp_matmul_f32(xt, wt)
    assert got.dtype == torch.float32
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(dz))
    assert dx.dtype == td and dw.dtype == torch.float32
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16_TOL
    _close(got, out, atol=1e-5, rtol=1e-5)  # bf16 products exact in f32
    _close(dx, want_dx, **tol)
    _close(dw, want_dw, atol=1e-5, rtol=1e-5)


def test_custom_backwards_pass_gradcheck_in_f64():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 4, 8))).requires_grad_()
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(8)).requires_grad_()
    wm = torch.from_numpy(rng.standard_normal((8, 5))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: PL.rms_norm(a, b, 1e-6),
                                    (x, w))
    assert torch.autograd.gradcheck(PL.lowp_matmul_f32, (x, wm))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_custom_forwards_are_unchanged(dtype):
    """The autograd wrappers compute exactly the plain forward."""
    x, w, wm, _, _ = _vjp_inputs(dtype)
    td = getattr(torch, dtype)
    xt, wt = torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)
    xf = xt.float()
    inv = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / xt.shape[-1] + 1e-6)
    assert torch.equal(PL.rms_norm(xt, wt, 1e-6), xt * inv.to(td) * wt)
    wmt = torch.from_numpy(wm)
    assert torch.equal(PL.lowp_matmul_f32(xt, wmt),
                       xt.float() @ wmt.to(td).float())


def _scan(seed, dt_scale):
    rng = np.random.default_rng(seed)
    b, s, nh, hp, g, ds = 2, 32, 4, 8, 1, 8
    xh = rng.standard_normal((b, s, nh, hp)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, nh))) * dt_scale).astype(
        np.float32)
    A = -np.linspace(0.5, 2.0, nh).astype(np.float32)
    B, C = (rng.standard_normal((b, s, g, ds)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((b, s, nh, hp)).astype(np.float32)
    return (xh, dt, A, B, C), w


@pytest.mark.parametrize("dt_scale", [0.05, 20.0])
def test_ssd_scan_gradients_stay_finite_where_the_decay_overflows(dt_scale):
    """Where a chunk's decay exp(cum_i − cum_j) above the diagonal
    overflows (``dt_scale`` 20 here; mamba2-130m at its chunk of 256),
    the reference masks after ``exp``, and its backward meets 0·inf: NaN
    gradients (ROADMAP Queue 3). The port masks before ``exp``: the same
    output, and finite gradients equal to the reference's wherever the
    reference's are finite."""
    from repro.models import ssm as RSSM
    from repro_torch.models import ssm as PSSM

    args, w = _scan(3, dt_scale)
    ref_y = RSSM.ssd_chunked(*map(jnp.asarray, args), 16)[0]
    ref_g = jax.grad(lambda xh, dt: jnp.sum(RSSM.ssd_chunked(
        xh, dt, *map(jnp.asarray, args[2:]), 16)[0] * w), argnums=(0, 1))(
        jnp.asarray(args[0]), jnp.asarray(args[1]))
    xh, dt = (torch.from_numpy(a).requires_grad_() for a in args[:2])
    y = PSSM.ssd_chunked(xh, dt, *map(torch.from_numpy, args[2:]), 16)[0]
    got_g = torch.autograd.grad((y * torch.from_numpy(w)).sum(), (xh, dt))
    _close(y, ref_y)
    # xh's gradient does not pass through the decay's derivative
    _close(got_g[0], ref_g[0])
    # dt's does (dt feeds cum, then rel): NaN in the reference where the
    # decay overflows, and from dt on to every parameter upstream of it
    overflow = dt_scale > 1
    want = np.asarray(ref_g[1])
    assert torch.isfinite(got_g[1]).all()
    assert np.isnan(want).any() == overflow
    if not overflow:
        _close(got_g[1], want)


# ---------------------------------------------------------------- loss
def _loss_and_grads_both(rc, pc, rstate, pstate, rb, pb, **kw):
    want, rgrads = jax.value_and_grad(
        lambda p: ref_lm_loss(p, rc, rb, **kw))(rstate["params"])
    got, pgrads = PTS.loss_and_grads(pstate["params"], pc, pb) if not kw \
        else _port_grads(pstate["params"], pc, pb, **kw)
    return want, jax.tree.leaves(rgrads), got, pgrads


def _port_grads(params, cfg, batch, **kw):
    flat = PA.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss = port_lm_loss(params, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    for t in flat:
        t.requires_grad_(False)
    return loss.detach(), list(grads)


@pytest.mark.parametrize("arch,chunk,vocab_pad", [
    ("qwen2.5-3b", 32_768, 1),       # one chunk
    ("qwen2.5-3b", 16, 1),           # C = 6 of S = 30 (8, 7 do not divide)
    ("qwen2.5-3b", 32_768, 64),      # padded vocab: 320 columns for 257
    ("internvl2-26b", 16, 64),       # patches unscored
    ("qwen3-moe-235b-a22b", 32_768, 1),   # + aux
    ("deepseek-v2-lite-16b", 16, 1),      # MLA + MoE aux, chunked
    ("whisper-small", 16, 1),
    ("mamba2-130m", 32_768, 1)])
def test_lm_loss_and_grads_match_jax(arch, chunk, vocab_pad):
    rc, pc = _configs(arch, vocab_pad=vocab_pad)
    rstate, pstate = _state(rc, pc)
    rb, pb = _batches(rc, pc, 2, 30, step=1)
    want, rgrads, got, pgrads = _loss_and_grads_both(
        rc, pc, rstate, pstate, rb, pb, ce_chunk_tokens=chunk)
    _close(got, want, what="loss")
    assert len(pgrads) == len(rgrads)
    for i, (g, w) in enumerate(zip(pgrads, rgrads)):
        assert tuple(g.shape) == w.shape
        _close(g, w, what=f"grad leaf {i}")


def test_lm_loss_scores_text_positions_only():
    """A VLM's loss depends on the patches only through the text: the
    loss of patches + text equals the mean NLL recomputed from the
    forward's text rows."""
    _, pc = _configs("internvl2-26b")
    _, pstate = _state(*_configs("internvl2-26b"))
    _, pb = _batches(*_configs("internvl2-26b"), 2, 24, step=0)
    with torch.no_grad():
        loss = port_lm_loss(pstate["params"], pc, pb)
        logits = PT.forward(pstate["params"], pc, pb["tokens"][:, :-1],
                            embeds=pb["embeds"])[0][:, pc.n_patches:]
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            pb["tokens"][:, 1:].reshape(-1).long())
    _close(loss, nll, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------- optimizer
def _opt_tree(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (3, 2, 2)}, "e": (1, 9)}

    def draw(s):
        return rng.standard_normal(s).astype(np.float32)

    return jax.tree.map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_adamw_matches_jax(param_dtype, moment_dtype, clip):
    """Three steps under the warmup schedule (step 0's learning rate is 0,
    so parameters hold still while m and v move), the clip at a tiny and
    an ordinary norm, f32 and bf16 moments."""
    jd, td = getattr(jnp, param_dtype), getattr(torch, param_dtype)
    cfg = RA.AdamWConfig(lr=1e-2, grad_clip=clip, moment_dtype=moment_dtype)
    pcfg = PA.AdamWConfig(lr=1e-2, grad_clip=clip, moment_dtype=moment_dtype)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jd), _opt_tree(param_dtype, 0))
    ropt = RA.init_state(rp, moment_dtype)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(td), jax.tree.map(np.asarray, rp))
    popt = PA.init_state(pp, moment_dtype)
    before = [t.clone() for t in PA.leaves(pp)]
    for s in range(3):
        g = _opt_tree("float32", 10 + s)
        rg = jax.tree.map(lambda a: jnp.asarray(a, jd), g)
        pg = jax.tree.map(lambda a: torch.from_numpy(np.array(
            a, np.float32)).to(td), jax.tree.map(np.asarray, rg))
        scale = RS.cosine_with_warmup(ropt["step"], warmup=2, total=10)
        rp, ropt, rm = RA.apply_updates(rp, rg, ropt, cfg, scale)
        pscale = PS.cosine_with_warmup(popt["step"], warmup=2, total=10)
        pm = PA.apply_updates(pp, pg, popt, pcfg, pscale)
        _close(pm["grad_norm"], rm["grad_norm"], atol=0, rtol=1e-6)
        assert float(pm["lr"]) == float(rm["lr"])
        assert int(popt["step"]) == int(ropt["step"]) == s + 1
        tol = (dict(atol=1e-6, rtol=1e-6) if param_dtype == "float32"
               else dict(atol=0, rtol=2 ** -8))  # one bf16 rounding
        for name, mine, theirs in (("p", pp, rp), ("m", popt["m"], ropt["m"]),
                                   ("v", popt["v"], ropt["v"])):
            for a, b in zip(PA.leaves(mine), jax.tree.leaves(theirs)):
                assert a.dtype == getattr(torch, str(b.dtype))
                _close(a, b, **(tol if name == "p" or moment_dtype ==
                                "bfloat16" else dict(atol=1e-7, rtol=1e-6)),
                       what=f"step {s} {name}")
        if s == 0:
            assert float(pm["lr"]) == 0.0
            assert all(torch.equal(a, b)
                       for a, b in zip(before, PA.leaves(pp)))
            assert all(t.abs().sum() > 0 for t in PA.leaves(popt["m"]))
    assert not all(torch.equal(a, b) for a, b in zip(before, PA.leaves(pp)))


def test_adamw_failure_part_way_is_torn(monkeypatch):
    params = {"a": torch.ones(4), "b": torch.ones(3)}
    opt = PA.init_state(params)
    calls = {"n": 0}
    orig = PA._update

    def fail_second(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("card lost")
        return orig(*a)

    monkeypatch.setattr(PA, "_update", fail_second)
    with pytest.raises(PA.TornUpdate, match="card lost"):
        PA.apply_updates(params, {"a": torch.ones(4), "b": torch.ones(3)},
                         opt, PA.AdamWConfig())
    assert not torch.equal(params["a"], torch.ones(4))  # written
    assert torch.equal(params["b"], torch.ones(3))      # not reached
    assert int(opt["step"]) == 0


def test_adamw_updates_large_leaves_in_slices(monkeypatch):
    """A leaf larger than `SLICE_ELEMENTS` is updated a slice of dim 0 at a
    time, with the same result (unclipped: the global norm sums a slice
    at a time, so its last bit may move with the slicing)."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    whole, sliced = {"w": p.clone()}, {"w": p.clone()}
    oa, ob = PA.init_state(whole), PA.init_state(sliced)
    cfg = PA.AdamWConfig(grad_clip=1e9)
    for _ in range(2):
        PA.apply_updates(whole, {"w": g}, oa, cfg)
    monkeypatch.setattr(PA, "SLICE_ELEMENTS", 20)
    assert len(PA._slices(sliced["w"])) == 3
    for _ in range(2):
        PA.apply_updates(sliced, {"w": g}, ob, cfg)
    assert torch.equal(whole["w"], sliced["w"])
    assert torch.equal(oa["v"]["w"], ob["v"]["w"])


def test_schedules_match_jax():
    steps = np.arange(0, 1200, 7).astype(np.int32)
    for warmup, total in ((100, 1000), (0, 10), (1, 2)):
        want = RS.cosine_with_warmup(jnp.asarray(steps), warmup=warmup,
                                     total=total)
        got = PS.cosine_with_warmup(torch.from_numpy(steps), warmup=warmup,
                                    total=total)
        _close(got, want, atol=1e-7, rtol=1e-6)
    assert float(PS.cosine_with_warmup(0, warmup=5, total=50)) == 0.0
    assert torch.equal(PS.constant(torch.arange(3)), torch.ones(3))


# ---------------------------------------------------------- compression
@pytest.mark.parametrize("n", [1, 255, 256, 5000])
def test_int8_quantization_matches_jax_bitwise(n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    x[:3] = [0.5 * 127 / 127, -2.5, 1e-30][:min(3, n)]
    q, scale, m = RG.quantize_int8(jnp.asarray(x))
    pq, pscale, pm = PG.quantize_int8(torch.from_numpy(x))
    assert m == pm == n
    assert pq.dtype == torch.int8
    assert np.array_equal(pq.numpy(), np.asarray(q))
    assert np.array_equal(pscale.numpy(), np.asarray(scale))
    back = PG.dequantize_int8(pq, pscale, pm)
    assert np.array_equal(back.numpy(), np.asarray(
        RG.dequantize_int8(q, scale, m)))
    # the reference's bound (tests/test_training_substrate.py)
    assert np.abs(back.numpy() - x).max() <= np.abs(x).max() / 127.0 + 1e-6


def test_int8_stochastic_rounding_is_bounded_and_unbiased():
    """With a generator, each value rounds to one of its two neighbours:
    the error stays within the reference's bound, and averaged over 400
    draws it is unbiased (its mean within 6 standard errors of 0: each
    draw's error is at most one quantization step)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(5000,))
                         .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = []
    for _ in range(400):
        q, scale, n = PG.quantize_int8(x, generator=gen)
        back = PG.dequantize_int8(q, scale, n)
        assert (back - x).abs().max() <= x.abs().max() / 127.0 + 1e-6
        draws.append(back - x)
    step = float(x.abs().max() / 127.0)
    mean = torch.stack(draws).mean(0)
    assert mean.abs().max() <= 6 * step / np.sqrt(400)
    det, _, _ = PG.quantize_int8(x)
    assert not torch.equal(q, det)  # it did round stochastically


def test_flatten_grads_matches_jax_order():
    tree = _opt_tree("float32", 3)
    flat, meta = RG.flatten_grads(jax.tree.map(jnp.asarray, tree))
    pflat, pmeta = PG.flatten_grads(jax.tree.map(torch.from_numpy, tree))
    assert np.array_equal(pflat.numpy(), np.asarray(flat))
    back = PG.unflatten_grads(pflat, pmeta)
    for a, b in zip(PA.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a.numpy(), b)


# ---------------------------------------------------------- the step
def _run_both(arch, steps=3, micro=None, batch=2, seq=32):
    """The reference's and the port's steps side by side from one state:
    each step's loss, grad norm, learning rate and gradients, and the
    updated parameters. Returns the largest parameter gap and the bound
    it is held to."""
    rc, pc = _configs(arch)
    mesh = make_host_mesh(1, 1)
    rplan = RefPlan(cfg=rc, mesh=mesh, dp_axes=dp_axes_of(mesh),
                    opt=RA.AdamWConfig(), microbatch=micro, warmup=1,
                    total_steps=10)
    rstep = ref_build(rplan, ShapeConfig("t", seq, batch, "train"))[0]
    pstep = PTS.build_train_step(PTS.TrainPlan(cfg=pc, microbatch=micro,
                                               warmup=1, total_steps=10))
    rstate, pstate = _state(rc, pc)
    rgrad = jax.jit(jax.grad(lambda p, b: ref_lm_loss(p, rc, b)))
    lrs, gap = [], 0.0
    for s in range(steps):
        rb, pb = _batches(rc, pc, batch, seq, step=s)
        want = jax.tree.leaves(rgrad(rstate["params"], rb))
        _, got = PTS.loss_and_grads(pstate["params"], pc, pb)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, what=f"{arch} step {s} grad leaf {i}")
        rstate, rm = rstep(rstate, rb)
        pstate, pm = pstep(pstate, pb)
        for k in ("loss", "grad_norm", "lr"):
            _close(pm[k], rm[k], what=f"{arch} step {s} {k}")
        lrs.append(float(rm["lr"]))
        gap = max(gap, max(
            float(np.abs(_np(a) - np.asarray(b, np.float32)).max())
            for a, b in zip(PA.leaves(pstate["params"]),
                            jax.tree.leaves(rstate["params"]))))
    # Adam moves an entry by at most ≈ 1.2·lr a step at these betas
    # (|m̂|/√v̂ ≤ 1.2 by Cauchy–Schwarz), whatever the gradient's size: an
    # entry whose near-zero gradient the two packages round to opposite
    # signs moves ±lr apart, so the parameters are held to 3·Σ lr (the
    # gradients above are held to the tight tolerance)
    return gap, 3 * sum(lrs)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    gap, bound = _run_both(arch)
    assert gap <= bound


def test_train_step_with_microbatches_matches_jax():
    gap, bound = _run_both("qwen2.5-3b", micro=2, batch=4)
    assert gap <= bound


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m",
                                  "deepseek-v2-lite-16b", "whisper-small",
                                  "zamba2-7b"])
def test_remat_policies_give_the_same_loss_and_grads(arch):
    rc, pc = _configs(arch)
    _, pstate = _state(rc, pc)
    _, pb = _batches(rc, pc, 2, 24, step=0)
    out = {}
    for policy in ("none", "full", "dots"):
        out[policy] = PTS.loss_and_grads(
            pstate["params"], dataclasses.replace(pc, remat=policy), pb)
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0])
        for a, b in zip(out[policy][1], out["none"][1]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        PTS.loss_and_grads(pstate["params"],
                           dataclasses.replace(pc, remat="most"), pb)


def test_remat_recomputes_the_layers_in_the_backward_pass(monkeypatch):
    """Under ``"full"`` each layer body runs twice (forward, then again in
    the backward pass); under ``"none"`` once; serving never remats."""
    rc, pc = _configs("qwen2.5-3b")
    _, pstate = _state(rc, pc)
    _, pb = _batches(rc, pc, 2, 24, step=0)
    calls = {"n": 0}
    orig = PT.attn_block_full

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(PT, "attn_block_full", counted)
    for policy, want in (("none", 1), ("full", 2)):
        calls["n"] = 0
        PTS.loss_and_grads(pstate["params"],
                           dataclasses.replace(pc, remat=policy), pb)
        assert calls["n"] == want * pc.n_layers
    calls["n"] = 0
    PT.forward(pstate["params"], pc, pb["tokens"])
    assert calls["n"] == pc.n_layers


# ------------------------------------------------------------- guards
def test_flash_kernel_refuses_inputs_that_require_grad():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="chunked"):
        flash_kernel.flash_attention_bhsd(q, k, v)
    with pytest.raises(RuntimeError, match="xla_chunked"):
        flash_kernel.flash_attention_bhsd(q.detach(), k.requires_grad_(), v)
    with torch.no_grad():
        flash_kernel.flash_attention_bhsd(q, k, v)


def test_training_through_the_flash_path_raises_not_loses_grads():
    """The port's default ``attn_impl`` is the flash kernel, which has no
    backward: a training forward through it raises; the train plan's
    config attends through the chunked twin, and every attention
    projection gets a gradient."""
    rc, pc = _configs("qwen2.5-3b")
    flash = dataclasses.replace(pc, attn_impl="pallas_flash")
    _, pstate = _state(rc, pc)
    _, pb = _batches(rc, pc, 2, 24, step=0)
    with pytest.raises(RuntimeError, match="no backward"):
        PTS.loss_and_grads(pstate["params"], flash, pb)
    cfg = PTS.train_config(flash)
    assert cfg.attn_impl == "xla_chunked"
    _, grads = PTS.loss_and_grads(pstate["params"], cfg, pb)
    tree = PA.unflatten(pstate["params"], grads)
    for name in ("wq", "wk", "wv", "wo"):
        assert tree["layers"]["attn"][name].abs().sum() > 0
    with pytest.raises(ValueError, match="attn_impl"):
        PTS.train_config(dataclasses.replace(pc, attn_impl="bogus"))


def test_train_driver_needs_the_card_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                         str(tmp_path)])
    # data and model parallelism need a world of their product
    for flag, why in (("--data-parallel", "world of 2"),
                      ("--model-parallel", "world of 2")):
        with pytest.raises(ValueError, match=why):
            port_train.main(["--smoke", "--device", "cpu", flag, "2",
                             "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------- checkpoints
def _ref_state(arch="qwen2.5-3b", dtype="bfloat16", moments="float32"):
    rc, pc = _configs(arch, dtype=dtype)
    rstate, pstate = _state(rc, pc, moments)
    # make every leaf non-trivial, the step count too
    rstate = jax.tree.map(lambda a: a + jnp.ones_like(a), rstate)
    return rc, pc, rstate, train_state_from_arrays(
        pc, jax.tree.map(np.asarray, rstate), device="cpu")


def _same(port_tree, ref_tree):
    ref_leaves = jax.tree.leaves(ref_tree)
    port_leaves = PA.leaves(port_tree)
    assert len(port_leaves) == len(ref_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == "bfloat16"
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            assert a.numpy().dtype == b.dtype
            assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoint_written_by_jax_restores_here(tmp_path, moments):
    _, _, rstate, pstate = _ref_state(moments=moments)
    RCK.save(rstate, 12, str(tmp_path))
    assert PCK.latest_step(str(tmp_path)) == 12
    like = PA.tree_map(torch.zeros_like, pstate)
    got, step = PCK.restore(like, str(tmp_path))
    assert step == 12 and int(got["opt"]["step"]) == int(rstate["opt"]["step"])
    _same(got, rstate)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoint_written_here_restores_in_jax(tmp_path, moments):
    _, _, rstate, pstate = _ref_state(moments=moments)
    PCK.save(pstate, 7, str(tmp_path))
    like = jax.tree.map(jnp.zeros_like, rstate)
    got, step = RCK.restore(like, str(tmp_path))
    assert step == 7
    _same(pstate, got)
    # the same manifest, entry for entry
    ref_dir = tmp_path / "ref"
    RCK.save(rstate, 7, str(ref_dir))
    import json
    ours = json.loads((tmp_path / "step_00000007" / "manifest.json")
                      .read_text())
    theirs = json.loads((ref_dir / "step_00000007" / "manifest.json")
                        .read_text())
    assert ours == theirs


def test_checkpoint_restore_checks_and_commits_atomically(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    PCK.save(state, 1, str(tmp_path))
    os.makedirs(tmp_path / "step_00000002.tmp")  # a crashed save
    assert PCK.latest_step(str(tmp_path)) == 1
    got, step = PCK.restore(state, str(tmp_path))
    assert step == 1 and torch.equal(got["params"]["w"], state["params"]["w"])
    assert PCK.restore(state, str(tmp_path / "none")) == (None, None)
    with pytest.raises(ValueError, match="float64"):
        PCK.restore({"params": {"w": torch.zeros(2, 3, dtype=torch.float64)},
                     "opt": state["opt"]}, str(tmp_path))
    with pytest.raises(KeyError, match="params/x"):
        PCK.restore({"params": {"x": torch.zeros(1)}}, str(tmp_path))


def test_async_checkpointer_copies_before_returning_and_keeps_two(tmp_path):
    ck = PCK.AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.zeros(4)
    for s in (10, 20, 30):
        w.fill_(s)
        ck.submit({"w": w}, s)
        w.fill_(-1)  # an in-place update right after submit
    ck.close()
    assert not ck.errors
    assert sorted(d.name for d in tmp_path.iterdir()) == [
        "step_00000020", "step_00000030"]
    for s in (20, 30):
        got, _ = PCK.restore({"w": w}, str(tmp_path), s)
        assert torch.equal(got["w"], torch.full((4,), float(s)))


# ------------------------------------------------------ resilient loop
def _mini_step(state, batch):
    return {"x": state["x"] + batch}, {"loss": state["x"]}


def test_resilient_loop_retries_transient():
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("transient device error")
        return _mini_step(state, batch)

    loop = ResilientLoop(flaky, {"x": 0}, lambda s: 1,
                         ft=FaultToleranceConfig(max_retries=2,
                                                 ckpt_every=10 ** 9))
    state, end = loop.run(0, 5)
    assert state["x"] == 5 and end == 5
    assert [f["action"] for f in loop.failures] == ["retry"]


def test_resilient_loop_restores_persistent(tmp_path):
    ck = PCK.AsyncCheckpointer(str(tmp_path))
    boom = {"armed": False}

    def step(state, batch):
        if boom["armed"] and int(state["x"]) == 6:
            raise RuntimeError("persistent")
        return {"x": state["x"] + batch}, {"loss": 0.0}

    def restore_fn():
        st, sp = PCK.restore({"x": torch.tensor(0)}, str(tmp_path))
        boom["armed"] = False  # a replacement node fixes the fault
        return st, sp

    loop = ResilientLoop(step, {"x": torch.tensor(0)}, lambda s: 1,
                         checkpointer=ck,
                         ft=FaultToleranceConfig(ckpt_every=5, max_retries=1),
                         restore_fn=restore_fn)
    state, end = loop.run(0, 5)
    ck.wait()
    boom["armed"] = True
    state, end = loop.run(5, 5)
    assert end == 10 and int(state["x"]) == 10
    assert [f["action"] for f in loop.failures] == ["retry", "retry",
                                                    "restore"]
    ck.close()


def test_straggler_watch_flags_slow_steps():
    w = StragglerWatch(factor=3.0, min_history=3)
    for i in range(5):
        w.observe(i, 0.1)
    assert w.observe(5, 1.0)
    assert w.events and w.events[0]["step"] == 5
    seen = []
    loop = ResilientLoop(_mini_step, {"x": 0}, lambda s: 1,
                         ft=FaultToleranceConfig(min_history=2,
                                                 straggler_factor=3.0),
                         on_straggler=lambda s, dt: seen.append(s))
    loop.watch.times = [1e-9] * 5  # every real step is then a straggler
    loop.run(0, 2)
    assert seen == [0, 1]


def _train_loop(tmp_path, pc, steps, fault=None, ckpt_every=2):
    """The real train step in a `ResilientLoop` with checkpoints every
    ``ckpt_every`` steps; ``fault`` wraps the step function. Returns the
    final state and the loop."""
    rc, _ = _configs("qwen2.5-3b")
    _, state = _state(rc, pc)
    stream = PP.TokenStream(pc.vocab, 2, 24)
    ck = PCK.AsyncCheckpointer(str(tmp_path))
    step = PTS.build_train_step(PTS.TrainPlan(cfg=pc, warmup=1,
                                              total_steps=steps))

    def restore_fn():
        ck.wait()
        return PCK.restore(loop.state, str(tmp_path))

    loop = ResilientLoop(
        fault(step) if fault else step, state,
        lambda s: PP.make_batch(pc, stream, s, device="cpu"),
        checkpointer=ck, ft=FaultToleranceConfig(ckpt_every=ckpt_every),
        restore_fn=restore_fn)
    try:
        state, end = loop.run(0, steps)
    finally:
        ck.close()
    assert end == steps and not ck.errors
    return state, loop


def _assert_states_equal(a, b):
    for x, y in zip(PA.leaves(a), PA.leaves(b)):
        assert torch.equal(x, y)


def test_failure_before_the_update_is_retried_in_memory(tmp_path,
                                                        monkeypatch):
    _, pc = _configs("qwen2.5-3b")
    want, _ = _train_loop(tmp_path / "clean", pc, 4)
    calls = {"n": 0}
    orig = PTS.lm_loss

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:  # step 2's loss
            raise RuntimeError("transient, before the update")
        return orig(*a, **k)

    monkeypatch.setattr(PTS, "lm_loss", flaky)
    got, loop = _train_loop(tmp_path / "flaky", pc, 4)
    assert [(f["step"], f["action"]) for f in loop.failures] == [(2, "retry")]
    _assert_states_equal(got, want)


def test_failure_during_the_update_restores_and_never_retries(tmp_path,
                                                              monkeypatch):
    """A failure part way through step 3's in-place update tears the
    state: the loop restores step 2's checkpoint (no in-memory retry) and
    replays to the uninterrupted run's state, bit for bit."""
    _, pc = _configs("qwen2.5-3b")
    want, _ = _train_loop(tmp_path / "clean", pc, 5)
    n_leaves = len(PA.leaves(want["params"]))
    calls = {"n": 0}
    orig = PA._update

    def torn(*a):
        calls["n"] += 1
        if calls["n"] == 3 * n_leaves + 5:  # step 3, its sixth leaf
            raise RuntimeError("card lost mid-update")
        return orig(*a)

    monkeypatch.setattr(PA, "_update", torn)
    got, loop = _train_loop(tmp_path / "torn", pc, 5)
    assert [(f["step"], f["action"]) for f in loop.failures] == [
        (3, "restore")]
    assert "TornUpdate" in loop.failures[0]["error"]
    _assert_states_equal(got, want)


# ------------------------------------------------------------- driver
def test_train_driver_loss_decreases(tmp_path):
    losses = port_train.main([
        "--arch", "mamba2-130m", "--smoke", "--steps", "30", "--batch", "4",
        "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1000",
        "--lr", "1e-3", "--device", "cpu"])
    assert len(losses) == 30 and losses[-1] < losses[0]


def _final(ckpt_dir, like):
    return PCK.restore(like, str(ckpt_dir))


def test_train_driver_resume_is_bit_exact(tmp_path):
    args = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4", "--seq",
            "32", "--ckpt-every", "10", "--seed", "3", "--device", "cpu"]
    full = port_train.main(args + ["--steps", "20", "--ckpt-dir",
                                   str(tmp_path / "a")])
    port_train.main(args + ["--steps", "10", "--ckpt-dir",
                            str(tmp_path / "b")])
    resumed = port_train.main(args + ["--steps", "20", "--ckpt-dir",
                                      str(tmp_path / "b"), "--resume"])
    assert resumed == full[10:]
    pc = port_config("qwen2.5-3b", smoke=True)
    like = PTS.init_state(PT.init_params(pc, device="cpu"))
    a, sa = _final(tmp_path / "a", like)
    b, sb = _final(tmp_path / "b", like)
    assert sa == sb == 20
    _assert_states_equal(a, b)


def test_train_driver_restores_after_a_persistent_failure(tmp_path,
                                                          monkeypatch):
    """`chip_smoke.py`'s check on the CPU: 8 steps, checkpoints every 4, a
    failure at step 6 on every attempt of its first pass: the loop
    restores step 4 and ends where an uninterrupted run does."""
    args = ["--arch", "mamba2-130m", "--smoke", "--steps", "8", "--batch",
            "2", "--seq", "32", "--ckpt-every", "4", "--device", "cpu"]
    full = port_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    orig = port_train.build_train_step
    left = {"n": FaultToleranceConfig().max_retries + 1}

    def faulty(plan):
        step = orig(plan)

        def wrapped(state, batch):
            if int(state["opt"]["step"]) == 6 and left["n"]:
                left["n"] -= 1
                raise RuntimeError("persistent failure at step 6")
            return step(state, batch)

        return wrapped

    monkeypatch.setattr(port_train, "build_train_step", faulty)
    got = port_train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert left["n"] == 0
    assert got[:6] == full[:6] and got[6:] == full[4:]  # 4, 5 replayed
    pc = port_config("mamba2-130m", smoke=True)
    like = PTS.init_state(PT.init_params(pc, device="cpu"))
    a, _ = _final(tmp_path / "a", like)
    b, _ = _final(tmp_path / "b", like)
    _assert_states_equal(a, b)
