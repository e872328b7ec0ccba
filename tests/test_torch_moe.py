"""The port's MoE FFN (`models/moe.py`) and `layers.lowp_matmul_f32`
against the JAX package's, on the CPU.

Weights are the reference's (`RT.init_params`) carried across by
`interop.params_from_arrays`; inputs are drawn with numpy from a seed. The
routing integers (expert ids, ranks within an expert, slots, the dropped
count) must be equal exactly. The reference's `moe_ffn` keeps them
internal, so `_ref_routing` runs its own lines (`src/repro/models/moe.py`,
the router through ``slot``) in jnp on the same weights and inputs; the
outputs of the two `moe_ffn`s, which depend on every slot, are compared
too. Floats: atol 2e-4, rtol 1e-3 in f32, the reference's tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config as port_config
from repro_torch.interop import params_from_arrays
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

MOE = ["qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"]
ATOL, RTOL = 2e-4, 1e-3


def _configs(arch, dtype="float32", capacity=None):
    out = []
    for get in (ref_config, port_config):
        cfg = dataclasses.replace(get(arch, smoke=True), dtype=dtype,
                                  attn_impl="xla_chunked")
        if capacity is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def moe_params():
    """arch, dtype -> (ref layer-0 MoE params, port's), built once."""
    cache = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in cache:
            rc, pc = _configs(arch, dtype)
            tree = RT.init_params(rc, jax.random.key(0))
            pp = params_from_arrays(pc, jax.tree.map(np.asarray, tree),
                                    device="cpu")
            cache[arch, dtype] = (
                jax.tree.map(lambda a: a[0], tree["layers"]["moe"]),
                {k: v[0] for k, v in pp["layers"]["moe"].items()})
        return cache[arch, dtype]

    return get


def _x(cfg, b, s, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _ref_routing(p, cfg, x):
    """The reference's routing lines (`moe.py`, router → slot), in jnp."""
    mo = cfg.moe
    b, s, _ = x.shape
    k, e = mo.top_k, mo.n_experts
    logits = RL.lowp_matmul_f32(x, p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    cap = RM._capacity(mo, s)
    flat_e = top_e.reshape(b, s * k)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    starts = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(e)))(
        sorted_e)
    rank_sorted = jnp.arange(s * k)[None, :] - jnp.take_along_axis(
        starts, sorted_e, axis=-1)
    inv_order = jnp.argsort(order, axis=-1)
    rank = jnp.take_along_axis(rank_sorted, inv_order, axis=-1).astype(
        jnp.int32)
    keep = rank < cap
    slot = jnp.where(keep, flat_e * cap + rank, e * cap)
    return dict(probs=probs, top_p=top_p, top_e=top_e, rank=rank, slot=slot,
                cap=cap, dropped=int((~keep).sum()))


# ----------------------------------------------------------- lowp matmul
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7, 64, 4), (2, 5, 64, 128)])
def test_lowp_matmul_f32_matches_jax(dtype, shape):
    """bf16 operands, f32 accumulation, an f32 result; w (f32, as the
    router is) cast to x's dtype first."""
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape[:-1]).astype(np.float32) * 2
    w = rng.standard_normal(shape[-2:]).astype(np.float32) / 8
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = PL.lowp_matmul_f32(tx, torch.from_numpy(w))
    want = RL.lowp_matmul_f32(jx, jnp.asarray(w))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if dtype == "bfloat16":  # not the bf16-rounded product
        rounded = (tx @ torch.from_numpy(w).to(tx.dtype)).float()
        assert not torch.equal(got, rounded)


# --------------------------------------------------------------- routing
@pytest.mark.parametrize("n_tok", [1, 2, 7, 16, 100, 1024, 4096, 32768])
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("smoke", [False, True])
def test_capacity_matches_jax(arch, smoke, n_tok):
    for cf in (1.25, 0.5, 64.0):
        rc = ref_config(arch, smoke=smoke)
        mo = dataclasses.replace(rc.moe, capacity_factor=cf)
        assert PM._capacity(mo, n_tok) == RM._capacity(mo, n_tok)
    assert PM._capacity(port_config("deepseek-v2-lite-16b").moe, 1024) == 120
    assert PM._capacity(port_config("qwen3-moe-235b-a22b").moe, 1024) == 80


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity,drops", [(None, None), (0.5, True),
                                            ("n_experts", False)])
def test_routing_integers_match_jax(moe_params, arch, capacity, drops):
    """top_e, rank, slot and the dropped count equal the reference's
    exactly; a capacity factor of 0.5 forces drops, one of n_experts
    none."""
    rc, pc = _configs(arch)
    if capacity == "n_experts":
        capacity = float(rc.moe.n_experts)
    rc, pc = _configs(arch, capacity=capacity)
    rp, pp = moe_params(arch)
    for b, s, seed in ((2, 16, 0), (3, 33, 1), (1, 1, 2)):
        jx, tx = _x(pc, b, s, seed)
        want = _ref_routing(rp, rc, jx)
        got = PM.route(pp, pc, tx)
        assert got.cap == want["cap"]
        for name in ("top_e", "rank", "slot"):
            assert np.array_equal(getattr(got, name).numpy(),
                                  np.asarray(want[name])), name
        assert got.rank.dtype == torch.int32
        assert int(got.dropped) == want["dropped"]
        np.testing.assert_allclose(got.probs.numpy(),
                                   np.asarray(want["probs"]), atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_allclose(got.top_p.numpy(),
                                   np.asarray(want["top_p"]), atol=1e-6,
                                   rtol=1e-5)
    if drops is not None:
        jx, tx = _x(pc, 2, 16, 0)
        assert (int(PM.route(pp, pc, tx).dropped) > 0) == drops


@pytest.mark.parametrize("arch", MOE)
def test_routing_ties_keep_the_lower_expert_first(moe_params, arch):
    """A zero router gives every expert the same probability: the chosen
    experts are 0..k-1, in that order, as `jax.lax.top_k` gives them."""
    rc, pc = _configs(arch)
    rp, pp = moe_params(arch)
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    pp = dict(pp, router=torch.zeros_like(pp["router"]))
    jx, tx = _x(pc, 2, 9, 3)
    want = _ref_routing(rp, rc, jx)
    got = PM.route(pp, pc, tx)
    k = pc.moe.top_k
    assert np.array_equal(got.top_e.numpy(), np.asarray(want["top_e"]))
    assert (got.top_e == torch.arange(k)).all()
    assert np.array_equal(got.slot.numpy(), np.asarray(want["slot"]))
    out, aux = PM.moe_ffn(pp, pc, tx)
    rout, raux = RM.moe_ffn(rp, rc, jx)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(raux), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity", [None, 0.5, 8.0])
@pytest.mark.parametrize("b,s", [(2, 16), (3, 21), (4, 1)])
def test_moe_ffn_matches_jax(moe_params, arch, capacity, b, s):
    rc, pc = _configs(arch, capacity=capacity)
    rp, pp = moe_params(arch)
    jx, tx = _x(pc, b, s, seed=b * s)
    want, waux = RM.moe_ffn(rp, rc, jx)
    got, aux = PM.moe_ffn(pp, pc, tx)
    assert got.shape == want.shape == (b, s, pc.d_model)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(waux), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_bf16_matches_jax(moe_params, arch):
    """The layer in bf16 (the router stays f32): the two packages round
    the expert products at the same places; within the LM tests' bf16
    bounds (`tests/test_torch_lm.py`)."""
    rc, pc = _configs(arch, "bfloat16")
    rp, pp = moe_params(arch, "bfloat16")
    assert pp["router"].dtype == torch.float32
    assert pp["we_gate"].dtype == torch.bfloat16
    jx, tx = _x(pc, 2, 16, seed=7, dtype="bfloat16")
    assert np.array_equal(PM.route(pp, pc, tx).top_e.numpy(),
                          np.asarray(_ref_routing(rp, rc, jx)["top_e"]))
    got, aux = PM.moe_ffn(pp, pc, tx)
    want, waux = RM.moe_ffn(rp, rc, jx)
    assert got.dtype == torch.bfloat16
    diff = np.abs(_np(got) - _np(want))
    assert diff.max() <= 0.08
    assert np.linalg.norm(diff) <= 2e-2 * np.linalg.norm(_np(want))
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-5, rtol=1e-5)


def test_dropped_pairs_read_the_zero_row(moe_params, monkeypatch):
    """A pair past capacity contributes nothing: with capacity for k pairs
    of a 12-token row, only the shared experts and the kept pairs add up,
    and the sentinel column's duplicates never reach the output."""
    arch = "deepseek-v2-lite-16b"
    _, pc = _configs(arch, capacity=0.01)
    _, pp = moe_params(arch)
    _, tx = _x(pc, 2, 12, seed=11)
    r = PM.route(pp, pc, tx)
    k, e, cap = pc.moe.top_k, pc.moe.n_experts, r.cap
    assert cap == k and int(r.dropped) == 2 * 12 * k - int(
        (r.slot < e * cap).sum())
    out, _ = PM.moe_ffn(pp, pc, tx)
    # the same with every dropped pair's weight zeroed and full capacity
    kept = (r.slot < e * cap).view(2, 12, k)
    _, full = _configs(arch, capacity=64.0)
    rf = PM.route(pp, full, tx)
    rf = rf._replace(top_p=torch.where(kept, rf.top_p, 0.0))
    monkeypatch.setattr(PM, "route", lambda *a: rf)
    want, _ = PM.moe_ffn(pp, full, tx)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------- chip_smoke's helpers
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    return CS


def test_flash_bound_takes_the_v_width():
    """MLA's prefill call (8, 16, 16, 1024, 1024), D 192, Dv 128, bf16:
    167.8 MB over 3.35 TB/s (50.1 µs) against 43.0 GFLOP over 989
    TFLOP/s (43.5 µs); with Dv = D the bound is the one-width formula's."""
    CS = _chip_smoke()
    RL = CS.roofline()  # the rates and the pair count live in the roofline
    by_bytes, by_ops = CS.flash_bound_s(*CS.MLA_SHAPE)
    assert CS.MLA_SHAPE[:7] == (8, 16, 16, 1024, 1024, 192, 128)
    assert by_bytes * RL.HBM_BYTES_PER_S == 2 * 8 * 16 * 1024 * (2 * 192
                                                                + 2 * 128)
    assert round(by_bytes * 1e6, 1) == 50.1
    assert round(by_ops * 1e6, 1) == 43.5
    B, H, Hkv, S, D = 8, 16, 2, 1024, 128
    bb, bo = CS.flash_bound_s(B, H, Hkv, S, S, D, D, "bfloat16", True, 0)
    assert bb * RL.HBM_BYTES_PER_S == (2 * B * H * S * D
                                       + 2 * B * Hkv * S * D) * 2
    assert bo * RL.PEAK_FLOPS["bfloat16"] == 4 * D * RL.flash_pairs(
        S, S, True, 0) * B * H


def test_prefill_drops_equal_each_prefills_routing():
    """`chip_smoke.prefill_drops` reads each prefill's dropped pairs from
    the `moe.route` spans under its `serve.prefill` (the decode step's
    routing apart): equal to the routing's own counts over that prefill's
    layers, and `moe.route` left as it was."""
    from repro_torch.launch.serve import BatchServer, pad_to_slots

    CS = _chip_smoke()
    _, pc = _configs("deepseek-v2-lite-16b", capacity=0.5)
    params = PT.init_params(pc, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pc.vocab, 16) for _ in range(6)]
    server = BatchServer(pc, params, batch_slots=4, device="cpu")
    route = PM.route
    got = CS.prefill_drops(server, prompts, pc.n_layers)
    assert PM.route is route
    want = []
    for c0 in (0, 4):
        counts = []

        def counted(p, cfg, x):
            r = route(p, cfg, x)
            counts.append(int(r.dropped))
            return r

        PM.route = counted
        try:
            PT.prefill(params, pc, torch.from_numpy(np.stack(
                pad_to_slots(prompts[c0:c0 + 4], 4))))
        finally:
            PM.route = route
        assert len(counts) == pc.n_layers
        want.append(sum(counts))
    assert got == want and got[0] > 0


def test_first_layers_cuts_and_casts():
    CS = _chip_smoke()
    _, pc = _configs("deepseek-v2-lite-16b", "bfloat16")
    params = PT.init_params(pc, torch.Generator().manual_seed(0),
                            device="cpu")
    cut = CS.first_layers(params, 1)
    assert cut["embed"].dtype == torch.float32
    assert torch.equal(cut["embed"], params["embed"].float())
    for name, t in cut["layers"]["moe"].items():
        assert t.shape[0] == 1 and t.dtype == torch.float32
        assert torch.equal(t[0], params["layers"]["moe"][name][0].float())


def test_first_layers_casts_a_hybrids_shared_block_whole():
    """zamba2's f32 flash check in `chip_smoke.py` runs on its first
    layers: the stacked Mamba2 layers cut, the unstacked shared block
    (a tree, not a tensor) cast whole, and the cut model's prefill runs
    on them."""
    CS = _chip_smoke()
    _, pc = _configs("zamba2-7b", "bfloat16")
    params = PT.init_params(pc, torch.Generator().manual_seed(0),
                            device="cpu")
    cut = CS.first_layers(params, pc.attn_every)
    for name, t in cut["shared_attn"]["attn"].items():
        assert t.dtype == torch.float32
        assert torch.equal(t, params["shared_attn"]["attn"][name].float())
    assert cut["layers"]["mamba"]["in_proj"].shape[0] == pc.attn_every
    cfg = dataclasses.replace(pc, n_layers=pc.attn_every, dtype="float32")
    toks = torch.zeros((1, 8), dtype=torch.long)
    logits = CS.last_logits(cut, cfg, toks, "xla_chunked")
    assert logits.shape == (1, pc.vocab) and torch.isfinite(logits).all()


def test_routing_pin_replays_the_recorded_choices():
    """`chip_smoke.RoutingPin`: a pinned run takes each layer's recorded
    experts, ranks and slots (its weights renormalised from its own
    probabilities) and counts the choices it would have made otherwise;
    pinned to its own record a run is unchanged, with no flip."""
    CS = _chip_smoke()
    _, pc = _configs("qwen3-moe-235b-a22b")
    params = PT.init_params(pc, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, pc.vocab, (2, 12)))
    route = PM.route
    pin = CS.RoutingPin()
    with pin.record():
        want = PT.forward(params, pc, toks)[0]
    assert len(pin.recorded) == pc.n_layers and PM.route is route
    with pin.pin():
        same = PT.forward(params, pc, toks)[0]
    assert pin.flips == 0 and torch.equal(same, want)
    # other tokens route otherwise; pinned, they take the recorded choices
    other = torch.flip(toks, dims=[1])
    seen = []
    with pin.pin():
        pinned = PM.route

        def keep(*a):
            seen.append(pinned(*a))
            return seen[-1]

        PM.route = keep
        try:
            PT.forward(params, pc, other)
        finally:
            PM.route = pinned
    assert PM.route is route and pin.flips > 0
    for got, rec in zip(seen, pin.recorded):
        assert torch.equal(got.top_e, rec.top_e)
        assert torch.equal(got.slot, rec.slot)
