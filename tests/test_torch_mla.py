"""The port's MLA (DeepSeek-V2's latent attention, `models/attention.py`)
and the flash kernel's narrower v against the JAX package's, on the CPU.

The reference runs MLA only through its chunked path: its Pallas kernel
tiles v with q's head dim (ROADMAP Queue 3), so every case here holds the
port, under both of its ``attn_impl``s (the flash kernel's plain version
and the chunked twin), to the reference's ``xla_chunked``. Weights are the
reference's (`RT.init_params`) carried across by
`interop.params_from_arrays`; inputs are drawn with numpy from a seed.
f32 throughout, at the reference's tolerance: atol 2e-4, rtol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.kernels.flash_attn.ref import attention_ref as ref_attention
from repro.models import attention as RA
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config as port_config
from repro_torch.interop import params_from_arrays
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models import attention as PA
from repro_torch.models import transformer as PT

ARCH = "deepseek-v2-lite-16b"
IMPLS = ["pallas_flash", "xla_chunked"]
ATOL, RTOL = 2e-4, 1e-3


def _configs(impl="pallas_flash"):
    rc = dataclasses.replace(ref_config(ARCH, smoke=True), dtype="float32",
                             attn_impl="xla_chunked")
    pc = dataclasses.replace(port_config(ARCH, smoke=True), dtype="float32",
                             attn_impl=impl)
    return rc, pc


@pytest.fixture(scope="module")
def model():
    rc, pc = _configs()
    rp = RT.init_params(rc, jax.random.key(0))
    pp = params_from_arrays(pc, jax.tree.map(np.asarray, rp), device="cpu")
    return rp, pp


def _attn(model, i=0):
    rp, pp = model
    return (jax.tree.map(lambda a: a[i], rp["layers"]["attn"]),
            {k: v[i] for k, v in pp["layers"]["attn"].items()})


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def test_smoke_mla_shapes_are_the_references():
    rc, pc = _configs()
    m = pc.mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == (24, 16)
    shapes = jax.eval_shape(lambda k: RA.init_mla(k, rc, jnp.float32),
                            jax.random.key(0))
    assert PA.mla_param_shapes(pc) == {k: v.shape for k, v in shapes.items()}
    full = port_config(ARCH).mla
    assert (full.qk_nope_head_dim + full.qk_rope_head_dim,
            full.v_head_dim) == (192, 128)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("b,s", [(2, 20), (1, 7), (3, 64)])
def test_mla_full_matches_jax(model, impl, b, s):
    """Output and the latent cache (ckv, krope) of one layer."""
    rc, pc = _configs(impl)
    rp, pp = _attn(model)
    jx, tx = _x(pc, b, s, seed=b + s)
    jpos = jnp.broadcast_to(jnp.arange(s), (b, s))
    tpos = torch.arange(s).expand(b, s)
    want, wcache = RA.mla_full(rp, rc, jx, jpos)
    n = flash_kernel.LAUNCHES
    got, gcache = PA.mla_full(pp, pc, tx, tpos)
    assert flash_kernel.LAUNCHES == n  # the CPU takes the plain version
    assert got.shape == want.shape == (b, s, pc.d_model)
    _close(got, want)
    assert set(gcache) == set(wcache) == {"ckv", "krope"}
    for name in gcache:
        assert gcache[name].shape == wcache[name].shape
        _close(gcache[name], wcache[name])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("plen,cache_len", [(6, 12), (10, 10), (12, 8)])
def test_prefill_latent_cache_matches_jax(model, impl, plen, cache_len):
    """The whole model's prefill: last-position logits and the (L, b, S,
    r) / (L, b, S, rd) cache, padded past the prompt or clipped to its
    last S positions (the reference's ``fit``)."""
    rc, pc = _configs(impl)
    rp, pp = model
    toks = np.random.default_rng(plen).integers(0, rc.vocab, (2, plen))
    want, wcache = RT.prefill(rp, rc, jnp.asarray(toks, jnp.int32),
                              cache_len=cache_len)
    got, gcache = PT.prefill(pp, pc, torch.from_numpy(toks),
                             cache_len=cache_len)
    _close(got, want)
    m = pc.mla
    assert gcache["attn"]["ckv"].shape == (pc.n_layers, 2, cache_len,
                                           m.kv_lora_rank)
    assert gcache["attn"]["krope"].shape == (pc.n_layers, 2, cache_len,
                                             m.qk_rope_head_dim)
    for name in ("ckv", "krope"):
        _close(gcache["attn"][name], wcache["attn"][name])


def _latent_cache(pc, b, S, seed):
    """A filled latent cache, the same numbers for both packages."""
    rng = np.random.default_rng(seed)
    ckv = rng.standard_normal((b, S, pc.mla.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, S, pc.mla.qk_rope_head_dim)).astype(
        np.float32)
    return ({"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr)},
            {"ckv": torch.from_numpy(ckv.copy()),
             "krope": torch.from_numpy(kr.copy())})


@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["mla_decode", "mla_decode_absorbed"])
@pytest.mark.parametrize("S,positions", [(12, (0, 5, 11)),
                                         # past S: slot pos % S, and the
                                         # mask without `pos >= S`
                                         (8, (8, 13))])
def test_mla_decode_matches_jax(model, absorbed, S, positions):
    rc, pc = _configs()
    rp, pp = _attn(model, 1)
    rfn = RA.mla_decode_absorbed if absorbed else RA.mla_decode
    pfn = PA.mla_decode_absorbed if absorbed else PA.mla_decode
    rcache, pcache = _latent_cache(pc, 2, S, seed=S)
    for pos in positions:
        jx, tx = _x(pc, 2, 1, seed=pos)
        want, rcache = rfn(rp, rc, jx, rcache, jnp.int32(pos))
        got, pcache = pfn(pp, pc, tx, pcache, pos)
        assert got.shape == want.shape == (2, 1, pc.d_model)
        _close(got, want)
        for name in ("ckv", "krope"):
            _close(pcache[name], rcache[name])


def test_absorbed_decode_equals_the_expanded_one(model):
    """Absorbing ``wkv_b`` reorders the same sums: in f32 the two decodes
    agree within the reference's tolerance."""
    _, pc = _configs()
    _, pp = _attn(model)
    _, a = _latent_cache(pc, 3, 10, seed=1)
    _, b = _latent_cache(pc, 3, 10, seed=1)
    for pos in (3, 9):
        _, tx = _x(pc, 3, 1, seed=pos)
        got, a = PA.mla_decode_absorbed(pp, pc, tx, a, pos)
        want, b = PA.mla_decode(pp, pc, tx, b, pos)
        _close(got, want.numpy())
        assert torch.equal(a["ckv"], b["ckv"])


def test_decode_switch_is_the_references(model):
    """``cfg._absorbed_mla`` (set as the reference sets it) selects the
    absorbed decode in `decode_step`; both follow the reference's."""
    rp, pp = model
    for absorbed in (False, True):
        rc, pc = _configs()
        if absorbed:
            object.__setattr__(rc, "_absorbed_mla", True)
            object.__setattr__(pc, "_absorbed_mla", True)
        toks = np.random.default_rng(3).integers(0, rc.vocab, (2, 9))
        want, rcache = RT.prefill(rp, rc, jnp.asarray(toks[:, :6], jnp.int32),
                                  cache_len=9)
        got, pcache = PT.prefill(pp, pc, torch.from_numpy(toks[:, :6]),
                                 cache_len=9)
        for pos in range(6, 9):
            want, rcache = RT.decode_step(rp, rc, rcache,
                                          jnp.asarray(toks[:, pos:pos + 1],
                                                      jnp.int32),
                                          jnp.int32(pos))
            got, pcache = PT.decode_step(pp, pc, pcache,
                                         torch.from_numpy(
                                             toks[:, pos:pos + 1]), pos)
            _close(got, want)


# --------------------------------------------- the kernel's narrower v
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,d,dv", [(2, 40, 4, 24, 16), (1, 64, 2, 192, 128),
                                        (2, 33, 3, 64, 8)])
def test_flash_with_narrow_v_matches_chunked(causal, b, s, h, d, dv):
    """`ops.flash_attention` with v narrower than q and k (its plain
    version here) against both packages' `chunked_sdpa`, v handed in as
    the model hands it: a strided view of one (b, s, h, d_nope + dv)
    expansion. The scale is 1/sqrt(d)."""
    rng = np.random.default_rng(d + dv)
    q = rng.standard_normal((b, s, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kv = rng.standard_normal((b, s, h, 16 + dv)).astype(np.float32)
    tv = torch.from_numpy(kv)[..., 16:]
    assert not tv.is_contiguous()
    got = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    tv, causal=causal)
    assert got.shape == (b, s, h, 1, dv)
    want = RA.chunked_sdpa(jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(kv[..., 16:]), causal=causal)
    _close(got, want, atol=3e-5, rtol=1e-4)
    twin = PA.chunked_sdpa(torch.from_numpy(q), torch.from_numpy(k), tv,
                           causal=causal)
    _close(got, twin.numpy(), atol=3e-5, rtol=1e-4)
    # the (B, H, S, ·) plain version against the reference's
    qh = torch.from_numpy(q[:, :, :, 0]).permute(0, 2, 1, 3)
    kh = torch.from_numpy(k).permute(0, 2, 1, 3)
    vh = tv.permute(0, 2, 1, 3)
    got_bhsd = attention_ref(qh, kh, vh, causal=causal)
    want_bhsd = ref_attention(jnp.asarray(qh.numpy()), jnp.asarray(kh.numpy()),
                              jnp.asarray(vh.contiguous().numpy()),
                              causal=causal)
    assert got_bhsd.shape == (b, h, s, dv)
    _close(got_bhsd, want_bhsd, atol=2e-5, rtol=1e-2)


def test_wrapper_checks_the_narrow_v():
    q = torch.zeros(1, 4, 8, 24)
    k = torch.zeros(1, 2, 8, 24)
    out = flash_kernel.flash_attention_bhsd(q, k, torch.zeros(1, 2, 8, 16))
    assert out.shape == (1, 4, 8, 16)
    with pytest.raises(ValueError, match="one shape"):
        flash_kernel.flash_attention_bhsd(q, k, torch.zeros(1, 2, 7, 16))
    with pytest.raises(ValueError, match="one shape"):
        flash_kernel.flash_attention_bhsd(q, k, torch.zeros(1, 1, 8, 16))


@pytest.mark.parametrize("shape,dv", [((2, 5, 3, 24), 16), ((1, 4, 2, 32), 8),
                                      ((1, 1, 7, 16), 16)])
def test_output_is_laid_out_as_q(shape, dv):
    """The output follows q's dim order (q dense in the model's (b, s, h,
    d) layout gives an output dense in that layout), whatever Dv is."""
    b, h, s, d = shape
    q = torch.zeros(b, s, h, d).permute(0, 2, 1, 3)
    out = flash_kernel._out_like(q, dv)
    assert out.shape == (b, h, s, dv)
    assert out.permute(0, 2, 1, 3).is_contiguous()
    assert flash_kernel._out_like(q.contiguous(), dv).is_contiguous()
