"""The port's VLM prefix (slice F6) and its data pipeline against the JAX
package's, on the CPU: internvl2-26b's smoke config (``n_patches=4``),
whose patch embeddings are a prefix of the sequence.

The reference initialises the model; its weights come across through
`interop.params_from_arrays`. Patch embeddings and tokens come from both
packages' `make_batch`, which must agree bit for bit. Float32 is held to
the reference's tolerance between its two attention paths (atol 2e-4,
rtol 1e-3); under ``attn_impl="pallas_flash"`` the JAX kernel runs in
interpret mode, as in `tests/test_torch_lm.py`, whose bf16 bounds apply
here too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.data import pipeline as RP
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config as port_config
from repro_torch.data import pipeline as PP
from repro_torch.interop import params_from_arrays
from repro_torch.models import transformer as PT
from repro_torch.models.api import get_api as port_api

ARCH = "internvl2-26b"
ATOL, RTOL = 2e-4, 1e-3
BF16_ATOL, BF16_REL_L2 = 0.08, 2e-2  # tests/test_torch_lm.py's bf16 bounds


def _configs(dtype="float32", impl="pallas_flash"):
    rc = dataclasses.replace(ref_config(ARCH, smoke=True), dtype=dtype,
                             attn_impl=impl)
    pc = dataclasses.replace(port_config(ARCH, smoke=True), dtype=dtype,
                             attn_impl=impl)
    return rc, pc


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(dtype="float32"):
        if dtype not in cache:
            rc, pc = _configs(dtype)
            rp = RT.init_params(rc, jax.random.key(0))
            cache[dtype] = (rp, params_from_arrays(
                pc, jax.tree.map(np.asarray, rp), device="cpu"))
        return cache[dtype]

    return get


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _batch(cfg, rcfg, b, text, step=0, seed=0):
    """Both packages' `make_batch` on one stream of 32 tokens a row (the
    stream needs more than 16): (ref batch, port batch), the text cut to
    ``text`` tokens."""
    rb = RP.make_batch(rcfg, RP.TokenStream(rcfg.vocab, b, 32, seed), step)
    pb = PP.make_batch(cfg, PP.TokenStream(cfg.vocab, b, 32, seed), step,
                       device="cpu")
    rb["tokens"], pb["tokens"] = rb["tokens"][:, :text], pb["tokens"][:, :text]
    return rb, pb


# ------------------------------------------------------------ the family
def test_vlm_is_supported_and_unknown_families_are_not():
    pc = port_config(ARCH, smoke=True)
    assert pc.family == "vlm" and pc.n_patches == 4
    PT.check_supported(pc)
    api = port_api(pc)
    assert api.init_params(pc, device="cpu")["embed"].shape == (
        pc.padded_vocab, pc.d_model)
    with pytest.raises(NotImplementedError, match="family"):
        PT.check_supported(dataclasses.replace(pc, family="diffusion"))


# -------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, (1 << 21) + 5)])
@pytest.mark.parametrize("batch,seq", [(2, 17), (4, 32), (3, 129)])
def test_token_stream_matches_jax_bitwise(seed, step, batch, seq):
    want = RP.TokenStream(1000, batch, seq, seed).batch_np(step)
    got = PP.TokenStream(1000, batch, seq, seed).batch_np(step)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", [ARCH, "whisper-small", "qwen2.5-3b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_make_batch_matches_jax_bitwise(arch, dtype):
    """Tokens, and the N(0, 1) float64 patch embeddings or frames cast to
    the model's dtype, equal the reference's bit for bit (bf16 compared
    as 16-bit patterns)."""
    rc = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    pc = dataclasses.replace(port_config(arch, smoke=True), dtype=dtype)
    for step in (0, 5):
        want = RP.make_batch(rc, RP.TokenStream(rc.vocab, 3, 24, 2), step)
        got = PP.make_batch(pc, PP.TokenStream(pc.vocab, 3, 24, 2), step,
                            device="cpu")
        assert set(got) == set(want)
        assert np.array_equal(got["tokens"].numpy(), np.asarray(
            want["tokens"]))
        for name in set(got) - {"tokens"}:
            w = np.asarray(want[name])
            g = got[name]
            assert g.dtype == getattr(torch, dtype) and g.shape == w.shape
            if dtype == "bfloat16":
                assert np.array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16))
            else:
                assert np.array_equal(g.numpy(), w)


def test_make_batch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = port_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        PP.make_batch(pc, PP.TokenStream(pc.vocab, 2, 24), 0)


# ----------------------------------------------------------- the model
@pytest.mark.parametrize("impl", ["pallas_flash", "xla_chunked"])
def test_forward_with_patches_matches_jax(models, impl):
    rc, pc = _configs(impl=impl)
    rp, pp = models()
    rb, pb = _batch(pc, rc, 2, 16)
    want, _, rcache = RT.forward(rp, rc, rb["tokens"], embeds=rb["embeds"],
                                 return_caches=True)
    got, aux, pcache = PT.forward(pp, pc, pb["tokens"], embeds=pb["embeds"],
                                  return_caches=True)
    assert got.shape == want.shape == (2, 4 + 16, pc.padded_vocab)
    assert aux == 0.0
    _close(got, want)
    for name in ("k", "v"):
        assert pcache["attn"][name].shape[2] == 20  # patches + text
        _close(pcache["attn"][name], rcache["attn"][name])
    hidden, _ = port_api(pc).hidden(pp, pc, pb)
    assert hidden.shape == (2, 20, pc.d_model)


def test_forward_bf16_with_patches_matches_jax(models):
    rc, pc = _configs("bfloat16")
    rp, pp = models("bfloat16")
    rb, pb = _batch(pc, rc, 2, 20, step=1)
    want = _np(RT.forward(rp, rc, rb["tokens"], embeds=rb["embeds"])[0])
    got = PT.forward(pp, pc, pb["tokens"], embeds=pb["embeds"])[0]
    assert got.dtype == torch.bfloat16
    got = _np(got)
    assert np.abs(got - want).max() <= BF16_ATOL
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


@pytest.mark.parametrize("impl", ["pallas_flash", "xla_chunked"])
def test_prefill_and_decode_with_patches_match_jax(models, impl):
    """The served cache counts the patches: ``n_patches + text + gen``
    slots, decode from position ``n_patches + text``."""
    rc, pc = _configs(impl=impl)
    rp, pp = models()
    text, gen = 12, 6
    rb, pb = _batch(pc, rc, 2, text, step=2)
    forced = np.random.default_rng(3).integers(0, rc.vocab, size=(2, gen))
    cache_len = pc.n_patches + text + gen
    want, rcache = RT.prefill(rp, rc, rb["tokens"], embeds=rb["embeds"],
                              cache_len=cache_len)
    got, pcache = port_api(pc).prefill(pp, pc, pb, cache_len=cache_len)
    assert got.shape == want.shape == (2, 1, pc.padded_vocab)
    _close(got, want)
    for name in ("k", "v"):
        assert pcache["attn"][name].shape[2] == cache_len
        _close(pcache["attn"][name], rcache["attn"][name])
    ref_step = jax.jit(lambda p, c, t, pos: RT.decode_step(p, rc, c, t, pos))
    for s in range(gen):
        pos = pc.n_patches + text + s
        tok = forced[:, s:s + 1]
        want, rcache = ref_step(rp, rcache, jnp.asarray(tok, jnp.int32),
                                jnp.int32(pos))
        got, pcache = port_api(pc).decode_step(pp, pc, pcache,
                                               torch.from_numpy(tok), pos)
        _close(got, want)


def test_decode_with_patches_matches_teacher_forced_forward(models):
    """Inside the cache, every decode step is the forward's row at its
    absolute position (patches first)."""
    _, pc = _configs()
    _, pp = models()
    text, gen = 10, 6
    _, pb = _batch(pc, _configs()[0], 2, text + gen, step=4)
    seq, embeds = pb["tokens"], pb["embeds"]
    full = PT.forward(pp, pc, seq, embeds=embeds)[0]
    api = port_api(pc)
    p0 = pc.n_patches + text
    logits, cache = api.prefill(pp, pc, {"tokens": seq[:, :text],
                                         "embeds": embeds},
                                cache_len=p0 + gen)
    _close(logits[:, 0], full[:, p0 - 1])
    for g in range(gen):
        logits, cache = api.decode_step(pp, pc, cache,
                                        seq[:, text + g:text + g + 1],
                                        p0 + g)
        _close(logits[:, 0], full[:, p0 + g])


def test_a_cache_without_the_patches_wraps_the_ring(models):
    """A cache of text + generated slots only is too short by the
    patches: decode wraps the ring over keys still needed, with no error,
    and leaves the teacher-forced forward (the hazard `chip_smoke.py`'s
    cache length avoids)."""
    _, pc = _configs()
    _, pp = models()
    text, gen = 10, 4
    _, pb = _batch(pc, _configs()[0], 2, text + gen, step=6)
    seq, embeds = pb["tokens"], pb["embeds"]
    full = PT.forward(pp, pc, seq, embeds=embeds)[0]
    p0 = pc.n_patches + text
    api = port_api(pc)
    _, cache = api.prefill(pp, pc, {"tokens": seq[:, :text],
                                    "embeds": embeds}, cache_len=text + gen)
    logits, _ = api.decode_step(pp, pc, cache, seq[:, text:text + 1], p0)
    assert not np.allclose(_np(logits[:, 0]), _np(full[:, p0]), atol=ATOL,
                           rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_identity(models, dtype):
    """Patch embeddings that are the embedding table's own rows give the
    model exactly what those tokens would: ``forward(tokens,
    embeds=embed[prefix]) == forward(concat(prefix, tokens))``."""
    _, pc = _configs(dtype)
    _, pp = models(dtype)
    rng = np.random.default_rng(7)
    prefix = torch.from_numpy(rng.integers(0, pc.vocab, size=(2, 4)))
    toks = torch.from_numpy(rng.integers(0, pc.vocab, size=(2, 12)))
    got = PT.forward(pp, pc, toks, embeds=pp["embed"][prefix])[0]
    want = PT.forward(pp, pc, torch.cat([prefix, toks], dim=1))[0]
    assert torch.equal(got, want)
