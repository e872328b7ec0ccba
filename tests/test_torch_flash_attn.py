"""The port's flash attention (plain version, layout wrapper) and its
chunked twin against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages (bf16
inputs are the same f32 draws rounded to bf16 on each side, which rounds
alike). The JAX kernel runs in interpret mode, as the reference's own
tests run it. Tolerances are the reference's (`tests/test_flash_attn_kernel.py`):
atol 2e-5 in f32 and 2e-2 in bf16, rtol 1e-2; the chunked twin 3e-5 /
1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_attention_bhsd as ref_kernel
from repro.kernels.flash_attn.ops import flash_attention as ref_flash
from repro.kernels.flash_attn.ref import attention_ref as ref_attention
from repro.models import attention as RA
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn.ref import attention_ref
from repro_torch.models import attention as PA

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,bq,bk", [(128, 32, 32), (256, 64, 32),
                                     (128, 128, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_plain_matches_jax_kernel_and_ref(dtype, s, bq, bk, causal, window):
    """The reference test's own grid: (2, 4, 2, s, 32), GQA g = 2."""
    b, h, hkv, d = 2, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw([(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)], seed=s + bq),
        dtype)
    atol = DTYPES[dtype][2]
    got = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, h, s, d)
    want_kernel = ref_kernel(jq, jk, jv, causal=causal, window=window,
                             bq=bq, bk=bk, interpret=True)
    want_ref = ref_attention(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), atol=atol,
                               rtol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=atol,
                               rtol=1e-2)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    n = flash_kernel.LAUNCHES
    wrapped = flash_kernel.flash_attention_bhsd(tq, tk, tv, causal=causal,
                                                window=window)
    assert flash_kernel.LAUNCHES == n
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_noncausal_sq_ne_sk(dtype):
    """Non-causal, Sq ≠ Sk, MHA and GQA: the kernel's block grid needs
    Sq, Sk divisible by its blocks, which (64, 192) are."""
    for h, hkv in ((4, 4), (6, 2)):
        (jq, jk, jv), (tq, tk, tv) = _both(
            _draw([(1, h, 64, 16), (1, hkv, 192, 16), (1, hkv, 192, 16)],
                  seed=h), dtype)
        got = attention_ref(tq, tk, tv, causal=False)
        want = ref_kernel(jq, jk, jv, causal=False, bq=32, bk=64,
                          interpret=True)
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=DTYPES[dtype][2], rtol=1e-2)


def test_plain_single_block_noncausal():
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw([(1, 2, 64, 64), (1, 1, 64, 64), (1, 1, 64, 64)], seed=3),
        "float32")
    got = attention_ref(tq, tk, tv, causal=False)
    want = ref_kernel(jq, jk, jv, causal=False, bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=1e-4)


def test_plain_ragged_and_window_past_the_sequence():
    """Shapes the JAX kernel's blocks cannot take (S = 300) against the
    JAX oracle, and a window wider than the sequence (= causal)."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw([(2, 4, 300, 32), (2, 2, 300, 32), (2, 2, 300, 32)], seed=9),
        "float32")
    for window in (0, 64, 1000):
        np.testing.assert_allclose(
            _f32(attention_ref(tq, tk, tv, causal=True, window=window)),
            _f32(ref_attention(jq, jk, jv, causal=True, window=window)),
            atol=2e-5, rtol=1e-2)
    np.testing.assert_allclose(
        _f32(attention_ref(tq, tk, tv, causal=True, window=1000)),
        _f32(attention_ref(tq, tk, tv, causal=True)), atol=0, rtol=0)


@pytest.mark.parametrize("dtype,causal,window", [
    ("float32", True, 0), ("float32", True, 48), ("float32", False, 0),
    ("bfloat16", True, 48)])
def test_ops_layout_round_trip_matches_jax(dtype, causal, window):
    """`ops.flash_attention` takes the model's (b, s, hkv, g, hd) layout:
    head h = kv·g + gi, as `jnp.repeat` orders it."""
    b, s, hkv, g, d = 2, 128, 2, 3, 32
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw([(b, s, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)], seed=7),
        dtype)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                    bq=32, bk=32)
    want = ref_flash(jq, jk, jv, causal=causal, window=window, bq=32, bk=32,
                     interpret=True)
    assert got.shape == (b, s, hkv, g, d)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=DTYPES[dtype][2],
                               rtol=1e-2)
    # the block sizes are the JAX kernel's; this result does not read them
    other = flash_ops.flash_attention(tq, tk, tv, causal=causal,
                                      window=window, bq=128, bk=64)
    assert torch.equal(got, other)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_chunked_sdpa_matches_jax(causal, window):
    """The chunked twin with ``chunk`` forcing several q and kv blocks,
    and the one-shot `_sdpa` it falls back to."""
    b, s, hkv, g, d = 2, 128, 2, 3, 32
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw([(b, s, hkv, g, d), (b, s, hkv, d), (b, s, hkv, d)], seed=11),
        "float32")
    for chunk in (64, 1024):
        got = PA.chunked_sdpa(tq, tk, tv, causal=causal, window=window,
                              chunk=chunk)
        want = RA.chunked_sdpa(jq, jk, jv, causal=causal, window=window,
                               chunk=chunk)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-5,
                                   rtol=1e-4)
    # the twin and the kernel's plain version agree (the reference's test)
    flash = flash_ops.flash_attention(tq, tk, tv, causal=causal,
                                      window=window)
    np.testing.assert_allclose(
        _f32(PA.chunked_sdpa(tq, tk, tv, causal=causal, window=window,
                             chunk=64)), _f32(flash), atol=3e-5, rtol=1e-4)


def test_sdpa_and_mask_match_jax():
    b, sq, sk, hkv, g, d = 2, 5, 9, 2, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _both(
        _draw([(b, sq, hkv, g, d), (b, sk, hkv, d), (b, sk, hkv, d)],
              seed=5), "float32")
    for offset, window in ((0, 0), (4, 0), (4, 3)):
        jm = RA._causal_mask(sq, sk, offset, window)
        tm = PA._causal_mask(sq, sk, offset, window)
        assert np.array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_allclose(_f32(PA._sdpa(tq, tk, tv, tm)),
                                   _f32(RA._sdpa(jq, jk, jv, jm)),
                                   atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v: (q.double(), k.double(), v.double()), "dtype"),
    (lambda q, k, v: (q, k[:, :1].expand(-1, 3, -1, -1), v[:, :1].expand(
        -1, 3, -1, -1)), "multiple"),
    (lambda q, k, v: (q[0], k, v), r"\(B, H, Sq, D\)"),
    (lambda q, k, v: (q, k, v[:, :, :4]), "one shape"),
    (lambda q, k, v: (q, k.to(torch.bfloat16), v), "dtype"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    q, k, v = (torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16),
               torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match=match):
        flash_kernel.flash_attention_bhsd(*bad(q, k, v))
    with pytest.raises(ValueError, match="window"):
        flash_kernel.flash_attention_bhsd(q, k, v, window=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_ops_strided_views_match_the_copy_path(dtype, causal, window):
    """`ops.flash_attention` hands the kernel permuted views of the
    model's (b, s, hkv, g, hd) tensors, and views cut from one fused qkv
    row; the result equals the permute-and-copy path (contiguous
    (B, H, S, D) copies in, the output permuted back), here on the plain
    version."""
    b, s, hkv, g, d = 2, 96, 2, 3, 32
    _, (q, k, v) = _both(_draw([(b, s, hkv, g, d), (b, s, hkv, d),
                                (b, s, hkv, d)], seed=21), dtype)
    want = flash_kernel.flash_attention_bhsd(
        q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, s, d).contiguous(),
        k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous(),
        causal=causal, window=window)
    want = want.reshape(b, hkv, g, s, d).permute(0, 3, 1, 2, 4)
    fused = torch.cat([q.reshape(b, s, -1), k.reshape(b, s, -1),
                       v.reshape(b, s, -1)], dim=-1)
    nq, nk = hkv * g * d, hkv * d
    views = (fused[..., :nq].view(b, s, hkv, g, d),
             fused[..., nq:nq + nk].view(b, s, hkv, d),
             fused[..., nq + nk:].view(b, s, hkv, d))
    for args in ((q, k, v), views):
        got = flash_ops.flash_attention(*args, causal=causal, window=window)
        assert got.shape == (b, s, hkv, g, d) and got.dtype == q.dtype
        assert torch.equal(got, want)


# The bf16 cases of the card's tests (`tests/test_torch_cuda.py`), the
# first at B = 1 to keep its scores small here
BF16_CARD_CASES = [
    (1, 16, 2, 1024, 1024, 128, True, 0),
    (1, 32, 8, 600, 600, 80, True, 256),
    (2, 12, 12, 256, 1536, 64, False, 0),
    (1, 4, 2, 77, 130, 8, False, 0),
    (1, 4, 2, 130, 77, 24, True, 0),
    (2, 6, 3, 200, 200, 40, True, 1),
    (1, 8, 1, 333, 333, 64, True, 1000),
    (1, 8, 2, 150, 90, 80, False, 0),
    (1, 4, 4, 90, 150, 96, True, 0),
    (1, 4, 1, 257, 257, 128, True, 100),
    (1, 2, 1, 100, 121, 136, False, 0),
    (1, 2, 2, 300, 300, 256, True, 0),
    (1, 2, 1, 200, 330, 256, False, 0),
    (1, 4, 2, 100, 40, 64, True, 16),
]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", BF16_CARD_CASES)
def test_bf16_probabilities_stay_inside_the_tolerance(B, H, Hkv, Sq, Sk, D,
                                                      causal, window):
    """The tensor-core kernel's one rounding that the plain version lacks:
    P enters P·V as bf16 (the f32 accumulator and the row sum take the
    unrounded p). The plain version with that rounding, in f32 on the
    bf16-rounded inputs, stays within a quarter of the reference's bf16
    budget (atol 2e-2 + rtol 1e-2 · |want|) of the plain version."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float() for a in _draw(
        [(B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)], seed=Sq + D))
    want = attention_ref(q, k, v, causal=causal, window=window)
    g = H // Hkv
    kr, vr = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr) / D ** 0.5
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    rounded = p.to(torch.bfloat16).float()
    got = torch.einsum("bhqk,bhkd->bhqd", rounded, vr) \
        / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    budget = 2e-2 + 1e-2 * want.abs()
    assert float(((got - want).abs() / budget).max()) <= 0.25
