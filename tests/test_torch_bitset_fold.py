"""The port's resident merge-round kernels and device programs against the
JAX package's.

Inputs are made with numpy from fixed seeds and handed to both packages;
every result is an integer and is compared exactly. On the CPU the port's
wrappers run their plain PyTorch versions (`kernels/bitset_fold/ref.py`);
the Pallas kernels run in interpret mode. `tests/test_torch_cuda.py` holds
the CUDA kernels against the plain versions on a card.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.merging import theta_to_p
from repro.core.minhash import (host_shingle_provider as ref_host_provider,
                                u32_seed_consts)
from repro.graphs import generators as RG
from repro.kernels.bitset_fold import carry as ref_carry
from repro.kernels.bitset_fold import ref as jref
from repro.kernels.bitset_fold.kernel import (bitset_fold_kernel,
                                              jaccard_topj_kernel)
from repro_torch.core import merging as port_merging
from repro_torch.core.minhash import host_shingle_provider
from repro_torch.graphs import generators as PG
from repro_torch.kernels.bitset_fold import carry, kernel, ref, rounds


def _bits(shape, seed, density=0.3):
    rng = np.random.default_rng(seed)
    words = np.zeros(shape, dtype=np.uint32)
    for bit in range(32):
        on = rng.random(shape) < density
        words |= on.astype(np.uint32) << np.uint32(bit)
    return words


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def _t32(words):
    return _t(words.view(np.int32))


# ------------------------------------------------------------------ top-J
TOPJ_CASES = [
    # (B, G, W, J, block_w, dead)
    (3, 2, 3, 1, 512, "none"),
    (4, 8, 6, 7, 4, "some"),        # W not a multiple of block_w
    (2, 16, 5, 16 - 1, 2, "rows"),
    (3, 32, 9, 16, 4, "group"),     # one all-dead group
    (2, 128, 4, 16, 3, "some"),
]


def _alive(B, G, dead, seed):
    rng = np.random.default_rng(seed)
    alive = np.ones((B, G), dtype=np.int8)
    if dead in ("some", "rows", "group"):
        alive[rng.random((B, G)) < 0.25] = 0
    if dead == "group":
        alive[1] = 0
    return alive


@pytest.mark.parametrize("B,G,W,J,block_w,dead", TOPJ_CASES)
def test_plain_topj_matches_pallas(B, G, W, J, block_w, dead):
    words = _bits((B, G, W), seed=G * 7 + W)
    words[:, :, 0] |= np.uint32(1 << 31)  # bit-31 columns everywhere
    words[0, 1] = 0xFFFFFFFF
    alive = _alive(B, G, dead, seed=G)
    got = kernel.jaccard_topj(_t32(words), _t(alive), J).numpy()
    assert got.dtype == np.int32 and got.shape == (B, G, J)
    for b in range(B):
        want = np.asarray(jaccard_topj_kernel(
            jnp.asarray(words[b]), jnp.asarray(alive[b][:, None]), J,
            block_w=block_w, interpret=True))
        np.testing.assert_array_equal(got[b], want)
    want_all = np.asarray(jref.topj_all(jnp.asarray(words),
                                        jnp.asarray(alive), J))
    np.testing.assert_array_equal(got, want_all)


def test_topj_orders_like_the_host_sweep():
    """The ranked prefix equals the host rank source's stable argsort of
    the quantized keys (dead/self last)."""
    B, G, W = 3, 16, 4
    words = _bits((B, G, W), seed=3, density=0.5)
    alive = _alive(B, G, "some", seed=4)
    got = kernel.jaccard_topj(_t32(words), _t(alive), 9).numpy()

    class _WS:
        bits = words.view(np.uint64)
    _WS.alive = alive.astype(bool)
    rb, rr = np.nonzero(np.ones((B, G), dtype=bool))
    want = port_merging.HostRankSource().ranked(_WS, rb, rr, 9)
    np.testing.assert_array_equal(got.reshape(-1, 9), want)


def test_rank_keys_and_bit_length_match_reference():
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 1 << 20, size=(2, 500)).astype(np.int32)
    inter = np.minimum(deg[0], deg[1]) * rng.random(500)
    inter = inter.astype(np.int32)
    v = np.concatenate([[0, 1, 2, 3, (1 << 31) - 1],
                        rng.integers(0, 1 << 31, 200)]).astype(np.int32)
    np.testing.assert_array_equal(ref.bit_length(_t(v)).numpy(),
                                  np.asarray(jref.bit_length(jnp.asarray(v))))
    got = ref.rank_keys(_t(inter), _t(deg[0]), _t(deg[1])).numpy()
    want = np.asarray(jref.rank_keys(jnp.asarray(inter), jnp.asarray(deg[0]),
                                     jnp.asarray(deg[1])))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- fold
def _fold_instr(B, G, W, P, seed, share_word):
    """Disjoint row pairs per group, member columns drawn so pairs share
    32-bit words and hit bit 31; the last row of each group is padding."""
    rng = np.random.default_rng(seed)
    instr = np.zeros((B, P, 8), dtype=np.int32)
    for b in range(B):
        rows = rng.permutation(G)
        cols = rng.permutation(W * 32)[: 2 * P]
        if share_word:
            cols[: 4] = [31, 30, 63 if W > 1 else 29, 0]
        for p in range(P):
            ca, cz = int(cols[2 * p]), int(cols[2 * p + 1])
            instr[b, p] = [rows[2 * p], rows[2 * p + 1], ca >> 5, ca & 31,
                           cz >> 5, cz & 31, 1, 0]
        instr[b, P - 1, 6] = 0  # a padding row does nothing
    return instr


FOLD_CASES = [(2, 8, 2, 4, True), (3, 16, 5, 8, True), (2, 128, 5, 64, False),
              (4, 32, 1, 8, True)]


@pytest.mark.parametrize("B,G,W,P,share_word", FOLD_CASES)
def test_plain_fold_matches_pallas(B, G, W, P, share_word):
    words = _bits((B, G, W), seed=B * G + W, density=0.5)
    alive = _alive(B, G, "none", seed=1)
    instr = _fold_instr(B, G, W, P, seed=G, share_word=share_word)
    bits_t, alive_t = _t32(words.copy()), _t(alive.copy())
    kernel.bitset_fold(bits_t, alive_t, _t(instr))
    got_bits = bits_t.numpy().view(np.uint32)
    for b in range(B):
        wb, wa = bitset_fold_kernel(jnp.asarray(words[b]),
                                    jnp.asarray(alive[b][:, None]),
                                    jnp.asarray(instr[b]), interpret=True)
        np.testing.assert_array_equal(got_bits[b], np.asarray(wb))
        np.testing.assert_array_equal(alive_t.numpy()[b],
                                      np.asarray(wa)[:, 0])
        rb, ra = jref.fold_pairs(jnp.asarray(words[b]),
                                 jnp.asarray(alive[b].astype(np.int32)),
                                 jnp.asarray(instr[b]))
        np.testing.assert_array_equal(got_bits[b], np.asarray(rb))


def test_wrappers_reject_what_the_kernels_do_not_take():
    bits = torch.zeros((2, 8, 3), dtype=torch.int32)
    alive = torch.ones((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="J="):
        kernel.jaccard_topj(bits, alive, 8)
    with pytest.raises(ValueError, match="alive"):
        kernel.jaccard_topj(bits, alive.to(torch.int32), 3)
    with pytest.raises(ValueError, match="group width"):
        kernel.jaccard_topj(torch.zeros((1, 129, 1), dtype=torch.int32),
                            torch.ones((1, 129), dtype=torch.int8), 3)
    with pytest.raises(ValueError, match="instr"):
        kernel.bitset_fold(bits, alive, torch.zeros((2, 1, 7),
                                                    dtype=torch.int32))


def test_cpu_tensors_launch_no_kernel():
    before = (kernel.TOPJ_LAUNCHES, kernel.FOLD_LAUNCHES)
    words = _bits((2, 8, 2), seed=0)
    bits, alive = _t32(words), torch.ones((2, 8), dtype=torch.int8)
    kernel.jaccard_topj(bits, alive, 3)
    kernel.bitset_fold(bits, alive, _t(_fold_instr(2, 8, 2, 2, 0, False)))
    assert (kernel.TOPJ_LAUNCHES, kernel.FOLD_LAUNCHES) == before


# ------------------------------------------------- exact integer Saving / θ̂
C = rounds.C_CLAMP
_int31 = st.one_of(st.integers(0, (1 << 31) - 1),
                   st.sampled_from([0, 1, 2, C - 1, C, C + 1, (1 << 31) - 1]))


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(_int31, _int31, _int31, _int31), min_size=64,
                max_size=64))
def test_int64_prod_lt_equals_limbs(quads):
    a, b, c, d = (np.array(col, dtype=np.int64).astype(np.int32)
                  for col in zip(*quads))
    got = rounds.prod_lt(_t(a), _t(b), _t(c), _t(d)).numpy()
    want = np.asarray(jref.prod_lt(*(jnp.asarray(x) for x in (a, b, c, d))))
    np.testing.assert_array_equal(got, want)


_denom = st.one_of(st.integers(1, C),
                   st.sampled_from([1, 2, C - 2, C - 1, C]))


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(st.integers(0, C), _denom), min_size=64,
                max_size=64),
       st.sampled_from([0, 1, 1 << 19, (1 << 20) - 1, 1 << 20]))
def test_int64_theta_accept_equals_limbs(pairs, theta_p):
    numer, denom = (np.array(col, dtype=np.int64) for col in zip(*pairs))
    numer = np.minimum(numer, denom + 1).astype(np.int32)
    denom = denom.astype(np.int32)
    got = rounds.theta_accept(_t(numer), _t(denom), theta_p).numpy()
    want = np.asarray(jref.theta_accept(jnp.asarray(numer),
                                        jnp.asarray(denom),
                                        jnp.uint32(theta_p)))
    np.testing.assert_array_equal(got, want)


def test_theta_p_range_covers_both_ends():
    assert theta_to_p(0.0) == 0 and theta_to_p(1.0) == 1 << 20
    assert rounds.THETA_SHIFT == jref.THETA_SHIFT
    assert rounds.C_CLAMP == jref.C_CLAMP == port_merging.C_CLAMP


def test_clamped_pair_costs_match_reference():
    v = np.array([0, 1, 2, 3, 46340, 46341, 46342, 1 << 15, C - 1, C],
                 dtype=np.int32)
    a, b = np.meshgrid(v, v)
    for got, want in (
            (rounds.poss_pair_c(_t(a), _t(b)),
             jref.poss_pair_c(jnp.asarray(a), jnp.asarray(b))),
            (rounds.poss_self_c(_t(v)), jref.poss_self_c(jnp.asarray(v)))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _round_state(B, G, R, seed):
    """A consistent random count state: symmetric member counts, positive
    sizes, costs from the clamped terms (as the arena builds them)."""
    rng = np.random.default_rng(seed)
    alive = (rng.random((B, G)) < 0.85).astype(np.int8)
    memcol = np.stack([rng.permutation(R)[:G] for _ in range(B)])
    CNT = rng.integers(0, 4, size=(B, G, R)) * (rng.random((B, G, R)) < 0.3)
    CNT[np.arange(B)[:, None], np.arange(G)[None, :], memcol] = 0
    CNT = (CNT * alive[:, :, None]).astype(np.int32)
    s = rng.integers(1, 5, size=(B, G)).astype(np.int32)
    colsize = rng.integers(1, 6, size=(B, R)).astype(np.int32)
    colsize[np.arange(B)[:, None], memcol] = s
    selfc = rng.integers(0, 3, size=(B, G)).astype(np.int32)
    nd = (2 * (s - 1)).astype(np.int32)
    hgt = rng.integers(0, 3, size=(B, G)).astype(np.int32)
    cost = np.asarray(jref.pair_cost_c(
        jnp.asarray(CNT), jref.poss_pair_c(jnp.asarray(s)[:, :, None],
                                           jnp.asarray(colsize)[:, None, :])
    ).sum(axis=-1)) + np.asarray(jref.pair_cost_c(
        jnp.asarray(selfc), jref.poss_self_c(jnp.asarray(s)))) + nd
    cost = (cost * (alive > 0)).astype(np.int32)
    bits = _bits((B, G, max(1, (R + 31) // 32)), seed=seed)
    dirty = alive.copy()
    dirty[rng.random((B, G)) < 0.2] = 0
    return dict(bits=bits.view(np.int32), alive=alive, dirty=dirty, CNT=CNT,
                colsize=colsize, memcol=memcol.astype(np.int32), s=s,
                selfc=selfc, nd=nd, hgt=hgt, cost=cost)


_ORDER = ("alive", "dirty", "CNT", "colsize", "memcol", "s", "selfc", "nd",
          "hgt", "cost")


@pytest.mark.parametrize("height_bound", [None, 2])
@pytest.mark.parametrize("B,G,R,J", [(3, 8, 20, 7), (2, 16, 40, 12)])
def test_round_from_ranked_matches_reference(B, G, R, J, height_bound):
    stt = _round_state(B, G, R, seed=G + R)
    rb, rr = np.nonzero(stt["dirty"] > 0)
    rows = np.stack([rb, rr], 1)
    cand = np.asarray(jref.topj_all(jnp.asarray(stt["bits"].view(np.uint32)),
                                    jnp.asarray(stt["alive"]), J))[rb, rr]
    port_state = {k: _t(v) for k, v in stt.items()}
    has, numer, denom, z = rounds.round_from_ranked(
        port_state, _t(rows), _t(cand), J, height_bound)
    want = np.asarray(jref.round_from_ranked(
        *(jnp.asarray(stt[k]) for k in _ORDER),
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(cand), J,
        height_bound))
    assert want[:, 0].any()
    np.testing.assert_array_equal(has.numpy(), want[:, 0] > 0)
    for got, col in ((numer, 1), (denom, 2), (z, 3)):
        np.testing.assert_array_equal(got.numpy(), want[:, col])


@pytest.mark.parametrize("B,G,R", [(3, 8, 20), (2, 16, 70)])
def test_fold_counts_matches_reference(B, G, R):
    stt = _round_state(B, G, R, seed=B + G)
    rng = np.random.default_rng(R)
    P = G // 2
    ref_instr = np.zeros((B, P, 3), dtype=np.int32)
    bs, As, Zs = [], [], []
    for b in range(B):
        live = np.flatnonzero(stt["alive"][b])
        perm = rng.permutation(live)
        npairs = min(len(perm) // 2, P - 1)
        for p in range(npairs):
            ref_instr[b, p] = [perm[2 * p], perm[2 * p + 1], 1]
            bs.append(b), As.append(perm[2 * p]), Zs.append(perm[2 * p + 1])
    port_state = {k: _t(v.copy()) for k, v in stt.items()}
    rounds.fold_counts(port_state, *(torch.tensor(x, dtype=torch.int64)
                                     for x in (bs, As, Zs)))
    for b in range(B):
        out = jref.fold_pairs_counts(
            *(jnp.asarray(stt[k][b]) for k in ("bits",) + _ORDER),
            jnp.asarray(ref_instr[b]), with_bits=False)
        names = ("bits", "alive", "dirty", "CNT", "colsize", "s", "selfc",
                 "nd", "hgt", "cost")
        for name, want in zip(names[1:], out[1:]):
            np.testing.assert_array_equal(port_state[name].numpy()[b],
                                          np.asarray(want), err_msg=name)


# ------------------------------------------------------ hash and shingles
def test_hash_u32_matches_reference():
    x = np.concatenate([np.arange(4096), [2**32 - 1, 2**31, 2**31 - 1]])
    x = x.astype(np.uint32)
    for seed in (0, 1, 7, 123456789, 2**63 - 5):
        a, b = u32_seed_consts(seed)
        want = np.asarray(ref_carry._hash_u32(jnp.asarray(x), jnp.uint32(a),
                                              jnp.uint32(b)))
        got = carry.hash_u32(_t(x.astype(np.int64)), int(a), int(b)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_shingles_match_reference_and_host_provider():
    gr, gp = RG.barabasi_albert(120, 3, seed=9), PG.barabasi_albert(120, 3,
                                                                   seed=9)
    cap = 2 * gp.n + 8
    res_map = np.arange(cap, dtype=np.int32)
    res_map[[0, 1, 2, 3, gp.n]] = gp.n + 1  # 0,1 → n, then n,2,3 → n + 1
    res_map[[10, 50]] = gp.n + 2             # id n is left leafless
    root_of = res_map[: gp.n].astype(np.int64)
    n_ids = gp.n + 3
    src = np.repeat(np.arange(gp.n), np.diff(gp.indptr))
    fn = ref_carry.shingle_roots_fn(gr.n, cap, src.size)
    for sub_seed in (0, 1, 42, 2**63 - 5):
        a, b = u32_seed_consts(sub_seed)
        got = carry.shingle_roots(_t(src), _t(gp.indices.astype(np.int64)),
                                  _t(res_map), gp.n, int(a), int(b), n_ids)
        got = got.numpy()
        sh, cnt = fn(jnp.asarray(src.astype(np.int32)),
                     jnp.asarray(gr.indices.astype(np.int32)),
                     jnp.asarray(res_map), jnp.uint32(a), jnp.uint32(b))
        want = np.asarray(sh).astype(np.int64)[:n_ids]
        missing = np.flatnonzero(np.asarray(cnt)[:n_ids] == 0)
        want[missing] = (1 << 32) + missing
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, host_shingle_provider(gp)(root_of)(sub_seed, n_ids))
        np.testing.assert_array_equal(
            got, ref_host_provider(gr)(root_of)(sub_seed, n_ids))
