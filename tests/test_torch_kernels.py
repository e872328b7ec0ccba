"""The port's two kernel modules against the JAX package's Pallas kernels.

Inputs are made with numpy from fixed seeds and handed to both packages;
every result is an integer and is compared exactly. On the CPU the port's
wrappers run their plain PyTorch versions; the Pallas kernels run in
interpret mode. `tests/test_torch_cuda.py` holds the CUDA kernels against
the plain versions on a card.
"""
import inspect

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.transfer import GLOBAL as REF_TRANSFER
from repro.kernels.bitset_jaccard import ops as ref_jaccard_ops
from repro.kernels.bitset_jaccard.kernel import batch_masked_intersection_kernel
from repro.kernels.seghist import ops as ref_seghist_ops
from repro.kernels.seghist.kernel import segment_histogram_kernel
from repro_torch.core.transfer import GLOBAL as PORT_TRANSFER
from repro_torch.kernels import _build
from repro_torch.kernels.bitset_jaccard import kernel as inter_kernel
from repro_torch.kernels.bitset_jaccard import ops as port_jaccard_ops
from repro_torch.kernels.bitset_jaccard import ref as inter_ref
from repro_torch.kernels.seghist import kernel as hist_kernel
from repro_torch.kernels.seghist import ops as port_seghist_ops
from repro_torch.kernels.seghist import ref as hist_ref


def _bits(shape, seed, density=0.5):
    rng = np.random.default_rng(seed)
    words = np.zeros(shape, dtype=np.uint32)
    for bit in range(32):
        on = rng.random(shape) < density
        words |= on.astype(np.uint32) << np.uint32(bit)
    return words


def _ids(E, S, seed, pad=0.2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(S, 1), size=E).astype(np.int32)
    ids[rng.random(E) < pad] = -1
    return ids


# ---------------------------------------------------------- bitset intersections
INTER_CASES = [
    # (B, G, W, valid, all_ones)
    (4, 8, 3, 2, False),     # valid < B, W not a power of two
    (3, 8, 8, 3, True),      # all-ones words
    (2, 16, 5, 1, False),
    (2, 16, 16, 2, True),
    (2, 128, 2, 2, False),   # the widest batched group
    (5, 128, 3, 3, True),
    # the CUDA kernel's tiling edges: one row, a ragged second 32-row tile,
    # one tile short of 128; one word, a ragged 32-word chunk, W past 256;
    # no valid row, one valid row; an all-ones group (G = 1)
    (3, 1, 1, 0, False),
    (2, 1, 257, 1, True),
    (3, 33, 9, 1, True),
    (2, 33, 1, 0, True),
    (2, 127, 257, 1, False),
    (4, 127, 9, 2, True),
]


@pytest.mark.parametrize("B,G,W,valid,all_ones", INTER_CASES)
def test_plain_intersections_match_pallas(B, G, W, valid, all_ones):
    bits = _bits((B, G, W), seed=B * 1000 + G + W)
    if all_ones:
        bits[:, : max(1, G // 2), :] = 0xFFFFFFFF
    want = np.asarray(batch_masked_intersection_kernel(
        jnp.asarray(bits), jnp.asarray([valid], dtype=jnp.int32),
        interpret=True))
    got = inter_kernel.bitset_intersections(
        torch.from_numpy(bits.view(np.int32)), valid)
    assert got.dtype == torch.int32 and got.shape == (B, G, G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[valid:] == 0).all()


def test_plain_popcount_counts_every_bit():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x55555555, 0xF0F0F0F0],
                     dtype=np.uint32)
    got = inter_ref.popcount_u32(torch.from_numpy(words.view(np.int32)))
    assert got.tolist() == [bin(int(w)).count("1") for w in words]


@pytest.mark.parametrize("B,G,W", [(3, 8, 3), (70, 16, 5), (130, 8, 9)])
def test_intersection_ops_match_reference_and_ledger(B, G, W):
    """Tiling over TILE_B=64, W padded to pow2(W), valid-row masking, and
    the same h2d/d2h/round ledger entries as the JAX package's ops."""
    bits = _bits((B, G, W), seed=B + G + W, density=0.3)
    r0, p0 = REF_TRANSFER.snapshot(), PORT_TRANSFER.snapshot()
    want = ref_jaccard_ops.batched_pairwise_intersections(bits)
    got = port_jaccard_ops.batched_pairwise_intersections(bits, device="cpu")
    assert got.dtype == np.int64 == want.dtype
    np.testing.assert_array_equal(got, want)
    rd = REF_TRANSFER.delta_since(r0)
    pd = PORT_TRANSFER.delta_since(p0)
    for key in ("bytes_h2d", "bytes_d2h", "rounds"):
        assert pd[key] == rd[key], key


def test_intersection_tile_matches_reference_default():
    """The port's fixed tile is the reference dispatch's default tile_b, so
    both ship the same padded bytes per launch."""
    ref_tile = inspect.signature(
        ref_jaccard_ops.batched_pairwise_intersections).parameters["tile_b"]
    assert port_jaccard_ops.TILE_B == ref_tile.default


def test_intersection_ops_need_a_device():
    with pytest.raises(ValueError, match="device"):
        port_jaccard_ops.batched_pairwise_intersections(
            np.zeros((1, 8, 8), dtype=np.uint32))


def test_intersection_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="int32"):
        inter_kernel.bitset_intersections(torch.zeros((2, 8, 8)), 2)
    with pytest.raises(ValueError, match="int32"):
        inter_kernel.bitset_intersections(
            torch.zeros((8, 8), dtype=torch.int32), 1)


def test_pack_bitsets_matches_reference():
    sets = [[0, 5, 31, 32, 70], [], [69], list(range(0, 71, 3))]
    np.testing.assert_array_equal(port_jaccard_ops.pack_bitsets(sets, 71),
                                  ref_jaccard_ops.pack_bitsets(sets, 71))


# -------------------------------------------------------------- segment histogram
HIST_CASES = [
    # (E, S)
    (0, 5),        # no ids at all
    (1000, 700),   # S not a multiple of 512
    (3000, 2000),
    (257, 40),     # many ids per bin
    (64, 1500),    # S larger than E
]


@pytest.mark.parametrize("E,S", HIST_CASES)
def test_plain_histogram_matches_pallas(E, S):
    ids = _ids(E, S, seed=E + S)
    want = np.asarray(segment_histogram_kernel(jnp.asarray(ids), S,
                                               interpret=True))
    got = hist_kernel.segment_histogram(torch.from_numpy(ids), S)
    assert got.dtype == torch.int32 and got.shape == (S,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_histogram_ignores_ids_outside_range():
    ids = torch.tensor([-1, 0, 3, 4, 9, 3, -7], dtype=torch.int32)
    assert hist_ref.segment_histogram(ids, 4).tolist() == [1, 0, 0, 2]


@pytest.mark.parametrize("E,S", [(0, 3), (5, 1), (300, 300), (1200, 37),
                                 (40, 900)])
def test_membership_counts_match_reference(E, S):
    rng = np.random.default_rng(E * 7 + S)
    state = rng.integers(0, S, size=E).astype(np.int64)
    want = ref_seghist_ops.membership_counts(state, S, backend="batched")
    got = port_seghist_ops.membership_counts(state, S, backend="batched",
                                             device="cpu")
    host = port_seghist_ops.membership_counts(state, S, backend="numpy")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host, want)


def test_cpu_tensors_launch_nothing():
    n1, n2 = inter_kernel.LAUNCHES, hist_kernel.LAUNCHES
    inter_kernel.bitset_intersections(torch.zeros((2, 8, 4), dtype=torch.int32), 1)
    hist_kernel.segment_histogram(torch.zeros(8, dtype=torch.int32), 4)
    assert (inter_kernel.LAUNCHES, hist_kernel.LAUNCHES) == (n1, n2)


def test_pow2_padding_rule():
    assert [_build.pow2(x) for x in (0, 1, 8, 9, 100)] == [8, 8, 8, 16, 128]
    assert _build.pow2(3, floor=256) == 256 and _build.pow2(300, floor=256) == 512
