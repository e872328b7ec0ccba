"""The port's row-min hash and pairwise-intersection kernels, and the ops
around them (`minhash.ops`, `bitset_jaccard.ops.group_jaccard`), against
the JAX package's Pallas kernels in interpret mode and its ops.

Inputs are made with numpy from fixed seeds and handed to both packages.
On the CPU the port's wrappers run their plain PyTorch versions. Every
comparison is exact: hashes and counts are integers, and the Jaccard
matrix is one float32 division of exact integers on both sides.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.graphs import generators as GG
from repro.kernels.bitset_jaccard import ops as ref_jaccard_ops
from repro.kernels.bitset_jaccard import ref as ref_jaccard_ref
from repro.kernels.bitset_jaccard.kernel import pairwise_intersection_kernel
from repro.kernels.minhash import ops as ref_minhash_ops
from repro.kernels.minhash import ref as ref_minhash_ref
from repro.kernels.minhash.kernel import rowmin_hash_kernel
from repro_torch.core import minhash as port_core_minhash
from repro_torch.graphs import generators as PG
from repro_torch.kernels.bitset_jaccard import kernel as jaccard_kernel
from repro_torch.kernels.bitset_jaccard import ops as port_jaccard_ops
from repro_torch.kernels.minhash import kernel as minhash_kernel
from repro_torch.kernels.minhash import ops as port_minhash_ops
from repro_torch.kernels.minhash import ref as port_minhash_ref

SENTINEL = 0xFFFFFFFF
HASH_CONSTS = [(2654435761, 12345), (0x9E3779B1, 0)]


def _i32(words: np.ndarray) -> torch.Tensor:
    """uint32 words as the int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32)
                            .view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _rows(R, W, seed, high=1 << 20, pad=0.3):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, high, size=(R, W), dtype=np.uint64).astype(np.uint32)
    nbr[rng.random((R, W)) < pad] = SENTINEL
    return nbr


# ----------------------------------------------------------------- row-min hash
@pytest.mark.parametrize("ab", HASH_CONSTS)
@pytest.mark.parametrize("R,W", [(8, 8), (64, 16), (100, 128), (256, 32),
                                 (300, 130)])
def test_plain_rowmin_hash_matches_pallas(R, W, ab):
    nbr = _rows(R, W, seed=R * W)
    want = np.asarray(rowmin_hash_kernel(jnp.asarray(nbr), *ab,
                                         interpret=True))
    got = minhash_kernel.rowmin_hash(_i32(nbr), *ab)
    assert got.dtype == torch.int32 and got.shape == (R,)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(got), np.asarray(ref_minhash_ref.rowmin_hash(jnp.asarray(nbr),
                                                          *ab)))


@pytest.mark.parametrize("block_r,block_w", [(16, 16), (7, 5)])
def test_plain_rowmin_hash_full_range_words(block_r, block_w):
    """Words with bit 31 set (compared unsigned) and every hash value
    reachable; the Pallas kernel in uneven blocks."""
    nbr = _rows(64, 48, seed=3, high=SENTINEL, pad=0.1)
    a, b = 2654435761, 7
    want = np.asarray(rowmin_hash_kernel(jnp.asarray(nbr), a, b,
                                         block_r=block_r, block_w=block_w,
                                         interpret=True))
    np.testing.assert_array_equal(
        _u32(minhash_kernel.rowmin_hash(_i32(nbr), a, b)), want)


def test_plain_rowmin_hash_empty_rows_and_chunks(monkeypatch):
    nbr = _rows(40, 8, seed=5)
    nbr[::3] = SENTINEL
    want = np.asarray(rowmin_hash_kernel(jnp.asarray(nbr), 2654435761, 7,
                                         interpret=True))
    assert (want[::3] == SENTINEL).all()
    monkeypatch.setattr(port_minhash_ref, "_BUDGET", 8 * 7)  # 7-row chunks
    np.testing.assert_array_equal(
        _u32(minhash_kernel.rowmin_hash(_i32(nbr), 2654435761, 7)), want)
    empty = minhash_kernel.rowmin_hash(torch.zeros((3, 0), dtype=torch.int32),
                                       1, 2)
    assert (_u32(empty) == SENTINEL).all()


def test_rowmin_hash_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="int32"):
        minhash_kernel.rowmin_hash(torch.zeros((2, 3), dtype=torch.int64), 1, 2)
    with pytest.raises(ValueError, match="int32"):
        minhash_kernel.rowmin_hash(torch.zeros(3, dtype=torch.int32), 1, 2)


# ------------------------------------------------------------------- shingles
def _graphs():
    return {"star": (lambda: GG.star_of_cliques(30, 8, seed=3),
                     lambda: PG.star_of_cliques(30, 8, seed=3)),
            "caveman": (lambda: GG.caveman(12, 6, 0.05, seed=2),
                        lambda: PG.caveman(12, 6, 0.05, seed=2)),
            "rmat": (lambda: GG.rmat(8, 8, seed=1),
                     lambda: PG.rmat(8, 8, seed=1))}


@pytest.mark.parametrize("width", [8, 128])
@pytest.mark.parametrize("name", ["star", "caveman", "rmat", "edgeless"])
def test_pack_adjacency_matches_reference(name, width):
    if name == "edgeless":
        indptr, indices = np.zeros(6, dtype=np.int64), np.zeros(0, np.int32)
    else:
        g = _graphs()[name][0]()
        indptr, indices = g.indptr, g.indices
    rows, owners = port_minhash_ops.pack_adjacency(indptr, indices, width)
    want_rows, want_owners = ref_minhash_ops.pack_adjacency(indptr, indices,
                                                            width)
    assert rows.dtype == np.uint32 and owners.dtype == np.int64
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(owners, want_owners)


@pytest.mark.parametrize("ab", HASH_CONSTS)
@pytest.mark.parametrize("name", ["star", "caveman", "rmat"])
def test_node_and_root_shingles_match_reference(name, ab):
    g = _graphs()[name][0]()
    rows, owners = ref_minhash_ops.pack_adjacency(g.indptr, g.indices, 8)
    want = np.asarray(ref_minhash_ops.node_shingles(
        jnp.asarray(rows), owners, g.n, *ab, use_kernel=True, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(ref_minhash_ops.node_shingles(
        jnp.asarray(rows), owners, g.n, *ab, use_kernel=False)))
    got = port_minhash_ops.node_shingles(_i32(rows), torch.from_numpy(owners),
                                         g.n, *ab)
    assert got.dtype == torch.int64 and got.shape == (g.n,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a root map with leafless root ids, which take the u32 maximum
    rng = np.random.default_rng(g.n)
    n_ids = g.n + 7
    root_of = rng.integers(0, n_ids - 7, size=g.n)
    want_roots = np.asarray(ref_minhash_ops.root_shingles(
        jnp.asarray(want), jnp.asarray(root_of.astype(np.int32)), n_ids))
    got_roots = port_minhash_ops.root_shingles(got, torch.from_numpy(root_of),
                                               n_ids)
    np.testing.assert_array_equal(got_roots.numpy(),
                                  want_roots.astype(np.int64))
    assert (got_roots.numpy()[g.n:] == SENTINEL).all()


@pytest.mark.parametrize("sub_seed", [0, 1, 12345, 2 ** 63 + 5])
def test_node_shingles_equal_the_engines_host_shingles(sub_seed):
    """The kernel path and the engine's host u32 shingles compute one
    hash: with the engine's constants they agree on every node."""
    g = PG.caveman(30, 7, 0.05, seed=4)
    a, b = port_core_minhash.u32_seed_consts(sub_seed)
    rows, owners = port_minhash_ops.pack_adjacency(g.indptr, g.indices, 4)
    got = port_minhash_ops.node_shingles(_i32(rows), torch.from_numpy(owners),
                                         g.n, int(a), int(b))
    np.testing.assert_array_equal(
        got.numpy(), port_core_minhash.node_shingles_u32(g, sub_seed))


# ------------------------------------------------------- pairwise intersections
# the last four: the CUDA kernel's tiling edges (one row; one word; the
# record's wide row, W split over the SMs with 4-byte copies; a ragged
# 17th 32-row tile)
@pytest.mark.parametrize("G,W", [(4, 1), (32, 8), (128, 16), (60, 33),
                                 (37, 5), (1, 1), (200, 1), (512, 6875),
                                 (513, 33)])
def test_plain_pairwise_intersection_matches_pallas(G, W):
    rng = np.random.default_rng(G + W)
    bits = rng.integers(0, 1 << 32, size=(G, W), dtype=np.uint64)
    bits = bits.astype(np.uint32)
    bits[0] = SENTINEL  # an all-ones row
    want = np.asarray(pairwise_intersection_kernel(jnp.asarray(bits),
                                                   interpret=True))
    got = jaccard_kernel.pairwise_intersections(_i32(bits))
    assert got.dtype == torch.int32 and got.shape == (G, G)
    np.testing.assert_array_equal(got.numpy(), want)
    # the jnp oracle holds G·G·W words at once (21 GB at 512 × 6875), so it
    # checks the cases that stay small; the Pallas kernel checks them all
    if G * G * W <= 1 << 24:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_jaccard_ref.pairwise_intersection(
                jnp.asarray(bits))))


def test_plain_pairwise_intersection_chunks_rows(monkeypatch):
    from repro_torch.kernels.bitset_jaccard import ref as port_jaccard_ref

    bits = _i32(_rows(23, 7, seed=8, high=SENTINEL, pad=0.0))
    whole = jaccard_kernel.pairwise_intersections(bits)
    monkeypatch.setattr(port_jaccard_ref, "_BUDGET", 23 * 7 * 3)  # 3 rows
    np.testing.assert_array_equal(
        jaccard_kernel.pairwise_intersections(bits).numpy(), whole.numpy())
    np.testing.assert_array_equal(
        whole.numpy(), port_jaccard_ref.bitset_intersections(bits[None],
                                                             1)[0].numpy())


def test_pairwise_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="int32"):
        jaccard_kernel.pairwise_intersections(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="int32"):
        jaccard_kernel.pairwise_intersections(
            torch.zeros((1, 2, 3), dtype=torch.int32))


@pytest.mark.parametrize("case", ["ba", "rmat", "empty-rows"])
def test_group_jaccard_matches_reference(case):
    if case == "ba":
        g = GG.barabasi_albert(150, 4, seed=2)
        sets = [set(map(int, g.neighbors(u))) for u in range(40)]
        universe = g.n
    elif case == "rmat":
        g = GG.rmat(9, 8, seed=3)
        top = np.argsort(-np.diff(g.indptr), kind="stable")[:64]
        sets = [set(map(int, g.neighbors(int(u)))) for u in top]
        universe = g.n
    else:
        sets = [set(), {1, 2}, set(), {2, 70}]
        universe = 71
    bits = ref_jaccard_ops.pack_bitsets(sets, universe)
    np.testing.assert_array_equal(port_jaccard_ops.pack_bitsets(sets, universe),
                                  bits)
    want = np.asarray(ref_jaccard_ops.group_jaccard(bits, use_kernel=True,
                                                    interpret=True))
    got = port_jaccard_ops.group_jaccard(bits, device="cpu")
    assert got.dtype == np.float32 == want.dtype
    np.testing.assert_array_equal(got, want)
    for i in range(0, len(sets), 3):
        for j in range(0, len(sets), 2):
            inter = len(sets[i] & sets[j])
            union = len(sets[i] | sets[j])
            expect = (np.float32(inter) / np.float32(union) if union
                      else np.float32(0))
            assert got[i, j] == expect, (i, j)


def test_group_jaccard_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_jaccard_ops.group_jaccard(np.zeros((2, 1), dtype=np.uint32))
