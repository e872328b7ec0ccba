"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Every test is marked `cuda` and skips without a card (a CUDA kernel
has no CPU mode; `tests/test_torch_kernels.py`, `test_torch_bitset_fold.py`,
`test_torch_serving.py` and `test_torch_shingles.py` hold the plain
versions to the JAX package here).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only the port installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bitset_fold import kernel as fold_kernel
from repro_torch.kernels.bitset_fold import ref as fold_ref
from repro_torch.kernels.bitset_jaccard import kernel as inter_kernel
from repro_torch.kernels.bitset_jaccard import ref as inter_ref
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn import ref as flash_ref
from repro_torch.kernels.interval_expand import kernel as interval_kernel
from repro_torch.kernels.interval_expand import ref as interval_ref
from repro_torch.kernels.minhash import kernel as minhash_kernel
from repro_torch.kernels.minhash import ref as minhash_ref
from repro_torch.kernels.seghist import kernel as hist_kernel
from repro_torch.kernels.seghist import ref as hist_ref


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _bits(shape, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    words[..., 0, :] = 0xFFFFFFFF  # all-ones words
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _ids(E, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, size=E).astype(np.int32)
    ids[rng.random(E) < 0.2] = -1
    return torch.from_numpy(ids)


def _gram_checks(got, bits, valid):
    """A Gram matrix of popcounts: symmetric, its diagonal the rows'
    popcounts, zero in the rows past ``valid``."""
    assert torch.equal(got, got.transpose(-1, -2))
    pop = inter_ref.popcount_u32(bits[:valid]).sum(-1).to(torch.int32)
    assert torch.equal(torch.diagonal(got[:valid], dim1=-2, dim2=-1), pop)
    assert not got[valid:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("G,W,valid", [
    (8, 8, 64), (16, 64, 37), (128, 256, 64), (32, 5, 3), (17, 3, 64),
    # the tiling's edges: G one row, a ragged second 32-row tile, one short
    # of four tiles; W one word, a ragged 32-word chunk, past 256 words;
    # no valid row and one
    (1, 1, 64), (1, 257, 1), (33, 9, 64), (33, 257, 0), (127, 1, 1),
    (127, 9, 64), (127, 257, 37), (3, 9, 0), (1, 9, 63)])
@pytest.mark.parametrize("ones", [False, True], ids=["random", "ones-group"])
def test_cuda_intersections_match_plain(G, W, valid, ones):
    _need_card()
    bits = _bits((64, G, W), seed=G + W)
    if ones:
        bits[1] = -1  # a whole group of all-ones words
    bits = bits.cuda()
    n = inter_kernel.LAUNCHES
    got = inter_kernel.bitset_intersections(bits, valid)
    torch.cuda.synchronize()
    assert inter_kernel.LAUNCHES == n + 1
    assert torch.equal(got, inter_ref.bitset_intersections(bits, valid))
    _gram_checks(got, bits, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("G,W", [(8, 8), (64, 64), (33, 9)])
def test_cuda_intersections_read_a_misaligned_base(G, W):
    """A contiguous view whose base is not 16-byte aligned takes the
    kernel's 4-byte copies; the counts are the same."""
    _need_card()
    rng = np.random.default_rng(G)
    words = rng.integers(0, 1 << 32, size=64 * G * W + 1, dtype=np.uint64)
    flat = torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda()
    bits = flat[1:].view(64, G, W)
    assert bits.data_ptr() % 16
    got = inter_kernel.bitset_intersections(bits, 64)
    assert torch.equal(got, inter_ref.bitset_intersections(bits, 64))
    pw = inter_kernel.pairwise_intersections(bits[0])
    assert torch.equal(pw, inter_ref.pairwise_intersection(bits[0]))


def _hist_ids(E, S, kind, seed):
    """"random": 20% padding; "runs": runs of equal ids in edge order, then
    -1 padding to the end (the emission DP's); "pad": all -1; "outside":
    ids past S and below -1 beside valid ones; "offset": random ids read
    from one element past a 16-byte boundary (the 4-at-a-time loads start
    after a scalar head)."""
    rng = np.random.default_rng(seed)
    if kind == "runs":
        lens = rng.geometric(1 / 6, size=E)
        ids = np.repeat(rng.integers(0, S, size=E), lens)[: E * 3 // 4]
        ids = np.concatenate([ids, np.full(E - ids.size, -1)])
        return torch.from_numpy(ids.astype(np.int32)).cuda()
    if kind == "pad":
        return torch.full((E,), -1, dtype=torch.int32, device="cuda")
    if kind == "outside":
        return torch.from_numpy(rng.integers(-3, 2 * S + 2, size=E).astype(
            np.int32)).cuda()
    if kind == "offset":
        return _ids(E + 1, S, seed).cuda()[1:]
    return _ids(E, S, seed).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,kind", [
    (1 << 17, 1 << 18, "random"), (1 << 20, 1 << 15, "random"),
    (1000, 700, "random"), (5, 1, "random"),
    # the batched main path's largest calls, in its id order
    (1 << 21, 1 << 17, "runs"), (1 << 18, 1 << 18, "runs"),
    # many ids into few bins (every id of a bin on one L2 address), one
    # bin, and a grid that strides (more 128-id spans than 8 blocks an SM
    # of 8 warps take at once)
    (1 << 21, 1 << 9, "random"), (1 << 21, 1 << 9, "runs"),
    (1 << 22, 1, "random"), (1 << 24, 1 << 15, "runs"),
    # E not a multiple of 4, a misaligned base, all -1, ids outside [0, S),
    # one bin, fewer ids than one 16-byte load
    (1003, 300, "runs"), (4097, 257, "offset"), (6, 5, "offset"),
    (4096, 64, "pad"), (5001, 40, "outside"), (4099, 1, "runs"),
    (3, 2, "random")])
def test_cuda_histogram_matches_plain(E, S, kind):
    _need_card()
    ids = _hist_ids(E, S, kind, seed=E)
    n = hist_kernel.LAUNCHES
    got = hist_kernel.segment_histogram(ids, S)
    torch.cuda.synchronize()
    assert hist_kernel.LAUNCHES == n + 1
    assert torch.equal(got, hist_ref.segment_histogram(ids, S))


@pytest.mark.cuda
def test_cuda_ops_match_host_path():
    """The ops on the card return what the host path returns, with the
    same padding contracts."""
    _need_card()
    from repro_torch.kernels.bitset_jaccard import ops as O1
    from repro_torch.kernels.seghist import ops as O2

    rng = np.random.default_rng(5)
    bits = rng.integers(0, 1 << 32, size=(70, 16, 5), dtype=np.uint64)
    bits = bits.astype(np.uint32)
    np.testing.assert_array_equal(
        O1.batched_pairwise_intersections(bits, device="cuda"),
        O1.batched_pairwise_intersections(bits, device="cpu"))
    state = rng.integers(0, 300, size=1000)
    np.testing.assert_array_equal(
        O2.membership_counts(state, 300, backend="batched", device="cuda"),
        O2.membership_counts(state, 300, backend="numpy"))


@pytest.mark.cuda
def test_cuda_summarize_matches_host_oracle():
    _need_card()
    import repro_torch
    from repro_torch.graphs import generators as GG

    g = GG.caveman(200, 8, 0.05, seed=0)
    on_card = repro_torch.summarize(g, T=5)
    host = repro_torch.summarize(g, T=5, backend="numpy", device="cpu")
    np.testing.assert_array_equal(on_card.parent, host.parent)
    np.testing.assert_array_equal(on_card.edges, host.edges)
    assert on_card.validate_lossless(g)


def _fold_instr(B, G, W, P, seed, kind="disjoint"):
    """"disjoint": disjoint row pairs per group, member columns sharing
    32-bit words and hitting bit 31, about one row in eight padding (valid
    = 0); "sparse": the same with most groups holding no valid row (the
    resident path's rounds); "chained": rows and columns drawn with repeats
    (a == z and ca == cz included), so the order of the pairs matters."""
    rng = np.random.default_rng(seed)
    n = W * 32
    rows = np.argsort(rng.random((B, G)), axis=1)[:, : 2 * P]
    cols = np.argsort(rng.random((B, n)), axis=1)[:, : 2 * P]
    cols[:, :4] = [31, 30, 63 if W > 1 else 29, 0][: min(4, 2 * P)]
    valid = (rng.random((B, P)) < 0.875).astype(np.int32)
    if kind == "chained":
        rows = rng.integers(0, G, size=(B, 2 * P))
        cols = rng.integers(0, n, size=(B, 2 * P))
    if kind == "sparse":
        valid[rng.random(B) < 0.85] = 0
    ca, cz = cols[:, 0::2], cols[:, 1::2]
    instr = np.stack([rows[:, 0::2], rows[:, 1::2], ca >> 5, ca & 31,
                      cz >> 5, cz & 31, valid, np.zeros_like(valid)], axis=2)
    return torch.from_numpy(instr.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,W,J", [
    (3, 2, 3, 1), (64, 8, 2, 7), (64, 16, 8, 15), (37, 32, 5, 16),
    (64, 128, 256, 16), (5, 128, 4, 16),
    # the resident main path's largest calls (G = 8, 16 at 2 words)
    (32768, 8, 2, 7), (32768, 16, 2, 15),
    # the regime edges (G <= 32 one lane per pair, G > 32 the b1 tile),
    # J = G - 1, ragged and empty word counts
    (9, 2, 2, 1), (7, 31, 5, 30), (6, 32, 3, 31), (5, 33, 3, 32),
    (3, 33, 300, 16), (4, 128, 256, 127), (3, 100, 37, 99), (5, 17, 0, 16),
    (2, 64, 0, 63)])
def test_cuda_topj_matches_plain(B, G, W, J):
    _need_card()
    bits = _bits((B, G, W), seed=G + W).cuda()
    rng = np.random.default_rng(G)
    alive = torch.from_numpy((rng.random((B, G)) < 0.8).astype(np.int8))
    alive[-1] = 0  # an all-dead group
    alive = alive.cuda()
    n = fold_kernel.TOPJ_LAUNCHES
    got = fold_kernel.jaccard_topj(bits, alive, J)
    torch.cuda.synchronize()
    assert fold_kernel.TOPJ_LAUNCHES == n + 1
    assert torch.equal(got, fold_ref.topj_all(bits, alive, J))


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,W,P,kind", [
    (4, 8, 2, 4, "disjoint"), (64, 16, 8, 8, "disjoint"),
    (64, 128, 256, 64, "disjoint"), (7, 32, 1, 16, "disjoint"),
    # the resident main path's largest calls (G = 8, 16 at 2 words)
    (32768, 8, 2, 4, "sparse"), (32768, 16, 2, 8, "sparse"),
    # the regime edges (narrow: G <= 32 and W <= 8), P = 1, several
    # segments of instruction rows, padding lanes (G = 3, 17), chains,
    # staged rows not 16-byte aligned (W = 9, 5, 2 past G = 32)
    (9, 32, 8, 16, "disjoint"), (9, 32, 9, 16, "disjoint"),
    (5, 33, 2, 16, "disjoint"), (70, 8, 2, 1, "disjoint"),
    (33, 4, 3, 9, "chained"), (40, 16, 2, 8, "chained"),
    (6, 40, 5, 20, "chained"), (50, 3, 4, 1, "disjoint"),
    (20, 17, 4, 8, "sparse"),
    # the wide regime's bitmap in shared memory at its edge (128 rows of
    # 383 words) and past it, in global memory (384 words); just past the
    # default 48 KB of shared memory less the kernel's 4 KB of static
    # (128 rows of 90 words: 46,592 bytes)
    (3, 128, 383, 16, "chained"), (3, 128, 384, 16, "disjoint"),
    (3, 128, 90, 16, "chained")])
def test_cuda_fold_matches_plain(B, G, W, P, kind):
    _need_card()
    bits = _bits((B, G, W), seed=B + W).cuda()
    alive = torch.ones((B, G), dtype=torch.int8, device="cuda")
    instr = _fold_instr(B, G, W, P, seed=G, kind=kind).cuda()
    want_bits, want_alive = bits.clone(), alive.clone()
    n = fold_kernel.FOLD_LAUNCHES
    fold_kernel.bitset_fold(bits, alive, instr)
    torch.cuda.synchronize()
    assert fold_kernel.FOLD_LAUNCHES == n + 1
    fold_ref.fold_pairs(want_bits, want_alive, instr)
    assert torch.equal(bits, want_bits)
    assert torch.equal(alive, want_alive)


@pytest.mark.cuda
@pytest.mark.parametrize("G,W", [(16, 2), (64, 5)])
def test_cuda_fold_reads_a_misaligned_slab(G, W):
    """An instruction slab that starts off a 16-byte boundary (a view one
    int32 into its storage) is read word by word, in both regimes."""
    _need_card()
    B, P = 40, 8
    bits = _bits((B, G, W), seed=G).cuda()
    alive = torch.ones((B, G), dtype=torch.int8, device="cuda")
    slab = _fold_instr(B, G, W, P, seed=W, kind="chained").reshape(-1)
    instr = torch.cat([slab[:1], slab]).cuda()[1:].view(B, P, 8)
    assert instr.data_ptr() % 16 != 0
    want_bits, want_alive = bits.clone(), alive.clone()
    fold_kernel.bitset_fold(bits, alive, instr)
    fold_ref.fold_pairs(want_bits, want_alive, instr)
    assert torch.equal(bits, want_bits)
    assert torch.equal(alive, want_alive)


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,W,P", [(4, 8, 0, 2), (4, 8, 2, 0), (0, 8, 2, 2)])
def test_cuda_fold_with_nothing_to_fold_launches_nothing(B, G, W, P):
    _need_card()
    bits = torch.zeros((B, G, W), dtype=torch.int32, device="cuda")
    alive = torch.ones((B, G), dtype=torch.int8, device="cuda")
    instr = torch.ones((B, P, 8), dtype=torch.int32, device="cuda")
    n = fold_kernel.FOLD_LAUNCHES
    fold_kernel.bitset_fold(bits, alive, instr)
    torch.cuda.synchronize()
    assert fold_kernel.FOLD_LAUNCHES == n
    assert bool((alive == 1).all())


@pytest.mark.cuda
def test_cuda_resident_summarize_matches_batched():
    _need_card()
    import repro_torch
    from repro_torch.graphs import generators as GG

    g = GG.caveman(200, 8, 0.05, seed=0)
    n = (fold_kernel.TOPJ_LAUNCHES, fold_kernel.FOLD_LAUNCHES)
    resident = repro_torch.summarize(g, T=5, backend="resident")
    assert fold_kernel.TOPJ_LAUNCHES > n[0]
    assert fold_kernel.FOLD_LAUNCHES > n[1]
    batched = repro_torch.summarize(g, T=5, backend="batched")
    np.testing.assert_array_equal(resident.parent, batched.parent)
    np.testing.assert_array_equal(resident.edges, batched.edges)
    assert resident.validate_lossless(g)


@pytest.mark.cuda
def test_cuda_resident_partitions_on_threads_count_every_launch(monkeypatch):
    """Resident ``partitions=2, workers=2`` on the card equals
    ``partitions=1``, and the kernels' counters equal the wrapper calls
    that launch, counted under a lock around the ops' names."""
    _need_card()
    import threading

    import repro_torch
    from repro_torch.graphs import generators as GG
    from repro_torch.kernels.bitset_fold import ops as fold_ops

    lock = threading.Lock()
    calls = {"topj": 0, "fold": 0}
    topj, fold = fold_ops.jaccard_topj, fold_ops.bitset_fold

    def counted_topj(bits, alive, J):
        if bits.shape[0]:
            with lock:
                calls["topj"] += 1
        return topj(bits, alive, J)

    def counted_fold(bits, alive, instr):
        if bits.shape[0] and bits.shape[2] and instr.shape[1]:
            with lock:
                calls["fold"] += 1
        return fold(bits, alive, instr)

    monkeypatch.setattr(fold_ops, "jaccard_topj", counted_topj)
    monkeypatch.setattr(fold_ops, "bitset_fold", counted_fold)
    g = GG.caveman(200, 8, 0.05, seed=0)
    n = (fold_kernel.TOPJ_LAUNCHES, fold_kernel.FOLD_LAUNCHES)
    two = repro_torch.SummarizerEngine(backend="resident", partitions=2,
                                       workers=2, T=5).run(g)
    torch.cuda.synchronize()
    assert calls["topj"] > 0 and calls["fold"] > 0
    assert fold_kernel.TOPJ_LAUNCHES - n[0] == calls["topj"]
    assert fold_kernel.FOLD_LAUNCHES - n[1] == calls["fold"]
    one = repro_torch.SummarizerEngine(backend="resident", T=5).run(g)
    np.testing.assert_array_equal(two.parent, one.parent)
    np.testing.assert_array_equal(two.edges, one.edges)
    assert two.validate_lossless(g)


def _card_arena(seed=0):
    """A resident arena on the card over one batched chunk of a caveman
    graph, and the chunk's dirty rows."""
    from repro_torch.core import merging as PM
    from repro_torch.core.resident import ResidentBitmapArena
    from repro_torch.core.slugger import SluggerState
    from repro_torch.core.transfer import TransferCounter
    from repro_torch.graphs import generators as GG

    st = SluggerState(GG.caveman(40, 6, 0.1, seed=seed))
    roots = np.unique(st.root_of)
    groups = [roots[i:i + 8] for i in range(0, roots.size, 8)]
    plans = [PM.MergePlan(g) for g in groups]
    ws = PM.BatchedGroupWorkspace.build_bucket(
        st, groups, 8, plans, np.arange(len(groups), dtype=np.uint64))[0]
    arena = ResidentBitmapArena.from_workspace(
        ws, top_j=4, device=torch.device("cuda"), counter=TransferCounter())
    return arena, ws


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["kernel.bitset_fold.round",
                                  "kernel.bitset_fold.fold_counts"])
def test_cuda_twin_retry_equals_the_kernel_path(site):
    """A fault forced into a round op on the card: the arena retries on the
    plain versions (recorded once, ``use_kernel`` dropped) and its verdicts
    and folded state equal a clean arena's kernel path."""
    _need_card()
    from repro_torch import faults
    from repro_torch.core.merging import theta_to_p

    clean, ws = _card_arena()
    hurt, _ = _card_arena()
    rb, rr = np.nonzero(ws.alive)
    theta_p = theta_to_p(0.0)
    n = (fold_kernel.TOPJ_LAUNCHES, fold_kernel.FOLD_LAUNCHES)
    want = clean.propose_rows(rb, theta_p, None)
    b, a, z = rb[want[0]], rr[want[0]], want[1][want[0]]
    first = np.concatenate([[True], b[1:] != b[:-1]])
    b, a, z = b[first], a[first], z[first]
    assert b.size > 0
    clean.fold_counts(b, a, z)
    torch.cuda.synchronize()
    assert fold_kernel.TOPJ_LAUNCHES > n[0] and fold_kernel.FOLD_LAUNCHES > n[1]
    mark = faults.DEGRADATIONS.count()
    with faults.inject(site):
        got = hurt.propose_rows(rb, theta_p, None)
        hurt.fold_counts(b, a, z)
    torch.cuda.synchronize()
    assert faults.DEGRADATIONS.count() - mark == 1
    assert clean.use_kernel and not hurt.use_kernel
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)
    for k in clean.state:
        assert torch.equal(clean.state[k], hurt.state[k]), k


@pytest.mark.cuda
def test_cuda_plain_ops_launch_no_kernel():
    """``use_kernel=False`` runs the plain versions on card tensors: the
    same integers, and no launch."""
    _need_card()
    from repro_torch.kernels.bitset_fold import ops as fold_ops

    arena, _ = _card_arena(seed=1)
    state = {k: v.clone() for k, v in arena.state.items()}
    rows = torch.nonzero(state["alive"] > 0)
    n = (fold_kernel.TOPJ_LAUNCHES, fold_kernel.FOLD_LAUNCHES)
    plain = fold_ops.topj(state, rows, arena.J, use_kernel=False)
    rows_p, ok_p, z_p = fold_ops.propose(state, arena.J, 0, None,
                                         use_kernel=False)
    torch.cuda.synchronize()
    assert (fold_kernel.TOPJ_LAUNCHES, fold_kernel.FOLD_LAUNCHES) == n
    assert plain.is_cuda
    assert torch.equal(plain, fold_ops.topj(arena.state, rows, arena.J))
    assert fold_kernel.TOPJ_LAUNCHES == n[0] + 1
    rows_k, ok_k, z_k = fold_ops.propose(arena.state, arena.J, 0, None)
    assert torch.equal(rows_p, rows_k) and torch.equal(ok_p, ok_k)
    assert torch.equal(z_p, z_k)
    b, a, z = rows_k[ok_k, 0], rows_k[ok_k, 1], z_k[ok_k]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=b.device),
                       b[1:] != b[:-1]])
    b, a, z = b[first], a[first], z[first]
    slot = torch.zeros_like(b)
    n_fold = fold_kernel.FOLD_LAUNCHES
    fold_ops.fold(state, b, slot, a, z, 2, use_kernel=False)
    assert fold_kernel.FOLD_LAUNCHES == n_fold
    fold_ops.fold(arena.state, b, slot, a, z, 2)
    assert fold_kernel.FOLD_LAUNCHES == n_fold + 1
    for k in state:
        assert torch.equal(state[k], arena.state[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["batched", "resident"])
def test_cuda_clean_run_reports_zero_degradations(backend):
    """A clean run on the card records no degradation: no kernel failed
    and fell back to its plain version unseen."""
    _need_card()
    import repro_torch
    from repro_torch.graphs import generators as GG

    g = GG.caveman(200, 8, 0.05, seed=0)
    eng = repro_torch.SummarizerEngine(backend=backend, T=5)
    s = eng.run(g)
    assert eng.stats["degradations"] == 0
    assert s.validate_lossless(g)
    if backend == "resident":
        assert eng._run_ctx is not None and eng._run_ctx.bank is not None


def _intervals(B, E, P, seed, layout="random"):
    """``random``: intervals and probes over a DFS range of 10,000
    positions, about a quarter of each padded (lo == hi == 0 with sign 0;
    probes -1). ``serving``: row 0 holds E real intervals, every other row
    1..16, slots past a row's count (0, 0, 0), and the probes are the
    row's sorted boundaries (P = 2E), as serving builds its tiles.
    ``edge``: lo >= hi for about a third, negative positions, signs of ±1,
    ±3 and 0, and row 0 wholly real (a hub past one shared-memory chunk
    when E > 4,096)."""
    rng = np.random.default_rng(seed)
    if layout == "serving":
        n = rng.integers(1, 17, size=B)
        n[0] = E
        real = np.arange(E)[None, :] < n[:, None]
        lo = np.where(real, rng.integers(0, 1 << 14, size=(B, E)), 0)
        hi = np.where(real, lo + rng.integers(1, 512, size=(B, E)), 0)
        sg = np.where(real, rng.choice([-1, 1], size=(B, E)), 0)
        pos = np.sort(np.concatenate([lo, hi], axis=1), axis=1)[:, :P]
    elif layout == "edge":
        lo = rng.integers(-5_000, 5_000, size=(B, E))
        hi = lo + rng.integers(-2_500, 5_000, size=(B, E))
        sg = rng.choice([-3, -1, 0, 1, 3], size=(B, E))
        hi[0] = lo[0] + rng.integers(1, 5_000, size=E)
        sg[0] = rng.choice([-3, -1, 1, 3], size=E)
        pos = rng.integers(-10_000, 10_000, size=(B, P))
    else:
        lo = rng.integers(0, 10_000, size=(B, E))
        hi = lo + rng.integers(0, 2_000, size=(B, E))
        sg = rng.choice([-1, 1], size=(B, E))
        pad = rng.random((B, E)) < 0.25
        lo[pad] = hi[pad] = sg[pad] = 0
        pos = rng.integers(0, 12_000, size=(B, P))
        pos[rng.random((B, P)) < 0.25] = -1
    return [torch.from_numpy(a.astype(np.int32)).cuda()
            for a in (lo, hi, sg, pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,E,P,layout", [
    (256, 8, 16, "random"), (256, 128, 256, "random"),
    (256, 512, 1024, "random"), (3, 1000, 70_000, "random"),
    (256, 512, 1, "random"), (5, 3, 1, "random"), (7, 0, 4, "random"),
    (9, 33, 2, "random"),
    # serving's widest tile: one hub row, probes the sorted boundaries
    (256, 4096, 8192, "serving"), (256, 16, 32, "serving"),
    # any int32 input; hub rows past one shared-memory chunk (4,096)
    (64, 1000, 3000, "edge"), (3, 20_000, 3000, "edge"),
    (2, 8193, 5000, "edge"), (4, 40, 1, "edge")])
def test_cuda_interval_counts_match_plain(B, E, P, layout):
    _need_card()
    lo, hi, sg, pos = _intervals(B, E, P, seed=B + E + P, layout=layout)
    n = interval_kernel.LAUNCHES
    got = interval_kernel.interval_counts(lo, hi, sg, pos)
    torch.cuda.synchronize()
    assert interval_kernel.LAUNCHES == n + 1
    assert torch.equal(got, interval_ref.interval_counts(lo, hi, sg, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("R,W", [(220_000, 128), (4099, 1000), (33, 5),
                                 (1, 0)])
def test_cuda_rowmin_hash_matches_plain(R, W):
    _need_card()
    rng = np.random.default_rng(R + W)
    words = rng.integers(0, 1 << 32, size=(R, W), dtype=np.uint64)
    words[rng.random((R, W)) < 0.3] = 0xFFFFFFFF
    words[::7] = 0xFFFFFFFF  # rows of sentinels only
    nbr = torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda()
    n = minhash_kernel.LAUNCHES
    got = minhash_kernel.rowmin_hash(nbr, 2654435761, 0x9E3779B9)
    torch.cuda.synchronize()
    assert minhash_kernel.LAUNCHES == n + 1
    assert torch.equal(got, minhash_ref.rowmin_hash(nbr, 2654435761,
                                                    0x9E3779B9))


@pytest.mark.cuda
@pytest.mark.parametrize("G,W", [(37, 5), (128, 128), (512, 512), (33, 65),
                                 (1, 1), (200, 1), (512, 6875), (513, 33),
                                 (64, 4096)])
def test_cuda_pairwise_intersections_match_plain(G, W):
    _need_card()
    bits = _bits((G, W), seed=G * W).cuda()
    n = inter_kernel.PAIRWISE_LAUNCHES
    got = inter_kernel.pairwise_intersections(bits)
    torch.cuda.synchronize()
    assert inter_kernel.PAIRWISE_LAUNCHES == n + 1
    assert torch.equal(got, inter_ref.pairwise_intersection(bits))
    _gram_checks(got, bits, G)


@pytest.mark.cuda
def test_cuda_shingles_and_jaccard_match_host():
    _need_card()
    from repro_torch.core import minhash as core_minhash
    from repro_torch.graphs import generators as GG
    from repro_torch.kernels.bitset_jaccard import ops as O1
    from repro_torch.kernels.minhash import ops as OM

    g = GG.caveman(300, 9, 0.05, seed=1)
    rows, owners = OM.pack_adjacency(g.indptr, g.indices, 4)
    rows_t = torch.from_numpy(rows.view(np.int32)).cuda()
    for sub_seed in (0, 7):
        a, b = core_minhash.u32_seed_consts(sub_seed)
        got = OM.node_shingles(rows_t, torch.from_numpy(owners), g.n, int(a),
                               int(b))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      core_minhash.node_shingles_u32(g, sub_seed))
    sets = [set(map(int, g.neighbors(u))) for u in range(0, 300, 3)]
    bits = O1.pack_bitsets(sets, g.n)
    np.testing.assert_array_equal(O1.group_jaccard(bits),
                                  O1.group_jaccard(bits, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_cuda_server_answers_match_numpy(backend):
    _need_card()
    import repro_torch
    from repro_torch.graphs import generators as GG
    from repro_torch.launch.summary_serve import (SummaryQueryServer,
                                                  make_queries)

    for g in (GG.caveman(200, 8, 0.05, seed=0), GG.rmat(10, 8, seed=0)):
        ps = repro_torch.summarize(g, T=5).pack_for_serving()
        queries = make_queries(g.n, 700, edge_frac=0.3, seed=2)
        n = interval_kernel.LAUNCHES
        got = SummaryQueryServer(ps, batch_slots=64, backend=backend).run(
            queries)
        if backend == "kernel":
            assert interval_kernel.LAUNCHES > n
        else:
            assert interval_kernel.LAUNCHES == n
        want = SummaryQueryServer(ps, batch_slots=64, backend="numpy").run(
            queries)
        for q, a, w in zip(queries, got, want):
            if q[0] == "neighbors":
                np.testing.assert_array_equal(a, w)
                np.testing.assert_array_equal(a, g.neighbors(q[1]))
            else:
                assert a == w == g.has_edge(q[1], q[2]), q


# (B, H, Hkv, Sq, Sk, D, dtype, causal, window): the serving prefill's
# call, GQA and MHA, danube's head dim past its window, Sq != Sk, ragged
# tiles, every head-dim bucket of the f32 kernel (16 … 256); then the bf16
# tensor-core kernel at head dims 8 … 256 (each padded width, and padding
# inside one), Sq and Sk multiples of neither 64 nor 16, Sq < Sk and
# Sq > Sk causal and not, window 1, a window past the sequence, Hkv = 1,
# and rows past Sk + window - 1 that see no key
FLASH_CASES = [
    (2, 16, 2, 1024, 1024, 128, "bfloat16", True, 0),
    (1, 32, 8, 600, 600, 80, "bfloat16", True, 256),
    (2, 12, 12, 256, 1536, 64, "bfloat16", False, 0),
    (2, 4, 2, 300, 300, 32, "float32", True, 64),
    (1, 4, 4, 77, 130, 16, "float32", False, 0),
    (1, 2, 1, 200, 200, 256, "float32", True, 0),
    (1, 6, 3, 129, 129, 24, "float32", True, 1),
    (1, 2, 2, 64, 40, 128, "float32", True, 0),
    (1, 4, 2, 77, 130, 8, "bfloat16", False, 0),
    (1, 4, 2, 130, 77, 24, "bfloat16", True, 0),
    (2, 6, 3, 200, 200, 40, "bfloat16", True, 1),
    (1, 8, 1, 333, 333, 64, "bfloat16", True, 1000),
    (1, 8, 2, 150, 90, 80, "bfloat16", False, 0),
    (1, 4, 4, 90, 150, 96, "bfloat16", True, 0),
    (1, 4, 1, 257, 257, 128, "bfloat16", True, 100),
    (1, 2, 1, 100, 121, 136, "bfloat16", False, 0),
    (1, 2, 2, 300, 300, 256, "bfloat16", True, 0),
    (1, 2, 1, 200, 330, 256, "bfloat16", False, 0),
    (1, 4, 2, 100, 40, 64, "bfloat16", True, 16),
    # zamba2-7b's shared block (head dim 112, padded inside the 128
    # bucket), whisper-small's decode cross call (one query row over 1,500
    # frames) and its encoder's call
    (1, 32, 32, 257, 257, 112, "bfloat16", True, 0),
    (2, 12, 12, 1, 1500, 64, "bfloat16", False, 0),
    (1, 12, 12, 1500, 1500, 64, "bfloat16", False, 0),
]


def _flash_inputs(shapes, dtype, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(getattr(torch, dtype)).to(device) for s in shapes]


def _flash_close(got, q, k, v, causal, window):
    """Tolerances are the reference's (`tests/test_flash_attn_kernel.py`):
    bf16 atol 2e-2, f32 atol 2e-5, rtol 1e-2; the plain version runs in
    full f32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    want = flash_ref.attention_ref(q, k, v, causal=causal, window=window)
    atol = 2e-2 if q.dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,dtype,causal,window", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(B, H, Hkv, Sq, Sk, D, dtype,
                                            causal, window):
    """bf16 runs on the tensor-core kernel and f32 on the CUDA-core one:
    the per-variant counter says which launched."""
    _need_card()
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs([(B, H, Sq, D), (B, Hkv, Sk, D),
                             (B, Hkv, Sk, D)], dtype, B * H + Sq + D)
    name = flash_kernel.variant(dt)
    assert name == ("tc_bf16" if dtype == "bfloat16" else "cuda_core_f32")
    n, by = flash_kernel.LAUNCHES, dict(flash_kernel.LAUNCHES_BY)
    got = flash_kernel.flash_attention_bhsd(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES == n + 1
    assert flash_kernel.LAUNCHES_BY == {**by, name: by[name] + 1}
    assert got.dtype == dt and got.shape == q.shape
    _flash_close(got, q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_cuda_flash_attention_reads_model_layout_in_place(dtype, causal,
                                                          window):
    """`ops.flash_attention` on the model's (b, s, hkv, g, hd) tensors
    hands the kernel strided views, and views cut from one fused qkv row
    (row stride past D), and gives bit for bit what the kernel gives on
    the same data made contiguous; the output needs no copy."""
    _need_card()
    from repro_torch.kernels.flash_attn import ops as flash_ops

    b, s, hkv, g, hd = 2, 200, 2, 4, 80
    q, k, v = _flash_inputs([(b, s, hkv, g, hd), (b, s, hkv, hd),
                             (b, s, hkv, hd)], dtype, 17)
    fused = torch.cat([q.reshape(b, s, -1), k.reshape(b, s, -1),
                       v.reshape(b, s, -1)], dim=-1)
    qv = fused[..., :hkv * g * hd].view(b, s, hkv, g, hd)
    kv = fused[..., hkv * g * hd:(hkv * g + hkv) * hd].view(b, s, hkv, hd)
    vv = fused[..., (hkv * g + hkv) * hd:].view(b, s, hkv, hd)
    want = flash_kernel.flash_attention_bhsd(
        q.permute(0, 2, 3, 1, 4).reshape(b, hkv * g, s, hd).contiguous(),
        k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous(),
        causal=causal, window=window)
    want = want.reshape(b, hkv, g, s, hd).permute(0, 3, 1, 2, 4)
    for args in ((q, k, v), (qv, kv, vv)):
        n = flash_kernel.LAUNCHES
        got = flash_ops.flash_attention(*args, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_kernel.LAUNCHES == n + 1
        assert got.shape == (b, s, hkv, g, hd)
        assert torch.equal(got, want)
    assert flash_ops.flash_attention(q, k, v, causal=causal,
                                     window=window).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_never_reads_past_sk(dtype):
    """Rows past Sk in the backing storage hold NaN: the kernel zero-fills
    its tiles there (0 × a stale NaN would be NaN)."""
    _need_card()
    B, H, Hkv, Sq, Sk, D = 1, 4, 2, 100, 77, 64
    q, k_full, v_full = _flash_inputs([(B, H, Sq, D), (B, Hkv, 128, D),
                                       (B, Hkv, 128, D)], dtype, 5)
    k_full[:, :, Sk:] = float("nan")
    v_full[:, :, Sk:] = float("nan")
    k, v = k_full[:, :, :Sk], v_full[:, :, :Sk]
    for causal in (True, False):
        got = flash_kernel.flash_attention_bhsd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        _flash_close(got, q, k.contiguous(), v.contiguous(), causal, 0)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_cannot_take():
    _need_card()
    q = torch.zeros(1, 2, 8, 20, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_kernel.flash_attention_bhsd(q, q, q)
    q = torch.zeros(1, 2, 32, 32, device="cuda")
    strided = q.transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_kernel.flash_attention_bhsd(strided, strided, strided)
    ragged = torch.zeros(1, 2, 8, 33, device="cuda")[..., :32]
    with pytest.raises(ValueError, match="16-byte"):
        flash_kernel.flash_attention_bhsd(ragged, ragged, ragged)
    shifted = torch.zeros(1 + 2 * 8 * 32, device="cuda")[1:].view(1, 2, 8, 32)
    with pytest.raises(ValueError, match="16-byte"):
        flash_kernel.flash_attention_bhsd(shifted, shifted, shifted)


# (B, H, Hkv, Sq, Sk, D, Dv, dtype, causal, window): v narrower than q and
# k. MLA's prefill call at B = 1 (D 192, Dv 128), its smoke widths (24,
# 16), a Dv off the 16-column pairs, GQA with a window, and ragged f32
FLASH_DV_CASES = [
    (1, 16, 16, 1024, 1024, 192, 128, "bfloat16", True, 0),
    (2, 4, 4, 77, 77, 24, 16, "bfloat16", True, 0),
    (1, 4, 2, 130, 200, 64, 40, "bfloat16", False, 0),
    (1, 8, 2, 300, 300, 128, 8, "bfloat16", True, 64),
    (1, 2, 1, 150, 150, 256, 248, "bfloat16", True, 0),
    (2, 4, 4, 300, 300, 192, 128, "float32", True, 0),
    (1, 4, 2, 77, 130, 24, 16, "float32", False, 0),
    (2, 3, 3, 200, 200, 64, 40, "float32", True, 50),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,Dv,dtype,causal,window",
                         FLASH_DV_CASES)
def test_cuda_flash_attention_narrow_v_matches_plain(B, H, Hkv, Sq, Sk, D,
                                                     Dv, dtype, causal,
                                                     window):
    """v (and o) Dv wide, v read in place as MLA hands it: a strided view
    (columns 16 .. 16 + Dv) of a wider row, whose columns past the view
    hold NaN that the kernel must not read."""
    _need_card()
    dt = getattr(torch, dtype)
    q, k, wide = _flash_inputs([(B, H, Sq, D), (B, Hkv, Sk, D),
                                (B, Hkv, Sk, 16 + Dv + 8)], dtype,
                               B * H + Sq + D + Dv)
    wide[..., 16 + Dv:] = float("nan")
    v = wide[..., 16:16 + Dv]
    name = flash_kernel.variant(dt)
    n, by = flash_kernel.LAUNCHES, dict(flash_kernel.LAUNCHES_BY)
    got = flash_kernel.flash_attention_bhsd(q, k, v, causal=causal,
                                            window=window)
    torch.cuda.synchronize()
    assert flash_kernel.LAUNCHES == n + 1
    assert flash_kernel.LAUNCHES_BY == {**by, name: by[name] + 1}
    assert got.dtype == dt and got.shape == (B, H, Sq, Dv)
    assert torch.isfinite(got).all()
    _flash_close(got, q, k, v.contiguous(), causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_narrow_v_model_layout(dtype):
    """MLA's call through `ops.flash_attention`: q and k dense (b, s, h,
    1, 192) and (b, s, h, 192), v the view ``kv[..., 128:]`` of the
    (b, s, h, 256) expansion. The output is dense in the model's layout
    and equals the kernel on the same data made contiguous."""
    _need_card()
    from repro_torch.kernels.flash_attn import ops as flash_ops

    b, s, h = 2, 160, 4
    q, k, kv = _flash_inputs([(b, s, h, 1, 192), (b, s, h, 192),
                              (b, s, h, 256)], dtype, 23)
    v = kv[..., 128:]
    got = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.shape == (b, s, h, 1, 128) and got.is_contiguous()
    want = flash_kernel.flash_attention_bhsd(
        q[:, :, :, 0].permute(0, 2, 1, 3).contiguous(),
        k.permute(0, 2, 1, 3).contiguous(),
        v.permute(0, 2, 1, 3).contiguous(), causal=True)
    assert torch.equal(got[:, :, :, 0].permute(0, 2, 1, 3), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "deepseek-v2-lite-16b"])
def test_cuda_moe_forward_matches_cpu(arch):
    """The MoE smoke models (GQA; MLA) on the card, flash kernel in every
    layer's prefill, against the same weights on the CPU in float32:
    routing integers equal, logits and aux within the reference's
    tolerance, served tokens equal."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    on_card = _to(params, "cuda")
    assert on_card["layers"]["moe"]["router"].dtype == torch.float32
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 24)))
    n = flash_kernel.LAUNCHES
    got, aux, _ = T.forward(on_card, cfg, toks.cuda())
    assert flash_kernel.LAUNCHES == n + cfg.n_layers
    want, waux, _ = T.forward(params, cfg, toks)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(aux.cpu(), waux, atol=2e-4, rtol=1e-3)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32))
    p0 = {k: v[0] for k, v in params["layers"]["moe"].items()}
    r_cpu = M.route(p0, cfg, x)
    r_card = M.route(_to(p0, "cuda"), cfg, x.cuda())
    for name in ("top_e", "rank", "slot"):
        assert torch.equal(getattr(r_card, name).cpu(), getattr(r_cpu, name))
    assert int(r_card.dropped) == int(r_cpu.dropped)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=12) for _ in range(3)]
    a = BatchServer(cfg, on_card, batch_slots=2).run(prompts, 4)
    b = BatchServer(cfg, params, batch_slots=2, device="cpu").run(prompts, 4)
    for x_, y in zip(a, b):
        np.testing.assert_array_equal(x_, y)


@pytest.mark.cuda
def test_cuda_lm_serving_matches_cpu():
    """The dense smoke model served on the card (flash kernel in prefill)
    gives the CPU run's tokens, and its logits, in float32."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import transformer as T

    for arch in ("qwen2.5-3b", "h2o-danube-1.8b"):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        params = T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        on_card = _to(params, "cuda")
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, size=(2, 24)))
        n = flash_kernel.LAUNCHES
        got = T.forward(on_card, cfg, toks.cuda())[0]
        assert flash_kernel.LAUNCHES == n + cfg.n_layers
        want = T.forward(params, cfg, toks)[0]
        torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab, size=12) for _ in range(3)]
        a = BatchServer(cfg, on_card, batch_slots=2).run(prompts, 4)
        b = BatchServer(cfg, params, batch_slots=2, device="cpu").run(
            prompts, 4)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("mamba2-130m", None),
                                         ("zamba2-7b", 5)])
def test_cuda_ssm_and_hybrid_match_cpu(arch, layers):
    """The SSM and hybrid smoke models (zamba2 at 5 layers: a trailing
    partial group) on the card, the flash kernel in every shared-block
    prefill, against the same weights on the CPU in float32: logits, the
    Mamba2 block's out and caches, prefill and decode steps, served
    tokens."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    on_card = _to(params, "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 20)))
    n_attn = len(T._hybrid_groups(cfg)) if cfg.attn_every else 0
    n = flash_kernel.LAUNCHES
    got = T.forward(on_card, cfg, toks.cuda())[0]
    assert flash_kernel.LAUNCHES == n + n_attn
    want = T.forward(params, cfg, toks)[0]
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32))
    block = T.layer(params["layers"], 0)
    out, cache = T.ssm_block_full(block, cfg, x)
    out_c, cache_c = T.ssm_block_full(_to(block, "cuda"), cfg, x.cuda())
    torch.testing.assert_close(out_c.cpu(), out, atol=2e-4, rtol=1e-3)
    for name in ("state", "conv"):
        torch.testing.assert_close(cache_c[name].cpu(), cache[name],
                                   atol=2e-4, rtol=1e-3)
    la, ca = T.prefill(on_card, cfg, toks[:, :12].cuda(), cache_len=20)
    lb, cb = T.prefill(params, cfg, toks[:, :12], cache_len=20)
    torch.testing.assert_close(la.cpu(), lb, atol=2e-4, rtol=1e-3)
    for pos in range(12, 20):
        la, ca = T.decode_step(on_card, cfg, ca, toks[:, pos:pos + 1].cuda(),
                               pos)
        lb, cb = T.decode_step(params, cfg, cb, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(la.cpu(), lb, atol=2e-4, rtol=1e-3)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=12) for _ in range(3)]
    a = BatchServer(cfg, on_card, batch_slots=2).run(prompts, 4)
    b = BatchServer(cfg, params, batch_slots=2, device="cpu").run(prompts, 4)
    for x_, y in zip(a, b):
        np.testing.assert_array_equal(x_, y)


@pytest.mark.cuda
def test_cuda_encdec_prefill_and_decode_match_cpu():
    """whisper-small's smoke model on the card (flash in the encoder, the
    decoder's self-attention and its cross-attention, in prefill and at
    one query row in every decode step) against the same weights on the
    CPU in float32."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec as E

    cfg = dataclasses.replace(get_config("whisper-small", smoke=True),
                              dtype="float32")
    params = E.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    on_card = _to(params, "cuda")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 150, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 14)))
    n = flash_kernel.LAUNCHES
    la, ca = E.prefill(on_card, cfg, frames.cuda(), toks[:, :9].cuda(),
                       cache_len=14)
    assert flash_kernel.LAUNCHES == n + cfg.encoder_layers + 2 * cfg.n_layers
    lb, cb = E.prefill(params, cfg, frames, toks[:, :9], cache_len=14)
    torch.testing.assert_close(la.cpu(), lb, atol=2e-4, rtol=1e-3)
    for name in ("attn", "cross"):
        for kv in ("k", "v"):
            torch.testing.assert_close(ca[name][kv].cpu(), cb[name][kv],
                                       atol=2e-4, rtol=1e-3)
    for pos in range(9, 14):
        n = flash_kernel.LAUNCHES
        la, ca = E.decode_step(on_card, cfg, ca, toks[:, pos:pos + 1].cuda(),
                               pos)
        assert flash_kernel.LAUNCHES == n + cfg.n_layers
        lb, cb = E.decode_step(params, cfg, cb, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(la.cpu(), lb, atol=2e-4, rtol=1e-3)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_vlm_prefill_and_decode_match_cpu():
    """internvl2-26b's smoke model (4 patch embeddings before the text) on
    the card, the flash kernel in every layer's prefill, against the same
    weights on the CPU in float32: forward, prefill into a cache of
    patches + text + generated slots, and decode steps from position
    ``n_patches + text``."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.api import get_api

    cfg = dataclasses.replace(get_config("internvl2-26b", smoke=True),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    on_card = _to(params, "cuda")
    batch = make_batch(cfg, TokenStream(cfg.vocab, 2, 24), 0, device="cpu")
    toks, embeds = batch["tokens"][:, :20], batch["embeds"]
    n = flash_kernel.LAUNCHES
    got = T.forward(on_card, cfg, toks.cuda(), embeds=embeds.cuda())[0]
    assert flash_kernel.LAUNCHES == n + cfg.n_layers
    want = T.forward(params, cfg, toks, embeds=embeds)[0]
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=1e-3)
    api, p0 = get_api(cfg), cfg.n_patches + 12
    la, ca = api.prefill(on_card, cfg, {"tokens": toks[:, :12].cuda(),
                                        "embeds": embeds.cuda()},
                         cache_len=cfg.n_patches + 20)
    lb, cb = api.prefill(params, cfg, {"tokens": toks[:, :12],
                                       "embeds": embeds},
                         cache_len=cfg.n_patches + 20)
    torch.testing.assert_close(la.cpu(), lb, atol=2e-4, rtol=1e-3)
    for g in range(8):
        tok = toks[:, 12 + g:13 + g]
        la, ca = api.decode_step(on_card, cfg, ca, tok.cuda(), p0 + g)
        lb, cb = api.decode_step(params, cfg, cb, tok, p0 + g)
        torch.testing.assert_close(la.cpu(), lb, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(la[:, 0].cpu(), want[:, p0 + g],
                                   atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b",
                                  "mamba2-130m", "whisper-small"])
def test_cuda_train_step_matches_cpu(arch):
    """One train step of the smoke model on the card against the CPU in
    float32 (TF32 off): loss and every gradient within the reference's
    tolerance, no flash launch (training attends through the chunked
    twin), and the updated parameters within 3·lr (Adam's step is ≈ lr
    whatever a gradient's size, so a near-zero gradient rounded apart can
    move an entry by ±lr)."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch
    from repro_torch.models.api import get_api
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = get_api(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    states = {"cpu": TS.init_state(params),
              "cuda": TS.init_state(_to(params, "cuda"))}
    step = TS.build_train_step(TS.TrainPlan(cfg=cfg, warmup=1,
                                            total_steps=10))
    stream = TokenStream(cfg.vocab, 2, 32)
    n = flash_kernel.LAUNCHES
    out = {}
    for s in range(2):
        for dev, state in states.items():
            batch = make_batch(cfg, stream, s, device=dev)
            loss, grads = TS.loss_and_grads(state["params"],
                                            TS.train_config(cfg), batch)
            _, metrics = step(state, batch)
            out[dev] = (loss, grads, metrics)
        assert flash_kernel.LAUNCHES == n
        (lc, gc, mc), (lh, gh, mh) = out["cuda"], out["cpu"]
        torch.testing.assert_close(lc.cpu(), lh, atol=2e-4, rtol=1e-3)
        for a, b in zip(gc, gh):
            torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(mc["grad_norm"].cpu(), mh["grad_norm"],
                                   atol=2e-4, rtol=1e-3)
    for a, b in zip(adamw.leaves(states["cuda"]["params"]),
                    adamw.leaves(states["cpu"]["params"])):
        assert (a.cpu() - b).abs().max() <= 3 * 3e-4


@pytest.mark.cuda
def test_cuda_custom_backwards_pass_gradcheck_in_f64():
    _need_card()
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((3, 4, 8), generator=gen, device="cuda",
                    dtype=torch.float64, requires_grad=True)
    w = (1 + 0.1 * torch.randn(8, generator=gen, device="cuda",
                               dtype=torch.float64)).requires_grad_()
    wm = torch.randn((8, 5), generator=gen, device="cuda",
                     dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: L.rms_norm(a, b, 1e-6),
                                    (x, w))
    assert torch.autograd.gradcheck(L.lowp_matmul_f32, (x, wm))


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_inputs_that_require_grad():
    _need_card()
    q = torch.randn(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    n = flash_kernel.LAUNCHES
    with pytest.raises(RuntimeError, match="xla_chunked"):
        flash_kernel.flash_attention_bhsd(q, k, k)
    assert flash_kernel.LAUNCHES == n
    with torch.no_grad():
        flash_kernel.flash_attention_bhsd(q, k, k)
    assert flash_kernel.LAUNCHES == n + 1


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip_and_copy_on_submit(tmp_path):
    """A bf16 train state on the card saved by the async saver (the card
    updates it in place right after `submit`) and restored onto the card:
    equal bit for bit to the state at submit time."""
    _need_card()
    from repro_torch.train import checkpoint as CKPT

    state = {"params": {"w": torch.randn(64, 32, device="cuda")
                        .to(torch.bfloat16)},
             "opt": {"m": {"w": torch.randn(64, 32, device="cuda")},
                     "step": torch.tensor(5, dtype=torch.int32,
                                          device="cuda")}}
    want = {"w": state["params"]["w"].clone(),
            "m": state["opt"]["m"]["w"].clone()}
    ck = CKPT.AsyncCheckpointer(str(tmp_path))
    ck.submit(state, 5)
    state["params"]["w"].add_(1)
    state["opt"]["m"]["w"].mul_(2)
    ck.close()
    assert not ck.errors
    got, step = CKPT.restore(state, str(tmp_path))
    assert step == 5 and got["params"]["w"].device.type == "cuda"
    assert torch.equal(got["params"]["w"], want["w"])
    assert torch.equal(got["opt"]["m"]["w"], want["m"])
    assert int(got["opt"]["step"]) == 5


@pytest.mark.cuda
def test_cuda_train_driver_restores_bit_for_bit(tmp_path, monkeypatch):
    """`launch.train.main` on the card (mamba2-130m smoke, deterministic
    algorithms): a failure at step 6 on every attempt of its first pass
    restores step 4 and ends in the uninterrupted run's state."""
    _need_card()
    import json

    from repro_torch.launch import train as LT
    from repro_torch.train.fault_tolerance import FaultToleranceConfig

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        args = ["--arch", "mamba2-130m", "--smoke", "--steps", "8",
                "--batch", "2", "--seq", "32", "--ckpt-every", "4",
                "--device", "cuda"]
        full = LT.main(args + ["--ckpt-dir", str(tmp_path / "a")])
        orig, left = LT.build_train_step, [
            FaultToleranceConfig().max_retries + 1]

        def faulty(plan):
            step = orig(plan)

            def wrapped(state, batch):
                if int(state["opt"]["step"]) == 6 and left[0]:
                    left[0] -= 1
                    raise RuntimeError("persistent failure at step 6")
                return step(state, batch)

            return wrapped

        monkeypatch.setattr(LT, "build_train_step", faulty)
        got = LT.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    finally:
        torch.use_deterministic_algorithms(False)
    assert left[0] == 0 and got[6:] == full[4:]
    da, db = (tmp_path / d / "step_00000008" for d in ("a", "b"))
    ma = json.loads((da / "manifest.json").read_text())
    assert ma == json.loads((db / "manifest.json").read_text())
    for e in ma["arrays"]:
        assert np.array_equal(np.load(da / e["file"]),
                              np.load(db / e["file"]))


# ------------------------------------------- slice E5: the data axis
@pytest.fixture
def nccl_group(tmp_path):
    """A one-rank NCCL process group for the test, destroyed after it."""
    _need_card()
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["batched", "resident"])
def test_cuda_one_rank_nccl_engine_equals_the_no_mesh_engine(nccl_group,
                                                             backend):
    from repro_torch.core.engine import SummarizerEngine
    from repro_torch.graphs import generators as PG
    from repro_torch.launch.mesh import make_data_mesh

    g = PG.caveman(60, 8, 0.05, seed=3)
    plain = SummarizerEngine(backend=backend, T=6, seed=1,
                             device="cuda").run(g)
    eng = SummarizerEngine(backend=backend, T=6, seed=1, device="cuda",
                           mesh=make_data_mesh())
    got = eng.run(g)
    assert eng.stats["degradations"] == 0
    assert got.validate_lossless(g)
    assert np.array_equal(got.parent, plain.parent)
    assert np.array_equal(got.edges, plain.edges)


@pytest.mark.cuda
def test_cuda_engine_refuses_a_card_run_under_a_cpu_mesh():
    _need_card()
    from repro_torch.core.engine import SummarizerEngine
    from repro_torch.graphs import generators as PG

    class CpuMesh:
        device_type = "cpu"

    with pytest.raises(RuntimeError, match="NCCL"):
        SummarizerEngine(backend="batched", T=2, device="cuda",
                         mesh=CpuMesh()).run(PG.caveman(4, 4, 0.0, seed=0))


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,W", [(5, 8, 3), (70, 16, 9), (2, 128, 40)])
def test_cuda_per_rank_intersection_bodies_equal_the_kernel(B, G, W):
    _need_card()
    from repro_torch.core import distributed as D

    n = 4
    Bs = 1 << max(0, (-(-B // n) - 1).bit_length())
    Wp = 1 << max(3, (W - 1).bit_length())
    batch = np.zeros((n * Bs, G, Wp), dtype=np.uint32)
    batch[:B, :, :W] = _bits((B, G, W), B).numpy().view(np.uint32)
    before = inter_kernel.LAUNCHES
    got = torch.cat([D.intersections_rank(batch, B, r, n, "cuda")
                     for r in range(n)])
    assert inter_kernel.LAUNCHES - before == n
    whole = inter_kernel.bitset_intersections(
        torch.from_numpy(batch.view(np.int32)).cuda(), B)
    assert torch.equal(got, whole)
    _gram_checks(got.cpu(), torch.from_numpy(batch.view(np.int32)), B)


@pytest.mark.cuda
def test_cuda_per_rank_arena_round_equals_the_whole_arena():
    """One proposal round and one fold on an arena of real workspace
    chunks, shard by shard for ranks 0..3 of 4, equal to the whole
    arena's — the kernels launched on every shard."""
    _need_card()
    from repro_torch.core.merging import (BatchedGroupWorkspace, MergePlan,
                                          theta_to_p)
    from repro_torch.core.minhash import candidate_groups, \
        host_shingle_provider
    from repro_torch.core.resident import ResidentBitmapArena
    from repro_torch.core.slugger import SluggerState
    from repro_torch.graphs import generators as PG
    from repro_torch.kernels.bitset_fold import ops as FO
    from repro_torch.launch.mesh import block

    g = PG.caveman(200, 8, 0.05, seed=1)
    st = SluggerState(g)
    groups = candidate_groups(g, st.root_of, st.alive, seed=0,
                              shingle_fn=host_shingle_provider(g)(st.root_of),
                              max_group=16)
    groups = [gr for gr in groups if gr.size <= 16]
    ws = BatchedGroupWorkspace.build_bucket(
        st, groups, 16, plans=[MergePlan(gr) for gr in groups],
        group_seeds=np.arange(len(groups), dtype=np.uint64))[0]
    arena = ResidentBitmapArena.from_workspace(ws, top_j=8, device="cuda")
    state, n = arena.state, 4
    Bp = state["bits"].shape[0]
    assert Bp % n == 0
    shards = [{k: v[block(Bp, r, n)].clone() for k, v in state.items()}
              for r in range(n)]
    t0 = fold_kernel.TOPJ_LAUNCHES
    whole = FO.propose_dense(state, arena.J, theta_to_p(0.0), None)
    got = torch.cat([FO.propose_dense(s, arena.J, theta_to_p(0.0), None)
                     for s in shards])
    assert fold_kernel.TOPJ_LAUNCHES - t0 == n + 1
    assert torch.equal(got, whole) and whole[..., 1].any()
    acc = whole.cpu().numpy()
    gb, gr = np.nonzero(acc[..., 1])
    first = np.concatenate([[True], gb[1:] != gb[:-1]])[:gb.size]
    gb, ga, gz = gb[first], gr[first], acc[gb[first], gr[first], 2]
    keep = ga != gz
    gb, ga, gz = (torch.from_numpy(x[keep].astype(np.int64)).cuda()
                  for x in (gb, ga, gz))
    slot = torch.zeros_like(gb)
    FO.fold(state, gb, slot, ga, gz, 2)
    for r, s in enumerate(shards):
        FO.fold_shard(s, gb, slot, ga, gz, 2, r * (Bp // n))
    for k, v in state.items():
        assert torch.equal(torch.cat([s[k] for s in shards]), v), k


# ------------------------------------------------- the model axis (E6a)
MODEL_AXIS_CASES = [(a, d, m, b) for a in (
    "qwen2.5-3b", "h2o-danube-1.8b", "qwen3-moe-235b-a22b",
    "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b", "whisper-small",
    "internvl2-26b") for d, m, b in ((1, 4, 4), (2, 2, 4), (2, 2, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,data,model,batch", MODEL_AXIS_CASES)
def test_cuda_per_rank_serving_bodies_equal_the_unsharded_model(
        arch, data, model, batch):
    """Each smoke model in f32 served by per-rank bodies on the card
    (`local_ranks.run_ranks`: the ranks take turns between collectives), a
    prefill of 16 positions and 8 decode steps: every rank's logits equal
    the one-device run's (max|Δ| ≤ 1e-4·max|ref| + 1e-5), the flash
    kernel launched at the rank's heads, the MoE routing equal."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.launch.local_ranks import run_ranks
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import get_api
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    api = get_api(cfg)
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    P, n, off = 16, 8, cfg.n_patches
    toks = torch.randint(0, cfg.vocab, (batch, P + n), generator=gen,
                         device="cuda")
    extra = {}
    if cfg.encoder_layers:
        extra["frames"] = torch.randn(batch, 24, cfg.d_model, generator=gen,
                                      device="cuda")
    if off:
        extra["embeds"] = torch.randn(batch, off, cfg.d_model, generator=gen,
                                      device="cuda")
    slots = P + n + off
    routes, orig = {}, moe.route

    def route(p, c, x):
        import threading

        r = orig(p, c, x)
        routes.setdefault(threading.current_thread().name, []).append(r.top_e)
        return r

    sizes = {"data": data, "model": model}
    cspecs = SH.cache_pspecs(cfg, TS.cache_shapes(cfg, batch, slots), sizes,
                             ("data",), batch)

    def run(p, rows, axes=None):
        b = {"tokens": toks[rows, :P], **{k: v[rows] for k, v in
                                          extra.items()}}
        outs = []
        if axes is None:
            lg, cache = api.prefill(p, cfg, b, cache_len=slots)
            outs.append(lg[:, -1])
            for i in range(n):
                lg, cache = api.decode_step(p, cfg, cache,
                                            toks[rows, P + i:P + i + 1],
                                            P + off + i)
                outs.append(lg[:, 0])
            return outs
        with SH.rank_context(sizes, ("data",), *axes, batch=batch):
            lg, cache = api.prefill(p, cfg, b, cache_len=slots)
        outs.append(lg[:, -1])
        with SH.rank_context(sizes, ("data",), *axes, batch=batch,
                             cache=cspecs):
            for i in range(n):
                lg, cache = api.decode_step(p, cfg, cache,
                                            toks[rows, P + i:P + i + 1],
                                            P + off + i)
                outs.append(lg[:, 0])
        return outs

    moe.route = route
    try:
        want = run(params, slice(None))
        whole_routes = routes.pop(threading_name(), [])
        before = flash_kernel.LAUNCHES

        def body(r, model_ax, data_ax):
            coords = {"data": data_ax.rank, "model": model_ax.rank}
            rows = slice(None)
            if SH.batch_pspec(sizes, ("data",), batch)[0] is not None:
                per = batch // data
                rows = slice(data_ax.rank * per, (data_ax.rank + 1) * per)
            blocks = SH.shard_params(cfg, params, sizes, ("data",), coords)
            return rows, run(blocks, rows, (model_ax, data_ax)), \
                threading_name()

        ranks = run_ranks(body, model, data)
    finally:
        moe.route = orig
    if not cfg.ssm or cfg.attn_every:
        assert flash_kernel.LAUNCHES > before
    for rows, outs, name in ranks:
        for got, w in zip(outs, want):
            w = w[rows]
            bound = 1e-4 * w.abs().max().item() + 1e-5
            assert (got - w).abs().max().item() <= bound
        got = routes.get(name, [])
        assert len(got) == len(whole_routes)
        for a, b in zip(got, whole_routes):
            assert torch.equal(a, b[rows])


def threading_name():
    import threading

    return threading.current_thread().name


# ------------------------------------------ training under the model axis
@pytest.mark.cuda
@pytest.mark.parametrize("arch,data,model", [
    (a, d, m) for a in ("qwen2.5-3b", "h2o-danube-1.8b", "qwen3-moe-235b-a22b",
                        "deepseek-v2-lite-16b", "mamba2-130m", "zamba2-7b",
                        "whisper-small", "internvl2-26b")
    for d, m in ((1, 4), (2, 2))])
def test_cuda_per_rank_backward_assembles_to_the_one_device_gradient(
        arch, data, model):
    """Each smoke model in f32 on the card, `train_step.loss_and_grads` of
    16 × 25 tokens on per-rank bodies (`local_ranks.run_ranks`), each
    leaf SUMmed by `train_step.reduce_grads`: the gradients assembled from
    the ranks' blocks equal the one-device gradients within max|Δ| ≤
    1e-4·max|ref| + 1e-5. On the card autograd would run a backward on its
    device thread; the ranks' backward passes (remat's recompute reading
    the thread's layout, collectives waiting for the other ranks) run on
    their own threads."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.local_ranks import run_ranks
    from repro_torch.models import sharding as SH
    from repro_torch.models.api import get_api, param_shapes
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TS.train_config(dataclasses.replace(get_config(arch, smoke=True),
                                              dtype="float32"))
    params = get_api(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S = 16, 24
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S + 1), generator=gen,
                                     device="cuda")}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(B, S, cfg.d_model, generator=gen,
                                      device="cuda")
    if cfg.n_patches:
        batch["embeds"] = torch.randn(B, cfg.n_patches, cfg.d_model,
                                      generator=gen, device="cuda")
    _, want = TS.loss_and_grads(params, cfg, batch)
    sizes = {"data": data, "model": model}
    sums = TS.grad_sums(cfg, sizes, ("data",))

    def body(r, model_ax, data_ax):
        coords = {"data": data_ax.rank, "model": model_ax.rank}
        per = B // data
        rows = {k: v[data_ax.rank * per:(data_ax.rank + 1) * per]
                for k, v in batch.items()}
        blocks = SH.shard_params(cfg, params, sizes, ("data",), coords)
        with SH.rank_context(sizes, ("data",), model_ax, data_ax):
            _, grads = TS.loss_and_grads(blocks, cfg, rows)
            return coords, TS.reduce_grads(grads, sums, data)

    ranks = run_ranks(body, model, data)
    specs = adamw.leaves(SH.param_pspecs(cfg, param_shapes(cfg), sizes,
                                         ("data",)))
    for i, (w, spec) in enumerate(zip(want, specs)):
        whole = torch.empty_like(w)
        for coords, grads in ranks:
            whole[SH.local_block(tuple(w.shape), spec, sizes, coords)] = \
                grads[i]
        bound = 1e-4 * w.abs().max().item() + 1e-5
        assert (whole - w).abs().max().item() <= bound, i


@pytest.mark.cuda
def test_cuda_quickstart_example(capsys):
    """`examples/torch_quickstart.py` at its defaults runs on the card,
    through the batched summarizer's intersection and histogram kernels,
    and prints what its CPU run prints."""
    from test_torch_examples import _printed, load_example

    _need_card()
    mod = load_example("quickstart")

    def printed():
        return _printed(capsys.readouterr().out)

    capsys.readouterr()
    before = (inter_kernel.LAUNCHES, hist_kernel.LAUNCHES)
    card = mod.main([])
    on_card = printed()
    assert inter_kernel.LAUNCHES > before[0]
    assert hist_kernel.LAUNCHES > before[1]
    cpu = mod.main(["--device", "cpu"])
    assert on_card == printed()
    assert np.array_equal(card.parent, cpu.parent)
    assert np.array_equal(card.edges, cpu.edges)


@pytest.mark.cuda
def test_cuda_tracing_times_spans_on_the_card():
    """`repro_torch.tracing` on the card: the smoke MLA-MoE served with
    the tracer on gives the tokens it gives off; every span has device
    seconds from its CUDA events, each parent at least its children's sum
    (its self seconds that difference), the dropped pairs read back once,
    and the flash kernel's launches as its own counter moved."""
    from repro_torch import tracing
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import BatchServer
    from repro_torch.models import transformer as T

    _need_card()
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    server = BatchServer(cfg, params, batch_slots=4, max_len=66,
                         device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 64) for _ in range(4)]
    off = server.run(prompts, gen_tokens=2)
    launches = flash_kernel.LAUNCHES
    with tracing.recording() as rec:
        on = server.run(prompts, gen_tokens=2)
    assert rec.cuda
    assert all(np.array_equal(a, b) for a, b in zip(off, on))
    assert rec.launches.get("flash_attn.LAUNCHES", 0) \
        == flash_kernel.LAUNCHES - launches
    children = {}
    for s in rec.spans:
        assert s.device_s is not None and s.device_s >= 0, s.name
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) + s.device_s
    for s in rec.spans:
        kids = children.get(s.id, 0.0)
        assert abs(s.self_s - (s.device_s - kids)) < 1e-9
        assert s.device_s >= kids - 1e-4, s.name
    drops = rec.sums_within("serve.prefill", "moe.route", "dropped_pairs")
    assert len(drops) == 1 and 0 <= drops[0] \
        <= cfg.n_layers * 4 * 64 * cfg.moe.top_k
