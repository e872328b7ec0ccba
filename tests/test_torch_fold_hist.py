"""The designs of the port's bitset-fold and segment-histogram CUDA kernels
(`csrc/bitset_fold.cu`, `csrc/segment_histogram.cu`), transcribed to numpy
step by step, against the JAX package's Pallas kernels in interpret mode.

A CUDA kernel cannot run here, so these transcriptions pin each design's
logic where the card cannot be reached: the fold's lane-per-row narrow
regime (segments of S = pow2(G) lanes, the packed instruction word, the
ballot that skips groups without a valid row, the warp-uniform pair loop
with predicated effects, row z's words reaching lane a by a shuffle) and
its block-per-group wide regime (staged instruction rows, step 3 folded
into step 2); the histogram's run folding (run heads, the suffix minimum
over lanes, one atomic per run), its 16-byte body with a scalar head and a
-1-filled tail. Each
transcription also fails on a stated mutation of its design.
`tests/test_torch_cuda.py` holds the kernels themselves to their plain
versions on a card.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.bitset_fold.kernel import bitset_fold_kernel
from repro.kernels.seghist.kernel import segment_histogram_kernel
from repro_torch.kernels.bitset_fold import ref as fold_ref
from repro_torch.kernels.seghist import ref as hist_ref

NARROW_THREADS, NARROW_MAX_G, NARROW_MAX_W = 256, 32, 8  # bitset_fold.cu
WIDE_CHUNK = 128  # kWideChunk
HIST_THREADS, SPAN = 256, 128  # segment_histogram.cu kThreads, kSpan
U32 = np.uint32


# ------------------------------------------------------------------- fold
def _pack(rows):
    """bitset_fold.cu `pack_pair`: one instruction row as one word."""
    r = rows.astype(np.int64)
    word = (1 | (r[:, 0] & 31) << 1 | (r[:, 1] & 31) << 6
            | (r[:, 3] & 31) << 11 | (r[:, 5] & 31) << 16
            | (r[:, 2] & 7) << 21 | (r[:, 4] & 7) << 24)
    return np.where(r[:, 6] > 0, word, 0).astype(np.uint32)


def narrow_fold(words, alive, instr, mutation=None):
    """The G <= 32, W <= 8 kernel, every lane of the grid at once. Lane t
    is row r = t % S of group t / S (S = pow2(G), at least 2); a shuffle
    of width S from lane q reads lane t - r + q. ``mutation``: "wrong-lane"
    brings row z's words from lane z ^ 1; "reversed" walks the warp's
    valid slots from the last."""
    words, alive = words.copy(), alive.copy()
    B, G, W = words.shape
    P = instr.shape[1]
    assert G <= NARROW_MAX_G and W <= NARROW_MAX_W
    S = max(2, 1 << (G - 1).bit_length())
    WM = 2 if W <= 2 else 4 if W <= 4 else 8
    seg_mask = (1 << S) - 1
    T = -(-B * S // NARROW_THREADS) * NARROW_THREADS
    t = np.arange(T)
    lane, warp = t % 32, t // 32
    r = lane & (S - 1)
    seg0 = lane & ~(S - 1)
    b = t // S
    in_group = b < B
    has_row = in_group & (r < G)
    bs, rs = np.where(in_group, b, 0), np.where(has_row, r, 0)
    w = np.zeros((T, WM), dtype=U32)
    loaded = np.zeros(T, dtype=bool)
    ar = np.arange(T)
    for c in range(0, P, S):
        mine = np.zeros(T, dtype=U32)
        m = in_group & (c + r < P)
        mine[m] = _pack(instr[b[m], c + r[m]])
        ballot = np.zeros(T // 32, dtype=np.int64)
        np.bitwise_or.at(ballot, warp, (mine & 1).astype(np.int64) << lane)
        bal = ballot[warp]
        group_valid = (bal != 0) & (((bal >> seg0) & seg_mask) != 0)
        load = group_valid & ~loaded & has_row
        w[load, :W] = words[bs[load], rs[load]]
        loaded |= group_valid
        slots = bal.copy()
        sh = 16
        while sh >= S:
            slots |= slots >> sh
            sh >>= 1
        slots &= seg_mask
        order = range(S - 1, -1, -1) if mutation == "reversed" else range(S)
        for q in order:
            run = ((slots >> q) & 1) == 1  # uniform across each warp
            src = t - r + q
            assert np.all(src // 32 == warp)
            pk = mine[src].astype(np.int64)
            v = run & ((pk & 1) == 1)
            a, z = (pk >> 1) & 31, (pk >> 6) & 31
            ba, bz = (pk >> 11) & 31, (pk >> 16) & 31
            wa, wz = (pk >> 21) & 7, (pk >> 24) & 7
            # 1. own row: bit bz of word wz to bit ba of word wa
            colz = (w[ar, np.minimum(wz, WM - 1)] >> bz.astype(U32)) & U32(1)
            colz = np.where(wz < WM, colz, U32(0))
            sel = v & (wa < WM)
            w[ar[sel], wa[sel]] |= colz[sel] << ba[sel].astype(U32)
            sel = v & (wz < WM)
            w[ar[sel], wz[sel]] &= ~(U32(1) << bz[sel].astype(U32))
            # 2. every lane shuffles row z's words; a ORs them, z zeroes
            zl = (z ^ 1) if mutation == "wrong-lane" else z
            src = t - r + (zl % S)
            assert np.all(src // 32 == warp)
            zk = w[src, :W].copy()
            is_a, is_z = v & (r == a), v & (r == z)
            w[is_a, :W] |= zk[is_a]
            w[is_z] = 0
            # 3. a clears its own column bit; z dies
            sel = is_a & (wa < WM)
            w[ar[sel], wa[sel]] &= ~(U32(1) << ba[sel].astype(U32))
            dead = is_z & has_row
            alive[b[dead], z[dead]] = 0
    store = loaded & has_row
    words[b[store], r[store]] = w[store, :W]
    return words, alive


def wide_fold(words, alive, instr):
    """The wide kernel: a block per group, instruction rows staged
    WIDE_CHUNK at a time, a group without a valid row skipped (its bitmap,
    staged in shared memory or not, is the same words); per valid pair
    step 1 over the rows (words wa and wz read together, then written),
    then steps 2 and 3 over the words (the thread owning word wa clears
    a's bit, a's store before z's)."""
    words, alive = words.copy(), alive.copy()
    B, G, W = words.shape
    P = instr.shape[1]
    for b in range(B):
        grp = words[b]
        for c in range(0, P, WIDE_CHUNK):
            staged = instr[b, c:c + WIDE_CHUNK]
            if not np.any(staged[:, 6] > 0):
                continue
            for a, z, wa, ba, wz, bz, valid, _ in staged.astype(np.int64):
                if valid <= 0:
                    continue
                xz, xa = grp[:, wz].copy(), grp[:, wa].copy()
                colz = (xz >> U32(bz)) & U32(1)
                if wa == wz:
                    grp[:, wz] = (xz | colz << U32(ba)) & ~(U32(1) << U32(bz))
                else:
                    grp[:, wa] = xa | colz << U32(ba)
                    grp[:, wz] = xz & ~(U32(1) << U32(bz))
                x = grp[a] | grp[z]
                x[wa] &= ~(U32(1) << U32(ba))
                grp[a] = x
                grp[z] = 0
                alive[b, z] = 0
    return words, alive


def fold_design(words, alive, instr, mutation=None):
    """bitset_fold_launch's dispatch: nothing for B, P or W = 0; narrow for
    G <= 32 and W <= 8; wide otherwise."""
    B, G, W = words.shape
    if B == 0 or W == 0 or instr.shape[1] == 0:
        return words.copy(), alive.copy()
    if G <= NARROW_MAX_G and W <= NARROW_MAX_W:
        return narrow_fold(words, alive, instr, mutation)
    return wide_fold(words, alive, instr)


def _words(B, G, W, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(B, G, W), dtype=np.uint64)
    words = words.astype(U32)
    if W:
        words[:, 0, 0] = U32(0xFFFFFFFF)  # bit 31 set
    return words


def fold_instr(B, G, W, P, seed, kind):
    """Instruction slabs. "disjoint": the merge round's (disjoint rows,
    member columns sharing 32-bit words and bit 31, one pair with wa ==
    wz, every eighth row padding); "sparse": the resident path's, where
    most groups hold no valid row; "chained": rows and columns drawn with
    repeats (a == z and ca == cz included), so order matters; "invalid":
    all padding."""
    rng = np.random.default_rng(seed)
    instr = np.zeros((B, P, 8), dtype=np.int32)
    for b in range(B):
        if kind == "chained":
            rows = rng.integers(0, G, size=2 * P)
            cols = rng.integers(0, W * 32, size=2 * P)
            cols[:2] = [31, 63 if W > 1 else 30]
        else:
            rows = rng.permutation(max(G, 2 * P))[: 2 * P] % G
            cols = rng.permutation(W * 32)[: 2 * P] if 2 * P <= W * 32 else \
                rng.integers(0, W * 32, size=2 * P)
            cols[:4] = [31, 30, 63 if W > 1 else 29, 0][: min(4, 2 * P)]
        for p in range(P):
            ca, cz = int(cols[2 * p]), int(cols[2 * p + 1])
            instr[b, p] = [rows[2 * p], rows[2 * p + 1], ca >> 5, ca & 31,
                           cz >> 5, cz & 31, 1, 0]
        if kind == "disjoint":
            instr[b, 7::8, 6] = 0
        elif kind == "sparse" and rng.random() < 0.85:
            instr[b, :, 6] = 0
        elif kind == "sparse":
            instr[b, rng.integers(1, P + 1):, 6] = 0
    if kind == "invalid":
        instr[..., 6] = rng.integers(-2, 1, size=(B, P))
    return instr


def _pallas_fold(words, alive, instr):
    out_w, out_a = words.copy(), alive.copy()
    for b in range(words.shape[0]):
        wb, wa = bitset_fold_kernel(jnp.asarray(words[b]),
                                    jnp.asarray(alive[b][:, None]),
                                    jnp.asarray(instr[b]), interpret=True)
        out_w[b], out_a[b] = np.asarray(wb), np.asarray(wa)[:, 0]
    return out_w, out_a


def _plain_fold(words, alive, instr):
    bits = torch.from_numpy(words.copy().view(np.int32))
    al = torch.from_numpy(alive.copy())
    fold_ref.fold_pairs(bits, al, torch.from_numpy(instr))
    return bits.numpy().view(U32), al.numpy()


FOLD_DESIGN_CASES = [
    # (B, G, W, P, kind): `test_torch_bitset_fold.FOLD_CASES`' shapes; the
    # main path's G = 8 and 16 at W = 2 with P = 4 and 8, most groups
    # without a pair; the regime edges G = 32/33 and W = 8/9; P = 1; more
    # rows than a segment (several chunks); chains where order matters;
    # all-invalid slabs; G = 1 and 3 (padding lanes)
    (2, 8, 2, 4, "disjoint"),
    (3, 16, 5, 8, "disjoint"),
    (2, 128, 5, 64, "disjoint"),
    (4, 32, 1, 8, "disjoint"),
    (6, 8, 2, 4, "sparse"),
    (5, 16, 2, 8, "sparse"),
    (3, 32, 8, 16, "disjoint"),
    (2, 32, 9, 16, "disjoint"),
    (2, 33, 2, 16, "disjoint"),
    (5, 8, 2, 1, "disjoint"),
    (3, 4, 3, 9, "chained"),
    (3, 8, 2, 6, "chained"),
    (2, 40, 3, 20, "chained"),
    (3, 16, 2, 8, "invalid"),
    (2, 1, 1, 2, "chained"),
    (3, 3, 4, 2, "disjoint"),
]


@pytest.mark.parametrize("B,G,W,P,kind", FOLD_DESIGN_CASES)
def test_fold_design_matches_pallas(B, G, W, P, kind):
    words = _words(B, G, W, seed=B * G + W)
    alive = np.ones((B, G), dtype=np.int8)
    alive[:, ::5] = 0
    instr = fold_instr(B, G, W, P, seed=G + P, kind=kind)
    got_w, got_a = fold_design(words, alive, instr)
    want_w, want_a = _pallas_fold(words, alive, instr)
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_a, want_a)


@pytest.mark.parametrize("B,G,W,P", [(64, 8, 2, 4), (48, 16, 2, 8),
                                     (40, 16, 8, 8)])
def test_fold_design_matches_plain_at_main_path_batches(B, G, W, P):
    """Many groups a warp and many warps: the ballot skip and the
    warp-uniform slot loop across groups with different valid rows."""
    words = _words(B, G, W, seed=B + G)
    alive = np.ones((B, G), dtype=np.int8)
    instr = fold_instr(B, G, W, P, seed=B, kind="sparse")
    got = fold_design(words, alive, instr)
    want = _plain_fold(words, alive, instr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # groups without a valid row are left exactly as they were
    idle = ~(instr[..., 6] > 0).any(axis=1)
    np.testing.assert_array_equal(got[0][idle], words[idle])


@pytest.mark.parametrize("mutation", ["wrong-lane", "reversed"])
def test_fold_design_catches_its_mutations(mutation):
    """The transcription is not vacuous: row z's words shuffled from
    another lane, or the pairs applied out of order, disagree with the
    Pallas kernel on chained pairs."""
    words = _words(3, 8, 2, seed=5)
    alive = np.ones((3, 8), dtype=np.int8)
    instr = fold_instr(3, 8, 2, 6, seed=14, kind="chained")
    want_w, _ = _pallas_fold(words, alive, instr)
    np.testing.assert_array_equal(fold_design(words, alive, instr)[0], want_w)
    got_w, _ = fold_design(words, alive, instr, mutation=mutation)
    assert not np.array_equal(got_w, want_w)


def test_fold_with_no_word_is_a_no_op():
    words = np.zeros((3, 8, 0), dtype=U32)
    alive = np.ones((3, 8), dtype=np.int8)
    instr = np.zeros((3, 2, 8), dtype=np.int32)
    instr[..., 6] = 1
    got_w, got_a = fold_design(words, alive, instr)
    assert got_w.shape == (3, 8, 0) and np.all(got_a == 1)
    from repro_torch.kernels.bitset_fold import kernel

    bits, al = torch.zeros((3, 8, 0), dtype=torch.int32), torch.from_numpy(
        alive.copy())
    kernel.bitset_fold(bits, al, torch.from_numpy(instr))
    assert torch.equal(al, torch.ones((3, 8), dtype=torch.int8))


# -------------------------------------------------------------- histogram
def hist_design(ids, S, offset=0, mutation=None):
    """segment_histogram_launch and its kernel. ``offset``: the ids' base
    in 4-byte words past a 16-byte boundary (the first (4 - offset) % 4
    ids, at most E, count one by one). A warp takes one 128-id span a
    step; lane l holds span positions 4l..4l+3. Which warp takes which
    span does not change the counts (global atomics), so spans are taken
    all at once. ``mutation``: "inclusive-next" ends a lane's last run at
    the lane's own first head; "no-forced-head" lets the span's first id
    continue a run from lane 0's own last id (what `__shfl_up_sync`
    returns to lane 0)."""
    ids = np.asarray(ids, dtype=np.int64)
    E = ids.size
    out = np.zeros(S, dtype=np.int64)
    if E == 0 or S == 0:
        return out.astype(np.int32)
    head = min((4 - offset) % 4, E)

    def add(bins, x, n):
        ok = (x >= 0) & (x < S)
        np.add.at(bins, x[ok], n[ok])

    add(out, ids[:head], np.ones(head, dtype=np.int64))
    body = ids[head:]
    n = body.size
    spans = -(-n // SPAN)
    x = np.full(spans * SPAN, -1, dtype=np.int64)
    x[:n] = body
    x = x.reshape(spans, 32, 4)
    # run heads; lane 0's shfl_up returns its own x[3]
    before = np.concatenate([x[:, :1, 3], x[:, :-1, 3]], axis=1)
    head0 = x[:, :, 0] != before
    if mutation != "no-forced-head":
        head0[:, 0] = True
    heads = np.stack([head0, x[:, :, 1] != x[:, :, 0],
                      x[:, :, 2] != x[:, :, 1], x[:, :, 3] != x[:, :, 2]],
                     axis=2)
    pos = np.arange(32)[:, None] * 4 + np.arange(4)[None, :]
    first = np.where(heads, pos, SPAN).min(axis=2)  # (spans, 32)
    incl = np.minimum.accumulate(first[:, ::-1], axis=1)[:, ::-1]
    if mutation == "inclusive-next":
        nxt = incl
    else:
        nxt = np.concatenate([incl[:, 1:], np.full((spans, 1), SPAN)], axis=1)
    end = np.broadcast_to(nxt[:, :, None], heads.shape).copy()
    for j in (2, 1, 0):  # a head's run ends at the next head in the lane
        later = np.where(heads[:, :, j + 1], pos[:, j + 1], end[:, :, j + 1])
        end[:, :, j] = later
    length = end - pos
    sp, ln, j = np.nonzero(heads)
    add(out, x[sp, ln, j], length[sp, ln, j])  # one atomic a run
    return out.astype(np.int32)


def _runs(E, S, seed, mean_run=6):
    """Main-path-like ids: runs of equal state ids in edge order (run
    lengths geometric with mean ``mean_run``), over the first three
    quarters, then -1 padding to the end."""
    rng = np.random.default_rng(seed)
    lens = rng.geometric(1 / mean_run, size=max(E, 1))
    ids = np.repeat(rng.integers(0, S, size=lens.size), lens)[: E * 3 // 4]
    return np.concatenate([ids, np.full(E - ids.size, -1)]).astype(np.int32)


def _ids(E, S, seed, pad=0.2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(S, 1), size=E).astype(np.int32)
    ids[rng.random(E) < pad] = -1
    return ids


def _hist_input(E, S, kind, seed):
    if kind == "random":
        return _ids(E, S, seed)
    if kind == "runs":
        return _runs(E, S, seed)
    if kind == "one-run":
        return np.full(E, S - 1, dtype=np.int32)
    if kind == "all-pad":
        return np.full(E, -1, dtype=np.int32)
    # "outside": ids past S and below -1 beside valid ones
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 2 * S + 2, size=E).astype(np.int32)


HIST_DESIGN_CASES = [
    # (E, S, kind, offset): `test_torch_kernels.HIST_CASES`' shapes; runs
    # of equal ids (the emission DP's edge order); one run over all; all
    # -1; ids >= S and < -1; E not a multiple of 4 and misaligned bases; a
    # single bin; E below 4; many ids into few bins
    (0, 5, "random", 0),
    (1000, 700, "random", 0),
    (3000, 2000, "random", 1),
    (257, 40, "random", 3),
    (64, 1500, "random", 2),
    (4096, 512, "runs", 0),
    (5003, 300, "runs", 1),
    (777, 256, "one-run", 2),
    (515, 64, "all-pad", 3),
    (1030, 50, "outside", 1),
    (1001, 1, "random", 0),
    (3, 4, "random", 3),
    (4099, 8, "runs", 2),
    (20000, 600, "runs", 0),
    (20001, 600, "random", 3),
    (2 * 16 * 1024, 1024, "random", 0),
]


@pytest.mark.parametrize("E,S,kind,offset", HIST_DESIGN_CASES)
def test_hist_design_matches_pallas(E, S, kind, offset):
    ids = _hist_input(E, S, kind, seed=E + S)
    got = hist_design(ids, S, offset=offset)
    want = np.asarray(segment_histogram_kernel(jnp.asarray(ids), S,
                                               interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, hist_ref.segment_histogram(torch.from_numpy(ids), S).numpy())


@pytest.mark.parametrize("E,S,kind,offset", [
    # the batched main path's seven calls on caveman 1.1M (E, S padded to
    # powers of two), in its id order; then the largest two on random
    # ids, ids outside [0, S), one run and all padding
    (1 << 21, 1 << 17, "runs", 0), (1 << 18, 1 << 18, "runs", 0),
    (1 << 15, 1 << 16, "runs", 0), (1 << 14, 1 << 15, "runs", 0),
    (1 << 13, 1 << 14, "runs", 0), (512, 1024, "runs", 0),
    (256, 256, "runs", 0), (1 << 21, 1 << 17, "random", 1),
    (1 << 18, 1 << 18, "outside", 2), (1 << 15, 1 << 16, "one-run", 3),
    (1 << 14, 1 << 15, "all-pad", 0)])
def test_hist_design_matches_plain_at_main_path_sizes(E, S, kind, offset):
    """At the main path's sizes (too large for the Pallas kernel in
    interpret mode), the transcription equals the plain version and
    `np.bincount` over the ids in [0, S)."""
    ids = _hist_input(E, S, kind, seed=E + S)
    got = hist_design(ids, S, offset=offset)
    np.testing.assert_array_equal(
        got, hist_ref.segment_histogram(torch.from_numpy(ids), S).numpy())
    ok = ids[(ids >= 0) & (ids < S)]
    np.testing.assert_array_equal(got, np.bincount(ok, minlength=S))


@pytest.mark.parametrize("mutation", ["inclusive-next", "no-forced-head"])
def test_hist_design_catches_its_mutations(mutation):
    """The transcription is not vacuous: a run ended at the lane's own
    first head, or a span's first id left to continue lane 0's last run,
    disagree with the Pallas kernel on runs of equal ids."""
    ids = _hist_input(4096, 512, "runs", seed=7)
    ids[:130] = 5  # a run across lanes and into the next span
    want = np.asarray(segment_histogram_kernel(jnp.asarray(ids), 512,
                                               interpret=True))
    np.testing.assert_array_equal(hist_design(ids, 512), want)
    assert not np.array_equal(hist_design(ids, 512, mutation=mutation), want)


def test_recorder_keeps_each_fold_call_as_handed():
    """`chip_smoke.CallRecorder(keep_fold=True)`, through which
    `rank_count_bench.py --kernels fold_hist` captures the resident path's
    fold calls for its replay, keeps each call's inputs from before the
    call folds them in place (the fold is idempotent, so a copy taken
    after it would fold to itself), and `fold_calls_by_shape` sums each
    shape's pairs a group to its valid pairs."""
    import importlib.util
    from pathlib import Path

    import repro_torch
    from repro_torch.graphs import generators as PG

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    recorder = CS.CallRecorder(keep_fold=True)
    try:
        repro_torch.SummarizerEngine(backend="resident", T=3,
                                     device="cpu").merge_forest(
            PG.caveman(120, 11, 0.03, seed=0))
    finally:
        recorder.close()
    assert recorder.fold and len(recorder.fold_inputs) == len(recorder.fold)
    for (bits, alive, instr), (shape, n_valid, _) in zip(
            recorder.fold_inputs, recorder.fold):
        assert tuple(bits.shape) + (instr.shape[1],) == tuple(shape)
        assert int((instr[..., 6] > 0).sum()) == n_valid
        b, a = bits.clone(), alive.clone()
        fold_ref.fold_pairs(b, a, instr)
        assert (not (torch.equal(b, bits) and torch.equal(a, alive))) == (
            n_valid > 0)
    by_shape = CS.fold_calls_by_shape(recorder.fold, recorder.fold_groups)
    assert sum(r["calls"] for r in by_shape) == len(recorder.fold)
    for r in by_shape:
        per = r["pairs_per_group"]
        assert len(per) == r["shape"][3]
        assert sum(per) == r["groups_with_pairs"]
        assert sum((k + 1) * n for k, n in enumerate(per)) == r["valid_pairs"]
