"""The designs of the port's top-J and interval-count CUDA kernels
(`csrc/jaccard_topj.cu`, `csrc/interval_count.cu`), transcribed to numpy
step by step, against the JAX package's Pallas kernels in interpret mode
and its plain references.

A CUDA kernel cannot run here, so these transcriptions pin each design's
logic where the card cannot be reached: the thread-to-(row, column)
mapping, segment shuffles and rank-by-count of the narrow top-J regime;
the b1 tile's accumulator layout and the warp-wide argmax passes of the
wide regime; the compaction, chunking, direct branch, bitonic network,
wrapping prefix sums and upper-bound searches of the interval count.
`tests/test_torch_cuda.py` holds the kernels themselves to their plain
versions on a card.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from repro.kernels.bitset_fold import ref as jref
from repro.kernels.bitset_fold.kernel import jaccard_topj_kernel
from repro.kernels.interval_expand import ref as jref_interval
from repro.kernels.interval_expand.kernel import interval_count_kernel

KEY_BITS = 15
INT32_MIN = np.int32(-(2**31))
NARROW_THREADS = 256  # jaccard_topj.cu kNarrowThreads
WIDE_WARPS, CHUNK, MAX_G = 8, 32, 128  # kWideWarps, kChunk, kMaxG
IC_THREADS, IC_WARPS = 256, 8  # interval_count.cu kThreads, kWarps
V, WARP_SPAN = 16, 512  # kV elements a thread, kWarpSpan = 32 * kV
MAX_CHUNK, DIRECT_WORK, PROBES_PER_BLOCK = 4096, 64 * 2048, 2048


def _popc(x):
    """Population count of each uint32."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    bits = np.unpackbits(x.view(np.uint8).reshape(*x.shape, 4), axis=-1)
    return bits.sum(axis=-1, dtype=np.int32)


def _combined_key(inter, deg_i, deg_j, ok, j, G):
    """jaccard_topj.cu `combined_key`, elementwise in int64."""
    inter, deg_i, deg_j, j = (np.asarray(a, dtype=np.int64)
                              for a in (inter, deg_i, deg_j, j))
    uni = deg_i + deg_j - inter
    bl = np.array([int(u).bit_length() for u in uni.ravel()],
                  dtype=np.int64).reshape(uni.shape)
    sh = np.maximum(bl - KEY_BITS, 0)
    den = np.maximum(uni >> sh, 1)
    key = ((inter >> sh) << KEY_BITS) // den
    return np.where(ok, (key + 1) * G - 1 - j, -1 - j).astype(np.int64)


def narrow_topj(words, alive, J):
    """The G <= 32 kernel: the group padded to S x S, S = pow2(G); thread t
    of the grid is (group t / S^2, row (t / S) % S, column t % S); a
    shuffle of width S reads lane i of the thread's own segment, i.e.
    thread t - j + i."""
    B, G, W = words.shape
    S = 1 << (G - 1).bit_length()
    assert 2 <= S <= 32 and 32 % S == 0
    total = -(-B * S * S // NARROW_THREADS) * NARROW_THREADS
    t = np.arange(total)
    b, i, j = t // (S * S), t // S % S, t % S
    col = (b < B) & (i < G) & (j < G)
    b = np.where(b < B, b, 0)
    src = t - j + i  # lane i of the segment
    assert np.all(src // 32 == t // 32)  # no segment straddles a warp
    x = np.where(col[:, None], words[b, np.where(col, j, 0)], 0).astype(
        np.uint32)
    y = x[src]
    inter = _popc(x & y).sum(axis=1)
    deg = _popc(x).sum(axis=1)
    deg_i = deg[src]
    ok = col & (j != i) & (alive[b, np.where(col, j, 0)] > 0)
    ck = np.where(col, _combined_key(inter, deg_i, deg, ok, j, G),
                  INT32_MIN)
    rank = np.zeros(total, dtype=np.int64)
    for k in range(S):
        rank += ck[t - j + k] > ck
    w = col & (rank < J)
    slot = ((b * G + i)[w], rank[w])
    writes = np.zeros((B * G, J), dtype=np.int64)
    np.add.at(writes, slot, 1)
    assert np.all(writes == 1)  # every slot written exactly once
    out = np.empty((B * G, J), dtype=np.int32)
    out[slot] = j[w]
    return out.reshape(B, G, J)


def wide_gram(words):
    """The G > 32 kernel's Gram matrix through its b1 tile layout: warp w
    owns rows 16w..16w+15, accumulator nt columns 8nt..8nt+7; each MMA adds
    popcount(A & B) over 8 words (256 bits) of a 32-word chunk; rows past
    G and words past W are staged as zeros. The C fragment of lane L holds
    (16w + L/4 + 8[e >= 2], 8nt + 2(L % 4) + e % 2) in register e."""
    G, W = words.shape
    rows = -(-G // 16) * 16
    staged = np.zeros((rows, -(-W // CHUNK) * CHUNK), dtype=np.uint32)
    staged[:G, :W] = words
    acc = np.zeros((WIDE_WARPS, MAX_G // 8, 32, 4), dtype=np.int64)
    lane = np.arange(32)
    for w in range(WIDE_WARPS):
        strip = 16 * w
        if strip >= G:
            continue
        for c0 in range(0, staged.shape[1], CHUNK):
            for k in range(0, min(CHUNK, W - c0), 8):
                a = staged[strip:strip + 16, c0 + k:c0 + k + 8]
                for nt in range(0, MAX_G // 8, 2):
                    if 8 * nt >= G:
                        break
                    for n in (nt, nt + 1):
                        bm = staged[8 * n:8 * n + 8, c0 + k:c0 + k + 8]
                        blk = _popc(a[:, None, :] & bm[None, :, :]).sum(-1)
                        for e in range(4):
                            r = (lane >> 2) + (8 if e >= 2 else 0)
                            cc = 2 * (lane & 3) + (e & 1)
                            acc[w, n, :, e] += blk[r, cc]
    gram = np.full((G, G), -1, dtype=np.int64)
    for w in range(WIDE_WARPS):
        for n in range(MAX_G // 8):
            for e in range(4):
                r = 16 * w + (lane >> 2) + (8 if e >= 2 else 0)
                cc = 8 * n + 2 * (lane & 3) + (e & 1)
                keep = (r < G) & (cc < G)
                gram[r[keep], cc[keep]] = acc[w, n, keep, e]
    assert np.all(gram >= 0)  # every count written
    return gram


def wide_topj(words, alive, J):
    """The G > 32 kernel: a warp per row, lane L holding the keys of
    columns L, L + 32, ...; J passes of a warp-wide maximum, the lane that
    holds it writing its column and dropping the key."""
    B, G, W = words.shape
    assert 32 < G <= MAX_G
    out = np.empty((B, G, J), dtype=np.int32)
    lane = np.arange(32)
    for b in range(B):
        gram = wide_gram(words[b])
        deg = np.diagonal(gram)
        for i in range(G):
            key = np.full((32, MAX_G // 32), INT32_MIN, dtype=np.int64)
            for q in range(MAX_G // 32):
                j = lane + 32 * q
                m = j < G
                key[m, q] = _combined_key(
                    gram[i, j[m]], deg[i], deg[j[m]],
                    (j[m] != i) & (alive[b, j[m]] > 0), j[m], G)
            for p in range(J):
                best = key.max()
                hit = np.argwhere(key == best)
                assert len(hit) == 1  # the keys are unique
                L, q = hit[0]
                out[b, i, p] = L + 32 * q
                key[L, q] = INT32_MIN
    return out


def topj_design(words, alive, J):
    """jaccard_topj_launch's dispatch on G."""
    return (narrow_topj if words.shape[1] <= 32 else wide_topj)(
        words, alive, J)


def _words(B, G, W, seed, density=0.3, ties=False):
    rng = np.random.default_rng(seed)
    words = np.zeros((B, G, W), dtype=np.uint32)
    for bit in range(32):
        on = rng.random((B, G, W)) < density
        words |= on.astype(np.uint32) << np.uint32(bit)
    words[:, :, 0] |= np.uint32(1 << 31)
    if ties:  # duplicate rows: equal quantized keys across columns
        words[:, 1::3] = words[:, 0:1]
        words[:, 2::5] = 0
    return words


def _alive(B, G, mode, seed):
    rng = np.random.default_rng(seed)
    alive = (rng.random((B, G)) < 0.75).astype(np.int8)
    if mode == "all":
        alive[:] = 1
    if mode == "dead-group":
        alive[0] = 0
    return alive


TOPJ_CASES = [
    # (B, G, W, J, alive, ties): the regime edges G = 2, 31, 32, 33, 128,
    # the main path's G = 8 and 16 at W = 2 with J = G - 1, all-dead
    # groups, and ties of the quantized key across columns
    (5, 2, 2, 1, "some", False),
    (3, 3, 1, 2, "all", True),
    (7, 8, 2, 7, "some", False),
    (4, 8, 2, 7, "dead-group", True),
    (3, 16, 2, 15, "some", True),
    (2, 31, 5, 16, "dead-group", False),
    (2, 32, 9, 31, "some", True),
    (1, 33, 3, 16, "some", False),
    (2, 33, 40, 32, "dead-group", True),
    (1, 100, 2, 16, "some", True),
    (1, 128, 4, 16, "some", False),
    (1, 128, 33, 127, "all", True),
]


@pytest.mark.parametrize("B,G,W,J,mode,ties", TOPJ_CASES)
def test_topj_design_matches_reference(B, G, W, J, mode, ties):
    words = _words(B, G, W, seed=G * 31 + W, ties=ties)
    alive = _alive(B, G, mode, seed=G + J)
    got = topj_design(words, alive, J)
    want = np.asarray(jref.topj_all(jnp.asarray(words), jnp.asarray(alive),
                                    J))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("G,W,J,ties", [(8, 2, 7, True), (31, 3, 30, False),
                                        (33, 2, 32, True)])
def test_topj_design_matches_pallas(G, W, J, ties):
    words = _words(1, G, W, seed=G + 5, ties=ties)
    alive = _alive(1, G, "some", seed=G)
    want = np.asarray(jaccard_topj_kernel(
        jnp.asarray(words[0]), jnp.asarray(alive[0][:, None]), J,
        interpret=True))
    np.testing.assert_array_equal(topj_design(words, alive, J)[0], want)


def test_wide_gram_layout_covers_every_pair():
    words = _words(1, 77, 70, seed=3)[0]
    want = _popc(words[:, None, :] & words[None, :, :]).sum(-1)
    np.testing.assert_array_equal(wide_gram(words), want)


# ------------------------------------------------------------ interval count
def _pow2(n, floor):
    v = floor
    while v < n:
        v <<= 1
    return v


def _bitonic(a):
    """interval_count.cu `bitonic_sort2` on one array of (key << 32 | sign)
    entries (int64, size N a power of two in [512, 4096]), compared by key
    alone, in its three kinds of stage: thread t holds elements
    16t..16t+15 (`regs[t, v]`); a stage (k, j) with j < 16
    compare-exchanges (v, v | j) in registers, ascending where
    (16t + v) & k == 0; with j < 512 element v of lane t meets element v
    of lane t ^ (j / 16), both lanes taking the exchange decided from the
    lower lane's (t & j/16 == 0) entry, ascending where 16t & k == 0; with
    j >= 512 pair q compare-exchanges i = ((q & ~(j - 1)) << 1) |
    (q & (j - 1)) and i + j in shared memory, ascending where
    i & k == 0."""
    N = a.size
    assert N % WARP_SPAN == 0 and N <= MAX_CHUNK
    regs = a.copy().reshape(N // V, V)
    t = np.arange(N // V)[:, None]
    q = np.arange(N // 2)
    k = 2
    while k <= N:
        j = k >> 1
        while j > 0:
            if j >= WARP_SPAN:
                flat = regs.reshape(-1)
                i = ((q & ~(j - 1)) << 1) | (q & (j - 1))
                up = (i & k) == 0
                x, y = flat[i], flat[i + j]
                swap = ((x >> 32) > (y >> 32)) == up
                flat[i], flat[i + j] = np.where(swap, y, x), np.where(swap, x, y)
            elif j >= V:
                m = j // V
                assert m < 32 and np.all((t ^ m) // 32 == t // 32)  # one warp
                other = regs[(t ^ m)[:, 0]]
                lower = (t & m) == 0
                up = (t * V & k) == 0
                lo_key = np.where(lower, regs >> 32, other >> 32)
                hi_key = np.where(lower, other >> 32, regs >> 32)
                regs = np.where((lo_key > hi_key) == up, other, regs)
            else:
                for v in range(V):
                    if v & j:
                        continue
                    up = ((t[:, 0] * V + v) & k) == 0
                    x, y = regs[:, v].copy(), regs[:, v | j].copy()
                    swap = ((x >> 32) > (y >> 32)) == up
                    regs[:, v] = np.where(swap, y, x)
                    regs[:, v | j] = np.where(swap, x, y)
            j >>= 1
        k <<= 1
    return regs.reshape(-1)


def _prefix(vals):
    """interval_count.cu `prefix_signs2`: warp w scans the run
    [w*run, (w+1)*run), run = max(N / 8, 32), in uint32; then each run
    adds the totals of the runs before it."""
    N = vals.size
    run = max(N // IC_WARPS, 32)
    out = np.empty(N, dtype=np.uint32)
    totals = np.zeros(IC_WARPS, dtype=np.uint32)
    for w in range(IC_WARPS):
        if w * run >= N:
            continue
        seg = vals[w * run:(w + 1) * run].astype(np.uint64)
        out[w * run:(w + 1) * run] = (np.cumsum(seg) & 0xFFFFFFFF).astype(
            np.uint32)
        totals[w] = out[(w + 1) * run - 1]
    for w in range(1, IC_WARPS):
        if w * run < N:
            off = np.uint64(totals[:w].astype(np.uint64).sum() & 0xFFFFFFFF)
            seg = out[w * run:(w + 1) * run].astype(np.uint64)
            out[w * run:(w + 1) * run] = ((seg + off) & 0xFFFFFFFF).astype(
                np.uint32)
    return out


def _sum_at_or_below(keys, pref, x):
    """interval_count.cu `sum_at_or_below`: upper bound by binary lifting
    over s = N, N/2, ..., 1, then the inclusive prefix before it."""
    N = keys.size
    at = np.zeros(x.size, dtype=np.int64)
    s = N
    while s > 0:
        probe = np.minimum(at + s - 1, N - 1)
        step = (at + s <= N) & (keys[probe] <= x)
        at = np.where(step, at + s, at)
        s >>= 1
    return np.where(at > 0, pref[np.maximum(at - 1, 0)], 0).astype(np.uint32)


def interval_design(lo, hi, sg, pos, max_chunk=MAX_CHUNK,
                    probes_per_block=PROBES_PER_BLOCK, seed=0):
    """interval_count_split_launch and its kernels, step by step. The
    compacted order is shuffled (the kernel's shared atomics fix none)."""
    rng = np.random.default_rng(seed)
    B, E = lo.shape
    P = pos.shape[1]
    if P == 1:  # interval_probe_kernel
        inside = (lo <= pos) & (pos < hi)
        s = np.where(inside, sg, 0).astype(np.int64).sum(axis=1)
        return (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)[:, None]
    chunk = WARP_SPAN  # pow2(E), within [WARP_SPAN, max_chunk]
    while chunk < E and chunk < max_chunk:
        chunk <<= 1
    out = np.zeros((B, P), dtype=np.int64)
    for b in range(B):
        for p0 in range(0, P, probes_per_block):
            p1 = min(P, p0 + probes_per_block)
            x = pos[b, p0:p1].astype(np.int64)
            for c0 in range(0, max(E, 1), chunk):
                l, h, s = (a[b, c0:c0 + chunk] for a in (lo, hi, sg))
                real = np.flatnonzero((s != 0) & (l < h))
                real = real[rng.permutation(real.size)]
                n = real.size
                sv = s[real].astype(np.int64) & 0xFFFFFFFF
                kl = (l[real].astype(np.int64) << 32) | sv
                kh = (h[real].astype(np.int64) << 32) | sv
                if n * (p1 - p0) <= DIRECT_WORK:
                    inside = (((kl >> 32)[None, :] <= x[:, None])
                              & (x[:, None] < (kh >> 32)[None, :]))
                    acc = np.where(inside, sv[None, :], 0).sum(axis=1)
                else:
                    N = _pow2(n, WARP_SPAN)
                    assert N <= chunk
                    pad = np.full(N - n, (2**31 - 1) << 32, dtype=np.int64)
                    sl = _bitonic(np.concatenate([kl, pad]))
                    sh = _bitonic(np.concatenate([kh, pad]))
                    acc = (_sum_at_or_below(sl >> 32,
                                            _prefix(sl & 0xFFFFFFFF), x)
                           .astype(np.int64)
                           - _sum_at_or_below(sh >> 32,
                                              _prefix(sh & 0xFFFFFFFF), x))
                out[b, p0:p1] = (out[b, p0:p1] + acc) & 0xFFFFFFFF
    return out.astype(np.uint32).view(np.int32)


def _interval_input(B, E, P, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "serving":  # 0-padded slots, probes the sorted boundaries
        lo = np.zeros((B, E), dtype=np.int32)
        hi = np.zeros((B, E), dtype=np.int32)
        sg = np.zeros((B, E), dtype=np.int32)
        n = rng.integers(0, min(E, 6) + 1, size=B)
        n[0] = E  # the hub row
        for b in range(B):
            lo[b, :n[b]] = rng.integers(0, 500, size=n[b])
            hi[b, :n[b]] = lo[b, :n[b]] + rng.integers(1, 60, size=n[b])
            sg[b, :n[b]] = rng.choice([-1, 1], size=n[b])
        pos = np.sort(np.concatenate([lo, hi], axis=1), axis=1)
        return lo, hi, sg, pos
    lo = rng.integers(-60, 60, size=(B, E)).astype(np.int32)
    hi = (lo + rng.integers(-20, 30, size=(B, E))).astype(np.int32)
    sg = rng.choice([-3, -1, 0, 1, 3], size=(B, E)).astype(np.int32)
    lo[:, ::7] = hi[:, ::7]  # lo == hi
    if kind == "wrap":  # sums past int32 in both directions
        sg = rng.choice([2**30 + 1, -(2**31), 2**31 - 1],
                        size=(B, E)).astype(np.int32)
        lo, hi = np.minimum(lo, -50), np.maximum(hi, 50)
    pos = rng.integers(-80, 90, size=(B, P)).astype(np.int32)
    pos[:, 1::4] = pos[:, 0:1]  # duplicate positions
    return lo, hi, sg, pos


def _interval_reference(lo, hi, sg, pos):
    inside = (lo[:, :, None] <= pos[:, None, :]) & (
        pos[:, None, :] < hi[:, :, None])
    s = np.where(inside, sg[:, :, None], 0).astype(np.int64).sum(axis=1)
    return (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


INTERVAL_CASES = [
    # (B, E, P, kind, max_chunk, probes_per_block): lo > hi, lo == hi,
    # negative and duplicate positions, signs of ±3 and 0, int32 wrap,
    # E = 0, P = 1, rows past the direct branch, several chunks, several
    # probe runs, serving's layout with one hub row
    (4, 12, 9, "mixed", MAX_CHUNK, PROBES_PER_BLOCK),
    (3, 90, 40, "mixed", MAX_CHUNK, PROBES_PER_BLOCK),
    (3, 90, 40, "mixed", 512, 16),
    (2, 1300, 70, "mixed", 512, 33),
    (3, 60, 25, "wrap", MAX_CHUNK, PROBES_PER_BLOCK),
    (2, 1100, 31, "wrap", 512, 7),
    (3, 0, 6, "mixed", MAX_CHUNK, PROBES_PER_BLOCK),
    (5, 40, 1, "mixed", MAX_CHUNK, PROBES_PER_BLOCK),
    (4, 64, 128, "serving", MAX_CHUNK, 48),
    (3, 16, 32, "serving", MAX_CHUNK, PROBES_PER_BLOCK),
    (2, 700, 1400, "serving", MAX_CHUNK, 512),
]


@pytest.mark.parametrize("B,E,P,kind,max_chunk,ppb", INTERVAL_CASES)
def test_interval_design_matches_pallas(B, E, P, kind, max_chunk, ppb):
    lo, hi, sg, pos = _interval_input(B, E, P, seed=B * E + P, kind=kind)
    got = interval_design(lo, hi, sg, pos, max_chunk=max_chunk,
                          probes_per_block=ppb, seed=E)
    want = np.asarray(interval_count_kernel(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(sg), jnp.asarray(pos),
        block_p=16, block_e=32, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _interval_reference(lo, hi, sg, pos))
    np.testing.assert_array_equal(
        got, np.asarray(jref_interval.interval_counts(lo, hi, sg, pos)))


def test_interval_identity_needs_lo_below_hi():
    """Why compaction drops lo >= hi: by [lo <= x] - [hi <= x] such an
    interval would count -sign on [hi, lo)."""
    lo, hi, sg = np.array([[9]]), np.array([[3]]), np.array([[1]])
    x = np.arange(0, 12)
    naive = (lo[0, 0] <= x).astype(int) - (hi[0, 0] <= x).astype(int)
    assert naive[5] == -1
    pos = np.tile(x, (1, 1)).astype(np.int32)
    got = interval_design(lo.astype(np.int32), hi.astype(np.int32),
                          sg.astype(np.int32), pos)
    np.testing.assert_array_equal(got, np.zeros((1, 12), dtype=np.int32))


def test_bitonic_and_search_steps():
    rng = np.random.default_rng(0)
    for N in (512, 1024, 4096):
        a = rng.integers(-(2**62), 2**62, size=N)
        # half the keys from a handful of values, each with its own sign
        a[: N // 2] = (rng.integers(-4, 4, size=N // 2) << 32) | (
            a[: N // 2] & 0xFFFFFFFF)
        got = _bitonic(a)
        np.testing.assert_array_equal(got >> 32, np.sort(a >> 32))
        np.testing.assert_array_equal(np.sort(got), np.sort(a))  # a permutation
        keys = np.sort(rng.integers(-5, 5, size=N))
        pref = np.arange(1, N + 1, dtype=np.uint32)
        x = np.arange(-7, 8)
        want = np.searchsorted(keys, x, side="right").astype(np.uint32)
        np.testing.assert_array_equal(_sum_at_or_below(keys, pref, x), want)
