"""The port's resident backend (`core/resident.py`) against the JAX
package's, on the CPU.

The inputs are those of `tests/test_bank_carry.py`,
`tests/test_resident_lifecycle.py` and `tests/test_merge_engines.py`: the
same graph, the same merges and the same `SeedSequence` go through both
packages. The contract pinned here: bank-extracted arenas equal uploaded
ones; one proposal round + fold gives the reference arena's verdicts and
folded state; the bank and the root map stay in lockstep with the host
`SluggerState` every iteration; steady-state uploads are zero; and the
route the bank declines (a graph past its exactness bound) summarizes
identically.
"""
import numpy as np
import pytest
import torch

from repro.core import merging as RM
from repro.core.resident import ResidentBitmapArena as RefArena
from repro.core.slugger import SluggerState as RefState
from repro.graphs import generators as RG
import repro.core as ref_core
import repro_torch
from repro_torch.core import engine as port_engine
from repro_torch.core import merging as PM
from repro_torch.core.resident import (ResidentAdjacencyBank,
                                       ResidentBitmapArena,
                                       ResidentRunContext)
from repro_torch.core.slugger import SluggerState
from repro_torch.core.transfer import TransferCounter
from repro_torch.graphs import Graph as PortGraph
from repro_torch.graphs import generators as PG

CPU = torch.device("cpu")
PHASES = {"init", "upload", "rank", "fold", "carry", "candgen", "bank",
          "extract", "sync"}


def _ctx(g, counter=None, **kw):
    ctx = ResidentRunContext(g, device=CPU,
                             counter=counter or TransferCounter(), **kw)
    assert ctx.bank is not None
    return ctx


def _merge_and_advance(st, ctx, A, Z):
    """One applied batch on the host state and the bank, as the engine's
    exchange stage does it."""
    A = np.asarray(A, dtype=np.int64)
    Z = np.asarray(Z, dtype=np.int64)
    M = st.merge_batch(A, Z)
    ctx.advance([(A, Z, M, st.row_len[M].copy())])
    return M


def _assert_rows_match(st, ctx, roots):
    got = ctx.bank.host_rows(roots, ctx.res_map)
    seg, nbr, cnt = st.gather_rows(np.asarray(roots, dtype=np.int64))
    for i, r in enumerate(roots):
        order = np.argsort(nbr[seg == i], kind="stable")
        np.testing.assert_array_equal(got[i][0], nbr[seg == i][order], str(r))
        np.testing.assert_array_equal(got[i][1], cnt[seg == i][order], str(r))


def _alive_groups(st, k):
    roots = np.unique(st.root_of)
    return [roots[i:i + k] for i in range(0, roots.size, k)
            if roots[i:i + k].size >= 2]


def _buckets(state, groups, G, shell, plans_mod):
    plans = [plans_mod.MergePlan(gr) for gr in groups]
    seeds = np.arange(len(groups), dtype=np.uint64) + 11
    return plans_mod.BatchedGroupWorkspace.build_bucket(
        state, groups, G, plans, seeds, shell=shell)


# ------------------------------------------------------- bank → arena
EXTRACT_CASES = {
    "caveman": (lambda m: m.caveman(4, 6, 0.05, seed=2),
                [([0, 6, 12], [1, 7, 13]), ([2, 18], [3, 19])], 4, 4),
    "ba": (lambda m: m.barabasi_albert(80, 3, seed=7), "pairs8", 6, 8),
    "er": (lambda m: m.erdos_renyi(90, 0.06, seed=8), "pairs8", 6, 8),
    "caveman9": (lambda m: m.caveman(5, 6, 0.1, seed=9), "pairs8", 6, 8),
}


def _extract_setup(name):
    make, batches, k, G = EXTRACT_CASES[name]
    gp, gr = make(PG), make(RG)
    st, rst = SluggerState(gp), RefState(gr)
    if batches == "pairs8":
        pairs = np.unique(st.root_of)[:8]
        batches = [(pairs[0::2], pairs[1::2])]
    ctx = _ctx(gp)
    for A, Z in batches:
        _merge_and_advance(st, ctx, A, Z)
        rst.merge_batch(np.asarray(A, np.int64), np.asarray(Z, np.int64))
    return gp, st, rst, ctx, _alive_groups(st, k), G


@pytest.mark.parametrize("name", list(EXTRACT_CASES))
def test_bank_extraction_equals_upload_and_reference(name):
    _, st, rst, ctx, groups, G = _extract_setup(name)
    full = _buckets(st, groups, G, False, PM)
    shell = _buckets(st, groups, G, True, PM)
    ref_full = _buckets(rst, groups, G, False, RM)
    assert len(full) == len(shell) == len(ref_full)
    for ws_f, ws_s, ws_r in zip(full, shell, ref_full):
        assert ws_s.CNT.shape[2] == 0 and ws_s.bits.shape[2] == 1
        up = ResidentBitmapArena.from_workspace(ws_f, top_j=4, device=CPU,
                                                counter=TransferCounter())
        ex = ResidentBitmapArena.from_bank(ctx.bank, ws_s, ctx.res_map,
                                           top_j=4, counter=TransferCounter())
        ref = RefArena.from_workspace(ws_r, top_j=4)
        assert (ex.Bp, ex.Wp, ex.Rp) == (up.Bp, up.Wp, up.Rp) == (
            ref.Bp, ref.Wp, ref.Rp)
        for arena in (ex, up):
            np.testing.assert_array_equal(arena.host_bits(), ref.host_bits())
            np.testing.assert_array_equal(arena.host_alive(),
                                          ref.host_alive())
            for got, want in zip(arena.host_counts(), ref.host_counts()):
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(arena.state["dirty"].numpy(),
                                          np.asarray(ref._dirty))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jnp_twin", "pallas_interpret"])
@pytest.mark.parametrize("name", ["caveman", "ba"])
def test_one_round_matches_reference_arena(name, use_kernel):
    """One propose + fold over the same chunk: identical verdicts and an
    identical folded state (bitmaps, liveness, counts, dirty queue)."""
    from repro.core.merging import theta_to_p

    _, st, rst, ctx, groups, G = _extract_setup(name)
    ws = _buckets(st, groups, G, True, PM)[0]
    ws_r = _buckets(rst, groups, G, False, RM)[0]
    arena = ResidentBitmapArena.from_bank(ctx.bank, ws, ctx.res_map,
                                          top_j=4, counter=TransferCounter())
    ref = RefArena.from_workspace(ws_r, top_j=4, use_kernel=use_kernel,
                                  interpret=True)
    rb, rr = np.nonzero(ws.alive)
    theta_p = theta_to_p(0.0)
    acc, part = arena.propose_rows(rb, theta_p, None)
    acc_r, part_r = ref.propose_rows(rb, rr, 3, theta_p, None)
    np.testing.assert_array_equal(acc, acc_r)
    np.testing.assert_array_equal(part, part_r)
    assert acc.any()
    # a conflict-free subset: the first accepted proposal of each group
    b, a, z = rb[acc], rr[acc], part[acc]
    first = np.concatenate([[True], b[1:] != b[:-1]])
    b, a, z = b[first], a[first], z[first]
    arena.fold_counts(b, a, z)
    ref.fold_counts(b, a, z)
    np.testing.assert_array_equal(arena.host_bits(), ref.host_bits())
    np.testing.assert_array_equal(arena.host_alive(), ref.host_alive())
    for got, want in zip(arena.host_counts(), ref.host_counts()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(arena.state["dirty"].numpy()[: arena.B],
                                  np.asarray(ref._dirty)[: ref.B])
    np.testing.assert_array_equal(arena.sync_rows(b, a), ref.sync_rows(b, a))


def test_sweep_plans_match_reference_arena():
    """Record-mode sweeps from a bank-extracted port arena and the
    reference's uploaded arena record IDENTICAL merge rounds."""
    gp, gr = PG.caveman(2, 8, 0.0, seed=4), RG.caveman(2, 8, 0.0, seed=4)
    groups = [np.arange(8), np.arange(8) + 8]
    st = SluggerState(gp)
    ctx = _ctx(gp)
    wss = _buckets(st, groups, 8, True, PM)
    for ws in wss:
        arena = ResidentBitmapArena.from_bank(ctx.bank, ws, ctx.res_map,
                                              top_j=4, counter=TransferCounter())
        ws.sweep(0.0, PM.ResidentRankSource(arena), top_j=4)
        assert not arena.state["dirty"].any()  # drained in lockstep
    ref_ws = _buckets(RefState(gr), groups, 8, False, RM)
    for ws in ref_ws:
        ws.sweep(0.0, RM.ResidentRankSource(RefArena.from_workspace(
            ws, top_j=4, use_kernel=True, interpret=True)), top_j=4)
    for pw, pg in zip([p for w in ref_ws for p in w.plans],
                      [p for w in wss for p in w.plans]):
        assert len(pw.rounds) == len(pg.rounds) > 0
        for (aw, zw), (ag, zg) in zip(pw.rounds, pg.rounds):
            np.testing.assert_array_equal(aw, ag)
            np.testing.assert_array_equal(zw, zg)


# ------------------------------------------------------ bank bookkeeping
def test_bank_rows_and_stats_match_state_after_merges():
    g = PG.barabasi_albert(60, 3, seed=5)
    st = SluggerState(g)
    ctx = _ctx(g)
    _merge_and_advance(st, ctx, [0, 2, 4], [1, 3, 5])
    _merge_and_advance(st, ctx, [g.n], [g.n + 1])  # minted parents re-merge
    ids = np.arange(st.n_ids)
    for key, want in (("size", st.size), ("selfc", st.selfcnt),
                      ("nd", st.ndesc), ("hgt", st.height)):
        np.testing.assert_array_equal(ctx.bank.state[key].numpy()[ids],
                                      want[ids], key)
    _assert_rows_match(st, ctx, list(np.unique(st.root_of)[:12]))
    assert (ctx.bank.len_host[[0, 1, 2, 3, 4, 5, g.n, g.n + 1]] == 0).all()
    np.testing.assert_array_equal(ctx.root_of_host(), st.root_of)


def test_bank_regrows_and_still_holds_the_rows():
    """A chain of merges re-appends whole rows every step: the streams
    outgrow their initial 2·m entries and regrow on the device."""
    g = PG.caveman(1, 16, 0.0, seed=0)  # one 16-clique
    st = SluggerState(g)
    ctx = _ctx(g)
    cap0 = ctx.bank.capacity
    cur = 0
    for nxt in range(1, 16):
        cur = int(_merge_and_advance(st, ctx, [cur], [nxt])[0])
        if nxt in (5, 11):
            _assert_rows_match(st, ctx, list(np.unique(st.root_of)))
    assert ctx.bank.capacity > cap0 and ctx.bank.top > cap0
    _assert_rows_match(st, ctx, [cur])
    np.testing.assert_array_equal(ctx.root_of_host(), st.root_of)
    assert ctx.bank.host_rows([cur], ctx.res_map)[0][0].size == 0


def test_zero_merge_batches_are_noops():
    g = PG.caveman(4, 5, 0.0, seed=1)
    counter = TransferCounter()
    ctx = _ctx(g, counter)
    bank = ctx.bank
    top0, cap0 = bank.top, bank.capacity
    ptr0, len0 = bank.ptr_host.copy(), bank.len_host.copy()
    rm0 = ctx.root_of_host()
    before = counter.snapshot()["phases"]
    e = np.zeros(0, np.int64)
    ctx.advance([])
    ctx.advance([(e, e, e, e)])
    assert (bank.top, bank.capacity) == (top0, cap0)
    np.testing.assert_array_equal(bank.ptr_host, ptr0)
    np.testing.assert_array_equal(bank.len_host, len0)
    np.testing.assert_array_equal(ctx.root_of_host(), rm0)
    assert counter.snapshot()["phases"].get("bank", 0) == before.get("bank", 0)
    with pytest.raises(ValueError, match="on_batch"):
        ctx.advance([(np.array([0]), np.array([1]), np.array([g.n]))])


def test_root_map_without_bank_collapses_chains():
    """Without a bank the root map advances from (A, Z, M) triples:
    chained merges within one iteration collapse to the final root."""
    g = PG.caveman(2, 6, 0.0, seed=0)
    st = SluggerState(g)
    ctx = ResidentRunContext(g, device=CPU, counter=TransferCounter(),
                             bank_clamp=0)
    assert ctx.bank is None
    m1 = st.merge_batch(np.array([0]), np.array([1]))
    m2 = st.merge_batch(m1, np.array([2]))
    m3 = st.merge_batch(m2, np.array([3]))
    ctx.advance([(np.array([0]), np.array([1]), m1), (m1, np.array([2]), m2),
                 (m2, np.array([3]), m3)])
    rm = ctx.root_of_host()
    np.testing.assert_array_equal(rm, st.root_of)
    assert rm[0] == rm[1] == rm[2] == rm[3] == int(m3[0])


# ------------------------------------------------------------ engine runs
def test_engine_lockstep_every_iteration():
    """After EVERY exchange stage the device root map equals the host
    ``root_of`` and the bank's rows equal ``gather_rows``."""
    g = PG.caveman(10, 6, 0.05, seed=3)
    checked = []

    def stage_exchange(e, ctx):
        port_engine.SummarizerEngine.stage_exchange(e, ctx)
        rc = e._run_ctx
        np.testing.assert_array_equal(rc.root_of_host(), ctx.state.root_of)
        roots = np.unique(ctx.state.root_of)
        _assert_rows_match(ctx.state, rc, list(roots[:: max(1, roots.size
                                                            // 16)]))
        checked.append(ctx.merges)

    e = repro_torch.SummarizerEngine(backend="resident", T=6, seed=2,
                                     device="cpu",
                                     stages={"exchange": stage_exchange})
    e.merge_forest(g)
    assert len(checked) == 6 and sum(m > 0 for m in checked) >= 3


def test_engine_transfer_phases_and_zero_steady_upload():
    g = PG.caveman(8, 6, 0.05, seed=7)
    e = repro_torch.SummarizerEngine(backend="resident", T=4, seed=1,
                                     device="cpu")
    e.merge_forest(g)
    iters, total = e.stats["transfer_iters"], e.stats["transfer"]
    assert len(iters) == 4
    for key in ("bytes_h2d", "bytes_d2h", "rounds"):
        assert sum(d[key] for d in iters) == total[key], key
    for ph, v in total["phases"].items():
        assert sum(d["phases"].get(ph, 0) for d in iters) == v, ph
    assert set(total["phases"]) <= PHASES
    assert e._run_ctx.bank is not None
    for d in iters[1:]:
        assert d["phases"].get("upload", 0) == 0   # steady state: 0 B
        assert d["phases"].get("init", 0) == 0
    assert total["phases"].get("upload", 0) == 0   # the bank seeds in `init`
    assert total["phases"].get("carry", 0) == 0    # superseded by `bank`
    for ph in ("init", "bank", "extract", "rank", "fold", "candgen"):
        assert total["phases"].get(ph, 0) > 0, ph
    assert iters[0]["phases"]["init"] > 0 and total["rounds"] > 0


def test_engine_edgeless_run_keeps_resident_state_consistent():
    g = PortGraph.from_edges(6, np.zeros((0, 2), dtype=np.int64))
    e = repro_torch.SummarizerEngine(backend="resident", T=3, device="cpu")
    state, _ = e.merge_forest(g)
    assert e.stats["merges"] == 0 and len(e.stats["transfer_iters"]) == 3
    np.testing.assert_array_equal(e._run_ctx.root_of_host(), state.root_of)


def test_groups_dying_mid_run_match_numpy():
    g = PG.caveman(3, 5, 0.02, seed=13)
    want = repro_torch.summarize(g, T=8, seed=6, backend="numpy",
                                 device="cpu")
    e = repro_torch.SummarizerEngine(backend="resident", T=8, seed=6,
                                     device="cpu")
    state, _ = e.merge_forest(g)
    got = repro_torch.summarize(g, T=8, seed=6, backend="resident",
                                device="cpu")
    np.testing.assert_array_equal(want.parent, got.parent)
    np.testing.assert_array_equal(want.edges, got.edges)
    dead = np.flatnonzero(state.forward[: state.n_ids]
                          != np.arange(state.n_ids))
    assert dead.size and (e._run_ctx.bank.len_host[dead] == 0).all()


@pytest.mark.parametrize("name", ["caveman", "ba", "er"])
def test_bank_declined_route_gives_the_same_summary(name, monkeypatch):
    """A bank bound lowered through the constructor argument declines the
    graph: chunks upload host-built workspaces, the root map advances from
    (A, Z, M) triples, and the summary is unchanged."""
    make = {"caveman": lambda m: m.caveman(12, 6, 0.05, seed=0),
            "ba": lambda m: m.barabasi_albert(120, 3, seed=12),
            "er": lambda m: m.erdos_renyi(120, 0.05, seed=11)}[name]
    gp, gr = make(PG), make(RG)
    assert not ResidentAdjacencyBank.fits(gp.n, gp.m * 2, clamp=64)
    assert ResidentRunContext(gp, device=CPU, counter=TransferCounter(),
                              bank_clamp=64).bank is None
    real = port_engine.ResidentRunContext
    monkeypatch.setattr(port_engine, "ResidentRunContext",
                        lambda g, **kw: real(g, bank_clamp=64, **kw))
    e = repro_torch.SummarizerEngine(backend="resident", T=5, seed=3,
                                     device="cpu")
    got = e.run(gp)
    assert e._run_ctx.bank is None
    phases = e.stats["transfer"]["phases"]
    assert phases["upload"] > 0 and phases["carry"] > 0
    assert phases.get("bank", 0) == phases.get("extract", 0) == 0
    want = ref_core.summarize(gr, T=5, seed=3, backend="numpy")
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.validate_lossless(gp)


def test_resident_objects_need_an_explicit_device():
    g = PG.caveman(2, 4, 0.0, seed=0)
    with pytest.raises(TypeError):
        ResidentRunContext(g)
    with pytest.raises(TypeError):
        ResidentAdjacencyBank(g)
