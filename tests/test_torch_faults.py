"""Slice E3 of the port: fault injection (`repro_torch.faults`), the
degradation policy and the chaos driver, against the JAX package.

Fault plans are driven through the same sequences of occurrences in both
packages and must fire at the same ones; `FaultPlan.seeded` picks the same
kill point for every seed. The degradation cases are the reference's
(`tests/test_checkpoint_resume.py`): a fault in the resident proposal
round, in the bank extraction and in the bank advance, a clean run, and
on the batched path a failed intersection dispatch and a failed transfer
inside it — each run by the port on the CPU must give the reference's
``backend="numpy"`` summary bit for bit, with the degradation counted
once. The v1 arena protocol (`topj_rows`, `fold`) is held to the
reference arena on the same workspace.
"""
import contextlib
import threading

import numpy as np
import pytest
import torch

from repro import faults as ref_faults
from repro.core import merging as RM
from repro.core.engine import SummarizerEngine as RefEngine
from repro.core.resident import ResidentBitmapArena as RefArena
from repro.core.slugger import SluggerState as RefState
from repro.core.transfer import TransferCounter as RefCounter
from repro.graphs import generators as RG
from repro_torch import faults
from repro_torch.core import merging as PM
from repro_torch.core.engine import SummarizerEngine
from repro_torch.core.resident import ResidentBitmapArena
from repro_torch.core.slugger import SluggerState
from repro_torch.core.transfer import TransferCounter
from repro_torch.graphs import generators as PG
from repro_torch.kernels.bitset_fold import ops as fold_ops
from repro_torch.launch import chaos

G = PG.caveman(14, 6, 0.05, seed=13)
REF_G = RG.caveman(14, 6, 0.05, seed=13)
T = 4
CPU = torch.device("cpu")


def engine(backend="numpy", T_=T, **kw):
    return SummarizerEngine(backend=backend, T=T_, seed=3, device="cpu",
                            **kw)


def assert_same(a, b):
    np.testing.assert_array_equal(a.parent, b.parent)
    np.testing.assert_array_equal(a.edges, b.edges)


@pytest.fixture(scope="module")
def want():
    """The reference's numpy summary of the degradation cases' graph."""
    return RefEngine(backend="numpy", T=T, seed=3).run(REF_G)


# ------------------------------------------------------------ fault plans
def _fire_trace(mod, plan_kw, calls):
    """Feed ``calls`` ((site, iteration) pairs) to one plan of ``mod``:
    what each occurrence did — None, or the fired (site, iteration, hit)."""
    plan = mod.FaultPlan(**plan_kw)
    out = []
    for site, iteration in calls:
        try:
            plan.note(site, iteration=iteration)
            out.append(None)
        except mod.InjectedFault as e:
            out.append((e.site, e.iteration, e.hit, str(e)))
    return out


PLAN_CASES = {
    "exact_site_and_iteration": (
        {"site": "engine.pack", "iteration": 3},
        [("engine.pack", 2), ("engine.group", 3), ("engine.pack", 3),
         ("engine.pack", 3)]),
    "prefix_hit_3": (
        {"site": "kernel.", "hit": 3},
        [("kernel.bitset_fold.topj", None),
         ("kernel.bitset_jaccard.intersections", None),
         ("transfer.h2d", None), ("kernel.bitset_fold.round", None),
         ("kernel.bitset_fold.round", None)]),
    "prefix_excludes_others": (
        {"site": "kernel.", "hit": 1},
        [("transfer.h2d", None), ("kernelx", None), ("kernel.a", 7)]),
    "times_rearms_hit": (
        {"site": "transfer.d2h", "hit": 2, "times": 3},
        [("transfer.d2h", None)] * 9),
    "iteration_none_matches_any": (
        {"site": "engine.exchange"},
        [("engine.exchange", 4), ("engine.exchange", 5)]),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_fault_plan_fires_where_the_reference_does(case):
    plan_kw, calls = PLAN_CASES[case]
    got = _fire_trace(faults, plan_kw, calls)
    assert got == _fire_trace(ref_faults, plan_kw, calls)
    assert any(r is not None for r in got) or case == "prefix_excludes_others"


@pytest.mark.parametrize("spec", ["engine.merge_round@3#2", "kernel.#5",
                                  "  datasets.fetch ", "engine.pack@1",
                                  "resident.bank.advance#4"])
def test_from_spec_round_trips_like_the_reference(spec):
    got = faults.FaultPlan.from_spec(spec)
    ref = ref_faults.FaultPlan.from_spec(spec)
    assert (got.site, got.iteration, got.hit, got.times) == (
        ref.site, ref.iteration, ref.hit, ref.times)
    assert repr(got) == repr(ref)


def test_seeded_picks_the_reference_kill_point():
    for s in range(64):
        got, ref = faults.FaultPlan.seeded(s), ref_faults.FaultPlan.seeded(s)
        assert (got.site, got.iteration) == (ref.site, ref.iteration), s
    picks = {(faults.FaultPlan.seeded(s).site,
              faults.FaultPlan.seeded(s).iteration) for s in range(32)}
    assert len(picks) > 1
    assert faults.STAGE_SITES == ref_faults.STAGE_SITES
    assert faults.ENV_VAR == ref_faults.ENV_VAR


def test_env_plan_arms_and_disarms(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "engine.pack@1")
    plan = faults.install_env_plan()
    ref_plan = ref_faults.FaultPlan.from_spec("engine.pack@1")
    assert (plan.site, plan.iteration) == (ref_plan.site, ref_plan.iteration)
    try:
        with pytest.raises(faults.InjectedFault) as ei:
            engine().run(G)
        assert (ei.value.site, ei.value.iteration) == ("engine.pack", 1)
    finally:
        monkeypatch.delenv(faults.ENV_VAR)
        assert faults.install_env_plan() is None
    engine().run(G)  # disarmed again


def test_check_is_a_noop_when_nothing_is_armed():
    assert not faults._armed
    faults.check("engine.pack", iteration=1)
    ref_faults.check("engine.pack", iteration=1)
    with faults.inject("engine.group") as plan:
        assert faults._armed and plan.site == "engine.group"
        faults.check("engine.pack", iteration=1)
    assert not faults._armed


def test_plan_fires_exactly_times_under_threads():
    """Eight threads note one plan concurrently: it fires exactly
    ``times`` times, each on a ``hit``-th occurrence."""
    plan = faults.FaultPlan("kernel.", hit=3, times=5)
    fired = []
    lock = threading.Lock()
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(200):
            try:
                plan.note("kernel.bitset_fold.round")
            except faults.InjectedFault as e:
                with lock:
                    fired.append(e.hit)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fired == [3] * 5


# ------------------------------------------------------------ degradation
DEGRADE_CASES = {
    "kernel_round": ("resident", "kernel.bitset_fold.round", {"hit": 2},
                     "kernel.bitset_fold.round", False),
    "bank_extract": ("resident", "resident.bank.extract", {},
                     "resident.bank.extract", True),
    "bank_advance": ("resident", "resident.bank.advance", {},
                     "resident.bank.advance", True),
    "rank_dispatch": ("batched", "kernel.bitset_jaccard.intersections",
                      {"hit": 2}, "rank.dispatch", True),
    "rank_transfer": ("batched", "transfer.h2d", {}, "rank.dispatch", True),
}


@pytest.mark.parametrize("case", list(DEGRADE_CASES))
def test_fault_degrades_to_the_same_summary(case, want):
    backend, site, kw, ledger_site, ctx_dropped = DEGRADE_CASES[case]
    eng = engine(backend)
    mark = faults.DEGRADATIONS.count()
    with faults.inject(site, **kw):
        got = eng.run(G)
    assert eng.stats["degradations"] == 1
    events = faults.DEGRADATIONS.events_since(mark)
    assert [e["site"] for e in events] == [ledger_site]
    assert site in events[0]["detail"]
    assert (eng._run_ctx is None) == ctx_dropped
    assert_same(got, want)
    assert got.validate_lossless(G)


@pytest.mark.parametrize("backend", ["resident", "batched", "numpy"])
def test_clean_run_reports_zero_degradations(backend, want):
    eng = engine(backend)
    got = eng.run(G)
    assert eng.stats["degradations"] == 0
    assert_same(got, want)
    if backend == "resident":
        assert eng._run_ctx is not None and eng._run_ctx.bank is not None


def test_bank_advance_fault_leaves_the_bank_untouched():
    """The advance site fires before the bank or the root map change."""
    from repro_torch.core.resident import ResidentRunContext

    st = SluggerState(G)
    ctx = ResidentRunContext(G, device=CPU, counter=TransferCounter())
    before = ({k: v.clone() for k, v in ctx.bank.state.items()},
              ctx.res_map.clone(), ctx.bank.len_host.copy(), ctx.bank.top)
    A, Z = np.array([0, 6]), np.array([1, 7])
    M = st.merge_batch(A, Z)
    with pytest.raises(faults.InjectedFault):
        with faults.inject("resident.bank.advance"):
            ctx.advance([(A, Z, M, st.row_len[M].copy())])
    for k, v in before[0].items():
        assert torch.equal(ctx.bank.state[k], v), k
    assert torch.equal(ctx.res_map, before[1])
    np.testing.assert_array_equal(ctx.bank.len_host, before[2])
    assert ctx.bank.top == before[3]


def test_plain_retry_failure_raises():
    """A failure after the arena dropped its kernels is not hidden."""
    ws, _ = _workspaces()
    arena = ResidentBitmapArena.from_workspace(ws, top_j=4, device=CPU,
                                               counter=TransferCounter())
    arena.use_kernel = False
    rb, _ = np.nonzero(ws.alive)
    mark = faults.DEGRADATIONS.count()
    with pytest.raises(faults.InjectedFault):
        with faults.inject("kernel.bitset_fold.round"):
            arena.propose_rows(rb, 0, None)
    assert faults.DEGRADATIONS.count() == mark


class _Boom(Exception):
    """A failure that no fault plan raised."""


def _raise(*args, **kwargs):
    raise _Boom("a kernel failed")


def _fail_in_fold_counts_phase3(monkeypatch):
    """`rounds.fold_counts` raises at its third pair-cost call — phase 3,
    after phases 1 and 2 wrote CNT and the row stats in place."""
    from repro_torch.kernels.bitset_fold import rounds

    pair_cost, fold_counts = rounds.pair_cost_c, rounds.fold_counts
    calls = []

    def counted(*args):
        if calls:
            calls[-1] += 1
            if calls[-1] == 3:
                raise _Boom("fold_counts failed after phase 1")
        return pair_cost(*args)

    def fold(*args):
        calls.append(0)
        try:
            return fold_counts(*args)
        finally:
            calls.pop()

    monkeypatch.setattr(rounds, "pair_cost_c", counted)
    monkeypatch.setattr(rounds, "fold_counts", fold)


def _patch(target, name):
    return lambda monkeypatch: monkeypatch.setattr(target, name, _raise)


def _jaccard_ops():
    from repro_torch.kernels.bitset_jaccard import ops
    return ops


def _carry():
    from repro_torch.kernels.bitset_fold import carry
    return carry


REAL_FAILURES = {
    "fold_counts_mid_op": ("resident", _fail_in_fold_counts_phase3),
    "topj_launch": ("resident", _patch(fold_ops, "jaccard_topj")),
    "bank_extract": ("resident", _patch(fold_ops, "extract")),
    "bank_advance": ("resident", _patch(_carry(), "bank_advance")),
    "rank_dispatch": ("batched", _patch(_jaccard_ops(),
                                        "bitset_intersections")),
}


@pytest.mark.parametrize("case", list(REAL_FAILURES))
def test_real_failure_raises_and_records_nothing(case, monkeypatch):
    """Only an injected fault degrades: any other failure of a kernel op,
    a rank dispatch or the bank ends the run — even one part-way through
    an op that wrote the resident state — and nothing is recorded."""
    backend, arm = REAL_FAILURES[case]
    arm(monkeypatch)
    mark = faults.DEGRADATIONS.count()
    with pytest.raises(_Boom):
        engine(backend).run(G)
    assert faults.DEGRADATIONS.count() == mark


def test_round_fault_retries_once_on_the_plain_versions():
    """The arena's retry gives the kernel path's verdicts and state."""
    ws, _ = _workspaces()
    clean, hurt = (ResidentBitmapArena.from_workspace(
        ws, top_j=4, device=CPU, counter=TransferCounter()) for _ in "ab")
    rb, _ = np.nonzero(ws.alive)
    theta_p = PM.theta_to_p(0.0)
    want_v = clean.propose_rows(rb, theta_p, None)
    with faults.inject("kernel.bitset_fold.round"):
        got_v = hurt.propose_rows(rb, theta_p, None)
    assert clean.use_kernel and not hurt.use_kernel
    for g_, w_ in zip(got_v, want_v):
        np.testing.assert_array_equal(g_, w_)
    for k in clean.state:
        assert torch.equal(clean.state[k], hurt.state[k]), k


# --------------------------------------------------------- v1 arena ops
def _workspaces():
    """One batched chunk of the same merged state in both packages."""
    gp, gr = PG.barabasi_albert(80, 3, seed=7), RG.barabasi_albert(80, 3,
                                                                  seed=7)
    st, rst = SluggerState(gp), RefState(gr)
    pairs = np.unique(st.root_of)[:8]
    st.merge_batch(pairs[0::2], pairs[1::2])
    rst.merge_batch(pairs[0::2], pairs[1::2])
    roots = np.unique(st.root_of)
    groups = [roots[i:i + 6] for i in range(0, roots.size, 6)
              if roots[i:i + 6].size >= 2]
    out = []
    for state, mod in ((st, PM), (rst, RM)):
        plans = [mod.MergePlan(g) for g in groups]
        seeds = np.arange(len(groups), dtype=np.uint64) + 11
        out.append(mod.BatchedGroupWorkspace.build_bucket(
            state, groups, 8, plans, seeds)[0])
    return out


@pytest.mark.parametrize("fault", [None, "topj", "fold"])
def test_v1_topj_rows_and_fold_match_reference_arena(fault):
    ws, ws_r = _workspaces()
    counter = TransferCounter()
    arena = ResidentBitmapArena.from_workspace(ws, top_j=4, device=CPU,
                                               counter=counter)
    ref_counter = RefCounter()
    ref = RefArena.from_workspace(ws_r, top_j=4, counter=ref_counter)
    snap, ref_snap = counter.snapshot(), ref_counter.snapshot()
    rb, rr = np.nonzero(ws.alive)
    mark = faults.DEGRADATIONS.count()
    with (faults.inject(f"kernel.bitset_fold.{fault}") if fault
          else contextlib.nullcontext()):
        cand = arena.topj_rows(rb, rr)
        cand_r = ref.topj_rows(rb, rr)
        assert cand.dtype == np.int64 and cand.shape == (rb.size, arena.J)
        np.testing.assert_array_equal(cand, cand_r)
        # a conflict-free subset: each group's first row and its best pick
        first = np.concatenate([[True], rb[1:] != rb[:-1]])
        b, a, z = rb[first], rr[first], cand[first, 0]
        ca, cz = ws.memcol[b, a], ws.memcol[b, z]
        arena.fold(b, a, z, ca, cz)
        ref.fold(b, a, z, ca, cz)
    np.testing.assert_array_equal(arena.host_bits(), ref.host_bits())
    np.testing.assert_array_equal(arena.host_alive(), ref.host_alive())
    assert faults.DEGRADATIONS.count() - mark == (fault is not None)
    assert arena.use_kernel == (fault is None)
    d, d_r = (c.delta_since(s) for c, s in ((counter, snap),
                                           (ref_counter, ref_snap)))
    for key in ("rank", "fold"):
        assert d["phases"][key] == d_r["phases"][key], key
    assert d["rounds"] == d_r["rounds"] == 1


def test_ops_twin_path_equals_kernel_path_on_cpu():
    """``use_kernel=False`` reaches the plain versions directly; on a CPU
    tensor the wrappers take the same plain versions."""
    ws, _ = _workspaces()
    a1, a2 = (ResidentBitmapArena.from_workspace(
        ws, top_j=4, device=CPU, counter=TransferCounter()) for _ in "ab")
    rows = torch.nonzero(a1.state["alive"] > 0)
    assert torch.equal(fold_ops.topj(a1.state, rows, 3, use_kernel=True),
                       fold_ops.topj(a2.state, rows, 3, use_kernel=False))


# ------------------------------------------------------------ chaos driver
def test_chaos_stage_kills_on_cpu(capsys):
    assert chaos.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "5 stage-boundary kills, 5 bit-identical resumes" in out


def test_chaos_kernel_fault_on_cpu(capsys):
    assert chaos.main(["--kernel-fault", "--device", "cpu"]) == 0
    assert "degraded to the plain versions" in capsys.readouterr().out


def test_chaos_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos.main([])
