"""Slice E2 of the port: plan-log checkpoint and resume, against the JAX
package.

The inputs are those of `tests/test_checkpoint_resume.py`; each package
builds its own graph from the same generator and seed. The port is killed
after a stage of iteration ``KILL_AT`` in two ways: by its own
`repro_torch.faults.inject` (the reference's cases, the ``engine.<stage>``
site checked after every stage) and by a ``stages=`` override that raises
at the same point (the override API's cases); the reference is killed with
`repro.faults.inject`. A resume from the newest committed checkpoint must
give the uninterrupted summary bit for bit, on every port backend and
partition count, across backend and partition changes, and across the two
packages in both directions. The reference's resident backend stays out of the
cross-package cases (it jit-compiles per shape on the CPU).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from repro import faults
from repro.core import checkpoint as ref_ckpt
from repro.core import merging as ref_merging
from repro.core.engine import SummarizerEngine as RefEngine
from repro.graphs import generators as RG
from repro_torch import faults as port_faults
from repro_torch.core import checkpoint as ckpt_mod
from repro_torch.core.checkpoint import (CheckpointMismatch,
                                         PlanCheckpointer, graph_fingerprint,
                                         pack_plans, unpack_plans)
from repro_torch.core.engine import STAGE_ORDER, SummarizerEngine
from repro_torch.core.merging import MergePlan
from repro_torch.graphs import generators as PG

G = PG.caveman(14, 6, 0.05, seed=13)
REF_G = RG.caveman(14, 6, 0.05, seed=13)
T = 4
KILL_AT = 2  # iteration the crash fires in (the commit lands after it)
# G merges nothing before iteration 3 (θ = 1/2, 1/3), so its resumes replay
# empty plans; DEEP at T=6 merges 99 and 16 roots in iterations 3 and 4,
# and a crash in iteration 5 replays both
DEEP = PG.caveman(40, 8, 0.05, seed=0)
REF_DEEP = RG.caveman(40, 8, 0.05, seed=0)
T_DEEP = 6
DEEP_KILL = 5


class Crash(RuntimeError):
    pass


def crash_after(stage, iteration):
    """A ``stages=`` override: run ``stage``, then die in ``iteration``."""
    real = getattr(SummarizerEngine, f"stage_{stage}")

    def fn(engine, ctx):
        real(engine, ctx)
        if ctx.t == iteration:
            raise Crash(f"{stage}@{iteration}")

    return {stage: fn}


def engine(backend="numpy", partitions=1, seed=3, T_=T, stages=None,
           workers=None):
    return SummarizerEngine(partitions=partitions, backend=backend, T=T_,
                            seed=seed, stages=stages, workers=workers,
                            device="cpu")


def ref_engine(backend="numpy", partitions=1, seed=3, T_=T):
    return RefEngine(partitions=partitions, backend=backend, T=T_, seed=seed)


def assert_same(a, b):
    np.testing.assert_array_equal(a.parent, b.parent)
    np.testing.assert_array_equal(a.edges, b.edges)


def _copy(ckpt, tag):
    """A copy of a crashed run's checkpoint dir: each resume commits into
    the dir it resumes from, so each reader gets its own."""
    dst = f"{ckpt}-{tag}"
    shutil.copytree(ckpt, dst)
    return dst


@pytest.fixture(scope="module")
def want():
    """The uninterrupted summary; the reference's equals it."""
    s = engine().run(G)
    assert_same(s, ref_engine().run(REF_G))
    assert s.validate_lossless(G)
    return s


# ---------------------------------------------------------------- tentpole
@pytest.mark.parametrize("backend,partitions", [
    ("numpy", 1), ("numpy", 2), ("numpy", 4),
    ("batched", 1), ("batched", 2), ("batched", 4),
    ("resident", 1), ("resident", 2), ("resident", 4),
])
def test_crash_at_every_stage_boundary_resumes_bit_identical(
        backend, partitions, want, tmp_path):
    for stage in STAGE_ORDER:
        ckpt = str(tmp_path / f"ckpt-{stage}")
        with pytest.raises(Crash):
            engine(backend, partitions, stages=crash_after(stage, KILL_AT),
                   workers=2).run(G, checkpoint_dir=ckpt)
        eng = engine(backend, partitions, workers=2)
        got = eng.run(G, checkpoint_dir=ckpt, resume=True)
        assert eng.stats["resumed_from"] == KILL_AT - 1, stage
        assert_same(got, want)


@pytest.mark.parametrize("backend,partitions", [
    ("numpy", 1), ("numpy", 2), ("numpy", 4),
    ("batched", 1), ("batched", 2), ("batched", 4),
    ("resident", 1), ("resident", 2), ("resident", 4),
])
def test_injected_kill_at_every_stage_boundary_resumes_bit_identical(
        backend, partitions, want, tmp_path):
    """The reference's kill-and-resume cases, killed by the port's own
    fault sites."""
    for stage in STAGE_ORDER:
        ckpt = str(tmp_path / f"ckpt-{stage}")
        with pytest.raises(port_faults.InjectedFault) as ei:
            with port_faults.inject(f"engine.{stage}", iteration=KILL_AT):
                engine(backend, partitions, workers=2).run(
                    G, checkpoint_dir=ckpt)
        assert (ei.value.site, ei.value.iteration) == (f"engine.{stage}",
                                                       KILL_AT)
        eng = engine(backend, partitions, workers=2)
        got = eng.run(G, checkpoint_dir=ckpt, resume=True)
        # the commit lands after the iteration's stages: a kill anywhere
        # inside iteration KILL_AT resumes from KILL_AT - 1
        assert eng.stats["resumed_from"] == KILL_AT - 1, stage
        assert eng.stats["degradations"] == 0
        assert_same(got, want)
        assert got.validate_lossless(G)


@pytest.mark.parametrize("writer", ["numpy", "batched"])
@pytest.mark.parametrize("stage", ["pack", "merge_round", "exchange"])
def test_reference_checkpoint_resumes_in_the_port(writer, stage, want,
                                                  tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(faults.InjectedFault):
        with faults.inject(f"engine.{stage}", iteration=KILL_AT + 1):
            ref_engine(writer, 2).run(REF_G, checkpoint_dir=ckpt)
    for backend, partitions in (("numpy", 1), ("batched", 2),
                                ("resident", 4)):
        eng = engine(backend, partitions)
        got = eng.run(G, checkpoint_dir=_copy(ckpt, backend), resume=True)
        assert eng.stats["resumed_from"] == KILL_AT
        assert_same(got, want)


@pytest.mark.parametrize("writer", ["numpy", "batched", "resident"])
def test_port_checkpoint_resumes_in_the_reference(writer, want, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        engine(writer, 4, stages=crash_after("merge_round", KILL_AT + 1),
               workers=4).run(G, checkpoint_dir=ckpt)
    for backend, partitions in (("numpy", 1), ("batched", 2)):
        eng = ref_engine(backend, partitions)
        got = eng.run(REF_G, checkpoint_dir=_copy(ckpt, backend),
                      resume=True)
        assert eng.stats["resumed_from"] == KILL_AT
        assert_same(got, want)
    with open(os.path.join(ckpt, f"it_{KILL_AT:06d}", "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == {"version", "t", "fingerprint", "config",
                             "plan_counts"}
    assert manifest["version"] == ref_ckpt.CKPT_VERSION
    assert manifest["config"]["backend"] == writer
    assert manifest["config"]["partitions"] == 4
    assert set(manifest["config"]) == set(ref_engine()._config())


def test_resume_crosses_backend_and_partition_count(want, tmp_path):
    """Written under numpy/1, resumed under resident/4, batched/2 and
    numpy/2; written under batched/4 (crash at 3), resumed under
    resident/1 — the chip's crash-and-resume path."""
    for backend, partitions in (("resident", 4), ("batched", 2),
                                ("numpy", 2)):
        ckpt = str(tmp_path / f"ckpt-{backend}-{partitions}")
        with pytest.raises(Crash):
            engine(stages=crash_after("merge_round", 3)).run(
                G, checkpoint_dir=ckpt)
        eng = engine(backend, partitions)
        got = eng.run(G, checkpoint_dir=ckpt, resume=True)
        assert eng.stats["resumed_from"] == 2
        assert_same(got, want)
    ckpt = str(tmp_path / "ckpt-chip")
    with pytest.raises(Crash):
        engine("batched", 4, workers=4,
               stages=crash_after("merge_round", 3)).run(
            G, checkpoint_dir=ckpt)
    eng = engine("resident", 1)
    assert_same(eng.run(G, checkpoint_dir=ckpt, resume=True), want)
    assert eng.stats["resumed_from"] == 2


@pytest.fixture(scope="module")
def want_deep():
    s = engine(T_=T_DEEP).run(DEEP)
    assert_same(s, ref_engine(T_=T_DEEP).run(REF_DEEP))
    return s


@pytest.mark.parametrize("writer,reader", [
    (("numpy", 1), ("resident", 2)),
    (("batched", 4), ("resident", 1)),
    (("resident", 2), ("batched", 4)),
    (("resident", 1), ("numpy", 1)),
])
def test_deep_crash_replays_merges_bit_identical(writer, reader, want_deep,
                                                 tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        engine(*writer, T_=T_DEEP, workers=4,
               stages=crash_after("merge_round", DEEP_KILL)).run(
            DEEP, checkpoint_dir=ckpt)
    eng = engine(*reader, T_=T_DEEP, workers=4)
    got = eng.run(DEEP, checkpoint_dir=ckpt, resume=True)
    assert eng.stats["resumed_from"] == DEEP_KILL - 1
    assert_same(got, want_deep)
    full = engine(*reader, T_=T_DEEP)
    full.run(DEEP)
    assert eng.stats["merges"] == full.stats["merges"] > 115


def test_deep_crash_crosses_packages(want_deep, tmp_path):
    ref_dir = str(tmp_path / "ref")
    with pytest.raises(faults.InjectedFault):
        with faults.inject("engine.merge_round", iteration=DEEP_KILL):
            ref_engine("batched", 2, T_=T_DEEP).run(
                REF_DEEP, checkpoint_dir=ref_dir)
    eng = engine("resident", 4, T_=T_DEEP)
    assert_same(eng.run(DEEP, checkpoint_dir=ref_dir, resume=True),
                want_deep)
    assert eng.stats["resumed_from"] == DEEP_KILL - 1
    port_dir = str(tmp_path / "port")
    with pytest.raises(Crash):
        engine("resident", 2, T_=T_DEEP,
               stages=crash_after("exchange", DEEP_KILL)).run(
            DEEP, checkpoint_dir=port_dir)
    eng = ref_engine("numpy", 3, T_=T_DEEP)
    assert_same(eng.run(REF_DEEP, checkpoint_dir=port_dir, resume=True),
                want_deep)
    assert eng.stats["resumed_from"] == DEEP_KILL - 1


def test_resident_resume_rebuilds_the_device_state(tmp_path):
    """Resume replays through the resident run context: at the first
    iteration after the resume its root map equals the host ``root_of``
    and the bank's rows equal ``gather_rows`` — as after an exchange."""
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        engine(T_=T_DEEP, stages=crash_after("exchange", DEEP_KILL)).run(
            DEEP, checkpoint_dir=ckpt)
    seen = []

    def checking_shingle(eng, ctx):
        rc = eng._run_ctx
        np.testing.assert_array_equal(rc.root_of_host(), ctx.state.root_of)
        roots = np.unique(ctx.state.root_of)
        rows = rc.bank.host_rows(roots, rc.res_map)
        seg, nbr, cnt = ctx.state.gather_rows(roots)
        for i in range(roots.size):
            order = np.argsort(nbr[seg == i], kind="stable")
            np.testing.assert_array_equal(rows[i][0], nbr[seg == i][order])
            np.testing.assert_array_equal(rows[i][1], cnt[seg == i][order])
        seen.append(ctx.t)
        SummarizerEngine.stage_shingle(eng, ctx)

    eng = engine("resident", T_=T_DEEP, stages={"shingle": checking_shingle})
    got = eng.run(DEEP, checkpoint_dir=ckpt, resume=True)
    assert eng.stats["resumed_from"] == DEEP_KILL - 1
    assert seen == list(range(DEEP_KILL, T_DEEP + 1))
    assert_same(got, engine("resident", T_=T_DEEP).run(DEEP))


def test_resume_with_no_checkpoint_starts_fresh(want, tmp_path):
    eng = engine()
    got = eng.run(G, checkpoint_dir=str(tmp_path / "empty"), resume=True)
    assert "resumed_from" not in eng.stats
    assert_same(got, want)


def test_resume_of_completed_run_replays_to_the_end(want, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert_same(engine().run(G, checkpoint_dir=ckpt), want)
    eng = engine("resident", 2)
    got = eng.run(G, checkpoint_dir=ckpt, resume=True)
    assert eng.stats["resumed_from"] == T
    assert_same(got, want)


def test_checkpoint_every_commits_less_often_same_result(want, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Crash):
        engine(stages=crash_after("exchange", 3)).run(
            G, checkpoint_dir=ckpt, checkpoint_every=2)
    eng = engine()
    got = eng.run(G, checkpoint_dir=ckpt, resume=True, checkpoint_every=2)
    assert eng.stats["resumed_from"] == 2
    assert_same(got, want)
    assert eng.stats["checkpoint"] > 0.0


# ------------------------------------------------------------- identity
def test_resume_refuses_different_graph(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    engine().run(G, checkpoint_dir=ckpt)
    other = PG.caveman(15, 6, 0.05, seed=14)
    with pytest.raises(CheckpointMismatch, match="fingerprint"):
        engine().run(other, checkpoint_dir=ckpt, resume=True)


@pytest.mark.parametrize("kw,val", [("seed", 99), ("T_", T + 2)])
def test_resume_refuses_decision_config_change(tmp_path, kw, val):
    ckpt = str(tmp_path / "ckpt")
    engine().run(G, checkpoint_dir=ckpt)
    with pytest.raises(CheckpointMismatch, match="config mismatch"):
        engine(**{kw: val}).run(G, checkpoint_dir=ckpt, resume=True)


def test_fingerprint_equals_reference_and_is_graph_sensitive():
    assert graph_fingerprint(G) == ref_ckpt.graph_fingerprint(REF_G)
    assert graph_fingerprint(G) != graph_fingerprint(
        PG.caveman(15, 6, 0.05, seed=14))
    assert ckpt_mod.DECISION_KEYS == ref_ckpt.DECISION_KEYS
    assert ckpt_mod.CKPT_VERSION == ref_ckpt.CKPT_VERSION


# ------------------------------------------------------------- atomicity
def test_half_written_tmp_dir_is_ignored_and_swept(want, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    engine().run(G, checkpoint_dir=ckpt)
    committed = sorted(d for d in os.listdir(ckpt) if not d.endswith(".tmp"))
    torn = os.path.join(ckpt, "it_000099.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write('{"version": 1, "t": 99')  # truncated JSON
    eng = engine()
    got = eng.run(G, checkpoint_dir=ckpt, resume=True)
    assert eng.stats["resumed_from"] == T
    assert not os.path.exists(torn)
    assert_same(got, want)
    assert sorted(d for d in os.listdir(ckpt)
                  if not d.endswith(".tmp")) == committed


def test_gc_keeps_last_two_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    engine().run(G, checkpoint_dir=ckpt)
    assert sorted(os.listdir(ckpt)) == [f"it_{T-1:06d}", f"it_{T:06d}"]


def _random_plans(plan_cls):
    plans = []
    rng = np.random.default_rng(np.random.SeedSequence(7))
    for k in range(5):
        p = plan_cls(rng.integers(0, 100, size=3 + k))
        for r in range(k % 3):
            p.record(rng.integers(0, 50, size=2 + r),
                     rng.integers(50, 99, size=2 + r))
        plans.append(p)
    return plans


def test_pack_plans_round_trip_and_equal_reference():
    plans = _random_plans(MergePlan)
    out = unpack_plans(pack_plans(plans))
    assert len(out) == len(plans)
    for a, b in zip(plans, out):
        np.testing.assert_array_equal(a.members0, b.members0)
        assert len(a.rounds) == len(b.rounds)
        for (aa, az), (ba, bz) in zip(a.rounds, b.rounds):
            np.testing.assert_array_equal(aa, ba)
            np.testing.assert_array_equal(az, bz)
        c = MergePlan.from_state(a.to_state())
        np.testing.assert_array_equal(c.members0, a.members0)
        assert [(x.tolist(), y.tolist()) for x, y in c.rounds] == \
            [(x.tolist(), y.tolist()) for x, y in a.rounds]
    assert unpack_plans(pack_plans([])) == []
    got = pack_plans(plans)
    want = ref_ckpt.pack_plans(_random_plans(ref_merging.MergePlan))
    assert list(got) == list(want) == list(ckpt_mod._FIELDS)
    for field in got:
        assert got[field].dtype == want[field].dtype == np.int64
        np.testing.assert_array_equal(got[field], want[field])


def test_checkpointer_version_gate(tmp_path):
    ckpt = PlanCheckpointer(str(tmp_path))
    fp = graph_fingerprint(G)
    ckpt.save(1, [[MergePlan(np.array([1, 2]))]], fp, {"T": 1})
    d = os.path.join(str(tmp_path), "it_000001")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["version"] = ckpt_mod.CKPT_VERSION + 1
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointMismatch, match="version"):
        PlanCheckpointer(str(tmp_path)).load_latest(fp, {"T": 1})
