"""The port's flat baselines and host entry points against the JAX package's.

`core/baselines.py` (RANDOMIZED, SWEG, SAGS-like), `core/merging.py`'s
`process_group` / `process_groups`, `core/minhash.py`'s `node_level_min` /
`root_shingles` and `core/encode_dp.py`'s flat costs are host numpy in both
packages: on the same generated graph, each package's own generator, the
summaries' ``parent`` and ``edges`` and every array must be equal bit for
bit. Each package gets its own seed objects (`candidate_groups` advances a
`SeedSequence` it is handed).
"""
import numpy as np
import pytest

from repro.core import baselines as RB
from repro.core import encode_dp as RE
from repro.core import merging as RM
from repro.core import minhash as RH
from repro.core.slugger import SluggerState as RefState
from repro.graphs import generators as RG
from repro_torch.core import baselines as PB
from repro_torch.core import encode_dp as PE
from repro_torch.core import merging as PM
from repro_torch.core import minhash as PH
from repro_torch.core.slugger import SluggerState as PortState
from repro_torch.graphs import generators as PG

GRAPHS = {
    "caveman": lambda m: m.caveman(50, 6, 0.05, seed=0),
    "rmat": lambda m: m.rmat(7, 8, seed=1),
    "hier": lambda m: m.planted_hierarchy((3, 3), 6, (0.02, 0.3, 0.95),
                                          seed=1),
}


def _pair(name):
    return GRAPHS[name](RG), GRAPHS[name](PG)


def _same(ref, port, g_port):
    assert port.n_leaves == ref.n_leaves
    np.testing.assert_array_equal(port.parent, ref.parent)
    np.testing.assert_array_equal(port.edges, ref.edges)
    assert port.validate_lossless(g_port)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("method,kw", [
    ("randomized", {"seed": 0}), ("randomized", {"seed": 3}),
    ("randomized", {"seed": 1, "max_steps": 40}),
    ("sweg", {"T": 5, "seed": 0}), ("sweg", {"T": 20, "seed": 2}),
    ("sweg", {"T": 4, "seed": 1, "max_group": 4}),
    ("sags_like", {"seed": 0}), ("sags_like", {"h": 20, "b": 5, "p": 0.7,
                                               "seed": 4}),
], ids=lambda v: v if isinstance(v, str) else "-".join(
    f"{k}{x}" for k, x in v.items()))
def test_baseline_equals_the_reference(name, method, kw):
    g_ref, g_port = _pair(name)
    ref = getattr(RB, method)(g_ref, **kw)
    port = getattr(PB, method)(g_port, **kw)
    _same(ref, port, g_port)


def test_baselines_export_and_edge_cases():
    import repro_torch.core as C

    assert C.baselines is PB
    edgeless_r = RG.Graph.from_edges(5, np.zeros((0, 2)))
    edgeless_p = PG.Graph.from_edges(5, np.zeros((0, 2)))
    for method in ("randomized", "sweg", "sags_like"):
        _same(getattr(RB, method)(edgeless_r), getattr(PB, method)(
            edgeless_p), edgeless_p)


def test_flat_state_costs_equal_the_reference():
    g_ref, g_port = _pair("caveman")
    ref, port = RB._FlatState(g_ref), PB._FlatState(g_port)
    for a, b in ((0, 1), (0, 7), (3, 4)):
        assert port.saving(a, b) == ref.saving(a, b)
        ref.merge(a, b)
        port.merge(a, b)
        assert port.cost_of(a) == ref.cost_of(a)
        assert port.merged_cost(a, 2) == ref.merged_cost(a, 2)
    np.testing.assert_array_equal(port.root_of, ref.root_of)


@pytest.mark.parametrize("cnt,sa,sb", [(0, 3, 4), (1, 1, 1), (5, 3, 4),
                                       (11, 3, 4), (12, 3, 4), (7, 9, 2)])
def test_flat_costs_equal_the_reference(cnt, sa, sb):
    assert PE.flat_pair_cost(cnt, sa, sb) == RE.flat_pair_cost(cnt, sa, sb)
    assert PE.flat_self_cost(cnt, sa) == RE.flat_self_cost(cnt, sa)


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("seed", [0, 17, 2 ** 40 + 3])
def test_mersenne_shingles_equal_the_reference(name, seed):
    g_ref, g_port = _pair(name)
    np.testing.assert_array_equal(PH.node_level_min(g_port, seed),
                                  RH.node_level_min(g_ref, seed))
    root_of = np.random.default_rng(seed % 97).integers(
        0, g_port.n // 3, size=g_port.n)
    for n_ids in (None, g_port.n):
        np.testing.assert_array_equal(
            PH.root_shingles(g_port, root_of, seed, n_ids),
            RH.root_shingles(g_ref, root_of, seed, n_ids))


def _forest(g, state_cls, mod, groups_fn, backend, T=5, seed=3, **kw):
    """Merge ``T`` iterations of `candidate_groups` through the package's
    entry point: `process_group` a group at a time (``"loop"``), else
    `process_groups`."""
    state = state_cls(g)
    rng = np.random.default_rng(seed)
    for t in range(1, T + 1):
        theta = 0.0 if t == T else 1.0 / (1 + t)
        groups = groups_fn(state, seed * 7919 + t)
        if backend == "loop":
            for grp in groups:
                mod.process_group(state, grp, theta, rng)
        else:
            mod.process_groups(state, groups, theta, rng, backend=backend,
                               **kw)
    return state


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("backend", ["loop", "numpy", "batched"])
def test_merge_entry_points_equal_the_reference(name, backend):
    g_ref, g_port = _pair(name)

    def ref_groups(state, s):
        return RH.candidate_groups(g_ref, state.root_of, state.alive, seed=s,
                                   max_group=500)

    def port_groups(state, s):
        root_of = state.root_of
        return PH.candidate_groups(
            g_port, root_of, state.alive, s,
            lambda sub, n: PH.root_shingles(g_port, root_of, sub, n))

    kw = {"device": "cpu"} if backend != "loop" else {}
    ref = _forest(g_ref, RefState, RM, ref_groups, backend)
    port = _forest(g_port, PortState, PM, port_groups, backend, **kw)
    np.testing.assert_array_equal(port.root_of, ref.root_of)
    np.testing.assert_array_equal(port.parent[:port.n_ids],
                                  ref.parent[:ref.n_ids])
    assert port.n_ids == ref.n_ids


def test_process_group_records_into_a_plan_and_leaves_the_state():
    g_ref, g_port = _pair("caveman")
    ref, port = RefState(g_ref), PortState(g_port)
    grp = np.arange(12)
    ref_plan, port_plan = RM.MergePlan(grp), PM.MergePlan(grp)
    n_ref = RM.process_group(ref, grp, 0.0, np.random.default_rng(5),
                             plan=ref_plan)
    n_port = PM.process_group(port, grp, 0.0, np.random.default_rng(5),
                              plan=port_plan)
    assert n_port == n_ref > 0
    assert port.n_ids == g_port.n
    assert len(port_plan.rounds) == len(ref_plan.rounds)
    for (pa, pz), (ra, rz) in zip(port_plan.rounds, ref_plan.rounds):
        np.testing.assert_array_equal(pa, ra)
        np.testing.assert_array_equal(pz, rz)
