"""The port's graph substrate, candidate generation and summary structures
against the JAX package's, and summaries carried between the two packages
as plain arrays (`repro_torch.interop`)."""
import numpy as np
import pytest

import repro.core as ref_core
from repro.core import minhash as ref_minhash
from repro.core.summary import Summary as RefSummary
from repro.core.summary_ir import SummaryIR as RefIR
from repro.core.summary_ir import pack_for_serving as ref_pack
from repro.graphs import Graph as RefGraph
from repro.graphs import generators as RG
import repro_torch
from repro_torch import interop
from repro_torch.core import minhash as port_minhash
from repro_torch.core.slugger import SluggerState
from repro_torch.core.summary_ir import SummaryIR as PortIR
from repro_torch.core.summary_ir import pack_for_serving as port_pack
from repro_torch.graphs import Graph as PortGraph
from repro_torch.graphs import generators as PG

GENERATORS = {
    "caveman": lambda m: m.caveman(30, 7, 0.05, seed=4),
    "rmat": lambda m: m.rmat(9, 6, seed=2),
    "er": lambda m: m.erdos_renyi(120, 0.05, seed=7),
    "ba": lambda m: m.barabasi_albert(120, 3, seed=5),
    "hier": lambda m: m.planted_hierarchy((3, 2), 5, (0.02, 0.3, 0.9),
                                          seed=3),
    "star": lambda m: m.star_of_cliques(5, 9, seed=1),
    "serving_smoke": lambda m: m.SERVING_GRAPHS["smoke"](),
}


def _same_csr(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.dtype == b.indices.dtype
    assert a.indptr.dtype == b.indptr.dtype


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_build_the_same_csr(name):
    _same_csr(GENERATORS[name](RG), GENERATORS[name](PG))


def test_from_edges_cleans_like_the_reference():
    rng = np.random.default_rng(0)
    dirty = rng.integers(0, 40, size=(300, 2))
    dirty[:10, 1] = dirty[:10, 0]  # self-loops
    _same_csr(RefGraph.from_edges(40, dirty), PortGraph.from_edges(40, dirty))
    empty = np.zeros((0, 2))
    _same_csr(RefGraph.from_edges(5, empty), PortGraph.from_edges(5, empty))
    g = PG.caveman(10, 5, 0.1, seed=1)
    assert g.edge_set() == RG.caveman(10, 5, 0.1, seed=1).edge_set()


@pytest.mark.parametrize("sub_seed", [0, 1, 12345678901234567])
def test_u32_shingles_match(sub_seed):
    g_ref, g_port = GENERATORS["ba"](RG), GENERATORS["ba"](PG)
    assert (port_minhash.u32_seed_consts(sub_seed)
            == ref_minhash.u32_seed_consts(sub_seed))
    np.testing.assert_array_equal(port_minhash.node_shingles_u32(g_port, sub_seed),
                                  ref_minhash.node_shingles_u32(g_ref, sub_seed))


@pytest.mark.parametrize("name", ["caveman", "ba", "star", "rmat"])
@pytest.mark.parametrize("max_group", [500, 4])
def test_candidate_groups_match_per_seed_sequence_child(name, max_group):
    g_ref, g_port = GENERATORS[name](RG), GENERATORS[name](PG)
    root_of = np.arange(g_port.n, dtype=np.int64)
    alive = np.arange(g_port.n, dtype=np.int64)
    # spawning advances a SeedSequence, so each package gets its own copy
    # of the same child
    def child():
        return np.random.SeedSequence(9).spawn(3)[2]

    want = ref_minhash.candidate_groups(
        g_ref, root_of, alive, seed=child(), max_group=max_group,
        shingle_fn=ref_minhash.host_shingle_provider(g_ref)(root_of))
    got = port_minhash.candidate_groups(
        g_port, root_of, alive, seed=child(), max_group=max_group,
        shingle_fn=port_minhash.host_shingle_provider(g_port)(root_of))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert max(len(x) for x in got) <= max_group


def test_state_merge_batch_matches_reference():
    from repro.core.slugger import SluggerState as RefState

    g_ref, g_port = GENERATORS["caveman"](RG), GENERATORS["caveman"](PG)
    rs, ps = RefState(g_ref), SluggerState(g_port)
    A, B = np.array([0, 7, 14]), np.array([1, 8, 15])
    np.testing.assert_array_equal(ps.merge_batch(A, B), rs.merge_batch(A, B))
    np.testing.assert_array_equal(ps.merge_batch(np.array([g_port.n]), np.array([2])),
                                  rs.merge_batch(np.array([g_ref.n]), np.array([2])))
    np.testing.assert_array_equal(ps.root_of, rs.root_of)
    for got, want in zip(ps.gather_rows(ps.alive), rs.gather_rows(rs.alive)):
        np.testing.assert_array_equal(got, want)


def _ref_summary():
    g = RG.caveman(20, 6, 0.05, seed=2)
    return g, ref_core.summarize(g, T=4, seed=1)


def test_summary_ir_and_serving_pack_match():
    g, ref = _ref_summary()
    port = interop.summary_from_arrays(ref.n_leaves, ref.parent, ref.edges)
    ri, pi = RefIR(ref.parent, ref.n_leaves), PortIR(port.parent, port.n_leaves)
    for field in ("first", "last", "depth", "order", "child_ptr", "child_ids",
                  "roots"):
        np.testing.assert_array_equal(getattr(pi, field), getattr(ri, field))
    rp, pp = ref_pack(ref), port_pack(port)
    for field in ("parent", "first", "last", "order", "inc_ptr", "inc_eid",
                  "edge_x", "edge_y", "sign_bits", "inc_lo", "inc_hi",
                  "inc_sign"):
        np.testing.assert_array_equal(getattr(pp, field), getattr(rp, field))
    assert pp.max_depth == rp.max_depth
    assert port.stats(g) == ref.stats(g)


def test_port_decompresses_a_reference_summary():
    g_ref, ref = _ref_summary()
    port = interop.summary_from_arrays(ref.n_leaves, ref.parent, ref.edges)
    g_port = interop.graph_from_arrays(g_ref.n, g_ref.indptr, g_ref.indices)
    assert port.validate_lossless(g_port)
    for v in (0, 5, 77):
        np.testing.assert_array_equal(port.neighbors(v), ref.neighbors(v))
        np.testing.assert_array_equal(port.neighbors(v), g_port.neighbors(v))


def test_reference_decompresses_a_port_summary():
    g_port = PG.barabasi_albert(100, 3, seed=4)
    port = repro_torch.summarize(g_port, T=4, seed=2, device="cpu")
    ref = RefSummary(n_leaves=port.n_leaves, parent=port.parent.copy(),
                     edges=port.edges.copy())
    g_ref = RefGraph(g_port.n, g_port.indptr.copy(), g_port.indices.copy())
    assert ref.validate_lossless(g_ref)
    assert port.cost() == ref.cost()


def test_interop_rejects_inconsistent_arrays():
    with pytest.raises(ValueError):
        interop.graph_from_arrays(3, [0, 1, 2], [1, 0])
    with pytest.raises(ValueError):
        interop.summary_from_arrays(5, [-1, -1], np.zeros((0, 3)))
