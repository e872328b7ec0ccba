"""The port's `summarize` against the JAX package's, end to end.

Both packages build the same graph from the same seeded generator and
summarize it with the same settings; the port runs on the CPU
(``device="cpu"``: the kernels' plain versions), the reference runs its
Pallas kernels in interpret mode. ``parent`` and ``edges`` must be equal bit
for bit, and the port's summary must decompress to the input graph; the
port's resident summary must also equal the reference's host oracle
(``backend="numpy"``). The
inputs reuse the engine edge cases of `tests/test_engine_partitioned.py`
and `tests/test_merge_engines.py`.
"""
import numpy as np
import pytest

import repro.core as ref_core
from repro.graphs import Graph as RefGraph
from repro.graphs import generators as RG
import repro_torch
from repro_torch.graphs import Graph as PortGraph
from repro_torch.graphs import generators as PG


def _clique_edges(n):
    return np.array([(u, v) for u in range(n) for v in range(u + 1, n)],
                    dtype=np.int64).reshape(-1, 2)


# name -> (reference graph, port graph), each built by its own package
GRAPHS = {
    "caveman": lambda m: m.caveman(40, 8, 0.05, seed=0),
    "caveman13": lambda m: m.caveman(14, 6, 0.05, seed=13),
    "ba": lambda m: m.barabasi_albert(150, 3, seed=12),
    "er": lambda m: m.erdos_renyi(150, 0.04, seed=11),
    "hier": lambda m: m.planted_hierarchy((3, 3), 6, (0.02, 0.3, 0.95),
                                          seed=1),
    "star": lambda m: m.star_of_cliques(6, 7, seed=3),
}
SPECIAL = {
    "edgeless": lambda G: G.from_edges(7, np.zeros((0, 2))),
    "one_node": lambda G: G.from_edges(1, np.zeros((0, 2))),
    "clique12": lambda G: G.from_edges(12, _clique_edges(12)),
}


def _pair(name):
    if name in GRAPHS:
        return GRAPHS[name](RG), GRAPHS[name](PG)
    return SPECIAL[name](RefGraph), SPECIAL[name](PortGraph)


def _assert_same(ref, port, g_port):
    np.testing.assert_array_equal(port.parent, ref.parent)
    np.testing.assert_array_equal(port.edges, ref.edges)
    assert port.n_leaves == ref.n_leaves
    assert port.validate_lossless(g_port)


@pytest.mark.parametrize("prune_steps", [(1, 2, 3), ()], ids=["prune", "noprune"])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("backend", ["numpy", "batched", "resident"])
@pytest.mark.parametrize("name", list(GRAPHS) + list(SPECIAL))
def test_summary_bit_identical(name, backend, T, prune_steps):
    g_ref, g_port = _pair(name)
    ref = ref_core.summarize(g_ref, T=T, seed=3, backend=backend,
                             prune_steps=prune_steps)
    port = repro_torch.summarize(g_port, T=T, seed=3, backend=backend,
                                 prune_steps=prune_steps, device="cpu")
    _assert_same(ref, port, g_port)
    if backend == "resident":
        oracle = ref_core.summarize(g_ref, T=T, seed=3, backend="numpy",
                                    prune_steps=prune_steps)
        _assert_same(oracle, port, g_port)


@pytest.mark.parametrize("backend", ["numpy", "batched"])
def test_group_larger_than_128_takes_the_sequential_path(backend):
    """A 150-clique is one candidate group of 150 > 128 members, swept by
    the sequential `GroupWorkspace` path on every backend."""
    g_ref = RefGraph.from_edges(150, _clique_edges(150))
    g_port = PortGraph.from_edges(150, _clique_edges(150))
    ref = ref_core.summarize(g_ref, T=2, seed=1, backend=backend)
    port = repro_torch.summarize(g_port, T=2, seed=1, backend=backend,
                                 device="cpu")
    _assert_same(ref, port, g_port)
    assert port.cost() < g_port.m


def test_empty_graph():
    g = PortGraph.from_edges(0, np.zeros((0, 2)))
    s = repro_torch.summarize(g, T=3, device="cpu")
    assert s.n_leaves == 0 and s.edges.shape == (0, 3)
    assert s.validate_lossless(g)


@pytest.mark.parametrize("backend", ["numpy", "batched", "loop"])
def test_height_bound_and_loop_backend(backend):
    g_ref, g_port = _pair("caveman13")
    ref = ref_core.summarize(g_ref, T=4, seed=2, backend=backend,
                             height_bound=2)
    port = repro_torch.summarize(g_port, T=4, seed=2, backend=backend,
                                 height_bound=2, device="cpu")
    _assert_same(ref, port, g_port)
    assert max(port.tree_heights(), default=0) <= 2


def test_engine_stats_and_transfer_ledger():
    """The batched engine counts one ranking round per intersection tile,
    and its byte ledger equals the reference's on the same graph."""
    g_ref, g_port = _pair("ba")
    ref_engine = ref_core.SummarizerEngine(backend="batched", T=5, seed=0)
    port_engine = repro_torch.SummarizerEngine(backend="batched", T=5, seed=0,
                                               device="cpu")
    _assert_same(ref_engine.run(g_ref), port_engine.run(g_port), g_port)
    ref_t, port_t = ref_engine.stats["transfer"], port_engine.stats["transfer"]
    assert port_t["rounds"] > 0
    for key in ("bytes_h2d", "bytes_d2h", "rounds"):
        assert port_t[key] == ref_t[key], key
    assert port_engine.stats["merges"] == ref_engine.stats["merges"]
    assert len(port_engine.stats["transfer_iters"]) == 5
