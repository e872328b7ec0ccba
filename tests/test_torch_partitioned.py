"""Slice E1 of the port: partitioned graphs, the partition-parallel engine,
the partition-aware emission and pruning, against the JAX package.

Each package builds its own graph from the same seeded generator (the
inputs of `tests/test_partitioned_graph.py` and
`tests/test_engine_partitioned.py`). Shards, streamed ingestion and the
generators must equal the reference's array for array; the engine's
``partitions`` ∈ {1, 2, 4} and ``workers`` ∈ {1, 4} must give bit-identical
summaries on every port backend, and equal the reference's for numpy and
batched (the reference's resident backend jit-compiles per shape on the
CPU, so the port's resident case is held to the port's other backends,
which `tests/test_torch_summarize.py` holds to the reference). The launch
counters count exactly when a wrapper runs on several threads.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import engine as ref_engine_mod
from repro.core import pruning as ref_pruning
from repro.core import slugger as ref_slugger
from repro.graphs import Graph as RefGraph
from repro.graphs import PartitionedGraph as RefPG
from repro.graphs import block_owner as ref_block_owner
from repro.graphs import generators as RG
import repro_torch
from repro_torch.core import pruning as port_pruning
from repro_torch.core import slugger as port_slugger
from repro_torch.core.engine import STAGE_ORDER, SummarizerEngine
from repro_torch.graphs import Graph as PortGraph
from repro_torch.graphs import GraphShard, PartitionedGraph, as_partitioned
from repro_torch.graphs import block_owner
from repro_torch.graphs import generators as PG
from repro_torch.kernels import _build
from repro_torch.kernels.bitset_fold import kernel as fold_kernel
from repro_torch.kernels.bitset_jaccard import kernel as inter_kernel
from repro_torch.kernels.seghist import kernel as hist_kernel

# name -> maker(generators module, Graph class): each package makes its own
GRAPHS = {
    "caveman": lambda m, G: m.caveman(14, 6, 0.05, seed=13),
    "rmat": lambda m, G: m.rmat(8, 4, seed=2),
    "ba": lambda m, G: m.barabasi_albert(120, 3, seed=5),
    "no-edges": lambda m, G: G.from_edges(9, np.zeros((0, 2))),
    "empty": lambda m, G: G.from_edges(0, np.zeros((0, 2))),
}
ENGINE_GRAPHS = {
    "caveman": lambda m: m.caveman(14, 6, 0.05, seed=13),
    "ba": lambda m: m.barabasi_albert(150, 3, seed=12),
    "hier": lambda m: m.planted_hierarchy((3, 3), 6, (0.02, 0.3, 0.95),
                                          seed=1),
}
PORT_BACKENDS = ("numpy", "batched", "resident", "loop")


def _pair(name):
    return (GRAPHS[name](RG, RefGraph), GRAPHS[name](PG, PortGraph))


def _assert_same(a, b, msg=""):
    np.testing.assert_array_equal(a.parent, b.parent, err_msg=str(msg))
    np.testing.assert_array_equal(a.edges, b.edges, err_msg=str(msg))


def _assert_same_shards(ref_pg, port_pg):
    assert (port_pg.n, port_pg.n_parts, port_pg.m) == (
        ref_pg.n, ref_pg.n_parts, ref_pg.m)
    np.testing.assert_array_equal(port_pg.owner, ref_pg.owner)
    for rs, ps in zip(ref_pg.shards, port_pg.shards):
        assert isinstance(ps, GraphShard) and ps.part == rs.part
        for field in ("nodes", "indptr", "indices"):
            a, b = getattr(ps, field), getattr(rs, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def _assert_same_graph(port_g, ref_g):
    assert port_g.n == ref_g.n
    np.testing.assert_array_equal(port_g.indptr, ref_g.indptr)
    np.testing.assert_array_equal(port_g.indices, ref_g.indices)


# ------------------------------------------------------ partitioned graphs
@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_from_graph_shards_equal_reference(name, k):
    ref_g, port_g = _pair(name)
    ref_pg, port_pg = RefPG.from_graph(ref_g, k), \
        PartitionedGraph.from_graph(port_g, k)
    _assert_same_shards(ref_pg, port_pg)
    assert port_pg.to_graph() is port_g  # sliced: the source comes back
    for s in port_pg.shards:
        for i, u in enumerate(s.nodes):
            np.testing.assert_array_equal(s.neighbors(i),
                                          port_g.neighbors(int(u)))


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_from_edge_stream_equals_reference(name, k, tmp_path):
    """In memory and with ``spill_dir``: shards equal the reference's, and
    `to_graph` (the concatenation path: no source) equals the graph."""
    ref_g, port_g = _pair(name)
    ref_pg = RefPG.from_edge_stream(ref_g.n, RG.stream_edges(ref_g, 57),
                                    n_parts=k)
    for spill in (None, str(tmp_path / "runs")):
        port_pg = PartitionedGraph.from_edge_stream(
            port_g.n, PG.stream_edges(port_g, 57), n_parts=k,
            spill_dir=spill)
        _assert_same_shards(ref_pg, port_pg)
        assert port_pg._source is None
        assert port_pg.to_graph() == port_g
    assert not list((tmp_path / "runs").glob("run-*"))


def test_spill_dir_survives_kill_mid_run_write(tmp_path):
    g = PG.caveman(10, 6, 0.05, seed=3)
    spill = tmp_path / "runs"
    spill.mkdir()
    np.save(str(spill / "run-0-7.npy"),
            np.array([0 * g.n + 59, 59 * g.n + 0], dtype=np.int64))
    (spill / "run-1-3.npy.tmp").write_bytes(b"\x93NUMPY torn")
    pg = PartitionedGraph.from_edge_stream(
        g.n, PG.stream_edges(g, chunk_edges=41), n_parts=3,
        spill_dir=str(spill))
    assert pg.to_graph() == g  # the orphan's fake edge did not leak in
    assert not list(spill.glob("run-*"))


def test_spill_run_files_commit_atomically(tmp_path, monkeypatch):
    g = PG.caveman(10, 6, 0.05, seed=3)
    spill = tmp_path / "runs"
    real_replace = os.replace
    seen_tmp = []

    def audited_replace(src, dst):
        if str(spill) in str(dst):
            assert str(src).endswith(".tmp")
            assert not os.path.exists(dst)
            seen_tmp.append(src)
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", audited_replace)
    pg = PartitionedGraph.from_edge_stream(
        g.n, PG.stream_edges(g, chunk_edges=41), n_parts=3,
        spill_dir=str(spill))
    assert pg.to_graph() == g and seen_tmp


def test_dirty_chunks_owner_checks_and_helpers():
    chunks = [np.array([[0, 1], [1, 1], [2, 3], [1, 0]]),
              np.array([[0, 1], [3, 2], [4, 0]])]
    pg = PartitionedGraph.from_edge_stream(5, iter(chunks), n_parts=2)
    assert pg.to_graph() == PortGraph.from_edges(5, np.concatenate(chunks))
    g = PG.caveman(4, 4, 0.0, seed=0)
    with pytest.raises(ValueError):
        PartitionedGraph.from_graph(g, 2, owner=np.array([0, 0, 1, 2] * 4))
    with pytest.raises(ValueError):
        PartitionedGraph.from_edge_stream(
            4, iter([np.array([[0, 1], [2, 3]])]), n_parts=2,
            owner=np.array([0, 0, 1, 2]))
    with pytest.raises(ValueError):
        PartitionedGraph.from_graph(g, 2, owner=np.zeros(3, dtype=np.int64))
    owner = np.arange(g.n) % 3  # interleaved, non-contiguous
    _assert_same_shards(
        RefPG.from_graph(RG.caveman(4, 4, 0.0, seed=0), 3, owner=owner),
        PartitionedGraph.from_graph(g, 3, owner=owner))
    for n, k in ((10, 3), (0, 2), (7, 7), (100, 4)):
        np.testing.assert_array_equal(block_owner(n, k),
                                      ref_block_owner(n, k))
    one = g.partitioned()
    assert one.n_parts == 1 and one.shard(0).n_local == g.n
    np.testing.assert_array_equal(one.part_nodes(0), np.arange(g.n))
    assert as_partitioned(one, 5) is one
    assert as_partitioned(g, 2).n_parts == 2


# ---------------------------------------------------------------- generators
@pytest.mark.parametrize("args", [(7, 4, 9, 100), (10, 8, 0, 1 << 18),
                                  (9, 3, 5, 1000)])
def test_rmat_stream_equals_reference(args):
    scale, ef, seed, chunk = args
    got = list(PG.rmat_stream(scale, ef, seed=seed, chunk_edges=chunk))
    want = list(RG.rmat_stream(scale, ef, seed=seed, chunk_edges=chunk))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    n = 1 << scale
    _assert_same_shards(
        RefPG.from_edge_stream(n, RG.rmat_stream(scale, ef, seed=seed,
                                                 chunk_edges=chunk), 3),
        PartitionedGraph.from_edge_stream(
            n, PG.rmat_stream(scale, ef, seed=seed, chunk_edges=chunk), 3))


def test_bipartite_nested_and_sample_subgraph_equal_reference():
    for args in ((8, 7, 3), (16, 12, 4), (5, 1, 1)):
        _assert_same_graph(PG.bipartite_nested(*args),
                           RG.bipartite_nested(*args))
    for n_nodes, seed in ((50, 0), (200, 3), (1000, 1)):
        _assert_same_graph(
            PG.sample_subgraph(PG.barabasi_albert(300, 3, seed=2), n_nodes,
                               seed=seed),
            RG.sample_subgraph(RG.barabasi_albert(300, 3, seed=2), n_nodes,
                               seed=seed))
    g = PG.caveman(10, 6, 0.05, seed=3)
    ref_chunks = list(RG.stream_edges(RG.caveman(10, 6, 0.05, seed=3), 41))
    port_chunks = list(PG.stream_edges(g, 41))
    assert len(port_chunks) == len(ref_chunks)
    for a, b in zip(port_chunks, ref_chunks):
        np.testing.assert_array_equal(a, b)
    edges = np.arange(14).reshape(7, 2)
    assert [c.tolist() for c in PG.as_chunks(edges, 3)] == \
        [c.tolist() for c in RG.as_chunks(edges, 3)]


# -------------------------------------------------------------------- engine
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("name", list(ENGINE_GRAPHS))
def test_partitions_and_workers_bit_identical(name, backend):
    g = ENGINE_GRAPHS[name](PG)
    mono = SummarizerEngine(backend=backend, T=6, seed=3,
                            device="cpu").run(g)
    assert mono.validate_lossless(g)
    for k in (1, 2, 4):
        for w in (1, 4):
            eng = SummarizerEngine(partitions=k, workers=w, backend=backend,
                                   T=6, seed=3, device="cpu")
            _assert_same(mono, eng.run(g), (name, backend, k, w))
    if backend in ("numpy", "batched"):
        ref_g = ENGINE_GRAPHS[name](RG)
        for k in (1, 2, 4):
            ref = ref_engine_mod.SummarizerEngine(
                partitions=k, backend=backend, T=6, seed=3).run(ref_g)
            _assert_same(ref, mono, (name, backend, k, "reference"))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_partition_edge_cases(backend):
    """T=1, the empty and edgeless graphs, one clique spanning a whole
    partition, and seeded random graphs at random partition counts."""
    def both(g, **kw):
        mono = SummarizerEngine(backend=backend, device="cpu", **kw).run(g)
        assert mono.validate_lossless(g)
        for k in (2, 3):
            _assert_same(mono, SummarizerEngine(
                partitions=k, workers=2, backend=backend, device="cpu",
                **kw).run(g), (backend, kw, k))

    both(PG.caveman(8, 5, 0.0, seed=1), T=1, seed=0)
    both(PortGraph.from_edges(0, np.zeros((0, 2))), T=3, seed=0)
    both(PortGraph.from_edges(7, np.zeros((0, 2))), T=2, seed=0)
    clique = PortGraph.from_edges(
        12, np.array([(u, v) for u in range(12) for v in range(u + 1, 12)]))
    both(clique, T=4, seed=2, max_group=500)
    rng = np.random.default_rng(11)
    for trial in range(4):
        n = int(rng.integers(2, 40))
        g = PortGraph.from_edges(n, rng.integers(0, n, size=(2 * n, 2)))
        both(g, T=3, seed=trial)


def test_prepartitioned_and_streamed_inputs():
    """A `PartitionedGraph` passes straight through `merge_forest`; one
    built by streaming (no source graph) reassembles by concatenation."""
    g = PG.caveman(12, 5, 0.05, seed=4)
    want = repro_torch.summarize(g, T=4, seed=0, device="cpu")
    pg = PartitionedGraph.from_graph(g, 3)
    eng = SummarizerEngine(partitions=3, T=4, seed=0, device="cpu")
    state, got_pg = eng.merge_forest(pg)
    assert got_pg is pg and state.g is g
    _assert_same(want, eng.run(pg))
    streamed = PartitionedGraph.from_edge_stream(
        g.n, PG.stream_edges(g, 50), n_parts=2)
    for backend in ("batched", "resident"):
        _assert_same(want, SummarizerEngine(
            partitions=2, workers=2, backend=backend, T=4, seed=0,
            device="cpu").run(streamed), backend)
    _assert_same(want, repro_torch.summarize(g, T=4, seed=0, partitions=3,
                                             device="cpu"))
    ref = ref_core.summarize(RG.caveman(12, 5, 0.05, seed=4), T=4, seed=0,
                             partitions=3, backend="batched")
    _assert_same(ref, want)


def test_stage_overrides_and_defaults():
    calls = []

    def counting_exchange(engine, ctx):
        calls.append((ctx.t, ctx.pg.n_parts))
        SummarizerEngine.stage_exchange(engine, ctx)

    g = PG.caveman(8, 5, 0.05, seed=3)
    eng = SummarizerEngine(partitions=2, T=4, seed=0, device="cpu",
                           stages={"exchange": counting_exchange})
    s = eng.run(g)
    assert calls == [(1, 2), (2, 2), (3, 2), (4, 2)]
    _assert_same(s, repro_torch.summarize(g, T=4, seed=0, device="cpu"))
    assert eng.workers == min(2, os.cpu_count() or 1)
    assert SummarizerEngine(partitions=3, workers=0, device="cpu").workers == 1
    assert STAGE_ORDER == ref_engine_mod.STAGE_ORDER
    for name in STAGE_ORDER:
        assert eng.stats[name] >= 0.0


# ------------------------------------------------------ emission and pruning
@pytest.mark.parametrize("backend", ["numpy", "batched", "loop"])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_owner_emission_equals_reference(backend, k):
    """The same merge forest (each package's own engine, equal by the
    engine tests) emitted per owner bucket: equal to the reference's
    bucketed emission and to the port's monolithic one."""
    port_g = PG.planted_hierarchy((3, 3), 6, (0.02, 0.3, 0.95), seed=2)
    ref_g = RG.planted_hierarchy((3, 3), 6, (0.02, 0.3, 0.95), seed=2)
    state, _ = SummarizerEngine(backend="numpy", T=6, seed=1,
                                device="cpu").merge_forest(port_g)
    ref_state, _ = ref_engine_mod.SummarizerEngine(
        backend="numpy", T=6, seed=1).merge_forest(ref_g)
    np.testing.assert_array_equal(state.root_min_leaf(),
                                  ref_state.root_min_leaf())
    owner = block_owner(port_g.n, k)
    got = port_slugger._emit_encoding(state, backend=backend, device="cpu",
                                      owner=owner)
    want = ref_slugger._emit_encoding(ref_state, backend=backend,
                                      owner=owner)
    _assert_same(got, want, (backend, k))
    _assert_same(got, port_slugger._emit_encoding(state, backend=backend,
                                                  device="cpu"))
    assert got.validate_lossless(port_g)


@pytest.mark.parametrize("k", [2, 3, 7])
def test_prune_partition_map_equals_reference(k):
    port_g = PG.planted_hierarchy((3, 3), 6, (0.02, 0.3, 0.95), seed=2)
    raw = repro_torch.summarize(port_g, T=6, seed=1, prune_steps=(),
                                device="cpu")
    ref_raw = ref_core.summarize(
        RG.planted_hierarchy((3, 3), 6, (0.02, 0.3, 0.95), seed=2), T=6,
        seed=1, prune_steps=())
    owner = np.arange(port_g.n) % k  # interleaved: every bucket is mixed
    got = port_pruning.prune(raw, steps=(1, 2, 3), partition_map=owner)
    want = ref_pruning.prune(ref_raw, steps=(1, 2, 3), partition_map=owner)
    _assert_same(got, want, k)
    _assert_same(got, port_pruning.prune(raw, steps=(1, 2, 3)))


# ------------------------------------------------------ thread-safe counters
class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    launch path here; the launcher itself is stubbed out."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _topj(bits, alive):
    fold_kernel.jaccard_topj(bits, alive, 3)


def _fold(bits, alive):
    instr = torch.zeros((bits.shape[0], 2, 8), dtype=torch.int32)
    fold_kernel.bitset_fold(bits, alive, instr.as_subclass(_OnCard))


WRAPPERS = {
    "bitset_intersections": (inter_kernel, "LAUNCHES",
                             lambda b, a: inter_kernel.bitset_intersections(
                                 b, 2)),
    "segment_histogram": (hist_kernel, "LAUNCHES",
                          lambda b, a: hist_kernel.segment_histogram(
                              b.reshape(-1), 64)),
    "jaccard_topj": (fold_kernel, "TOPJ_LAUNCHES", _topj),
    "bitset_fold": (fold_kernel, "FOLD_LAUNCHES", _fold),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_launch_counter_exact_on_eight_threads(name, monkeypatch):
    """8 threads × 400 calls of a wrapper's launch path with a 1 µs switch
    interval: the counter must hold every launch (a bare ``+= 1`` on the
    module global can lose some)."""
    module, counter, call = WRAPPERS[name]
    monkeypatch.setattr(_build, "launch", lambda *a: None)
    monkeypatch.setattr(_build, "sm_count", lambda index: 132)
    monkeypatch.setattr(module, counter, 0)
    bits = torch.zeros((4, 8, 2), dtype=torch.int32).as_subclass(_OnCard)
    alive = torch.ones((4, 8), dtype=torch.int8).as_subclass(_OnCard)
    n_threads, n_calls = 8, 400
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30)
        for _ in range(n_calls):
            call(bits, alive)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert getattr(module, counter) == n_threads * n_calls
