"""The port's batched summary serving against the JAX package's.

The reference summarizes and packs each graph; the port serves the same
artifact (built from the reference's arrays, or loaded from its `.npz`).
Every port backend (`numpy`, `torch`, `kernel`, all with ``device="cpu"``,
where the kernel backend runs the interval kernel's plain version) must
answer exactly as every reference backend (`numpy`, `jax`, `pallas` in
interpret mode) and as the per-call `Summary.neighbors`. All comparisons
are exact: the answers are integer ids and booleans.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import summarize as ref_summarize
from repro.core import query_batch as RQ
from repro.core.summary_ir import PackedSummary as RefPacked
from repro.graphs import generators as GG
from repro.graphs.csr import Graph
from repro.kernels.interval_expand import ops as ref_interval_ops
from repro.kernels.interval_expand import ref as ref_interval_ref
from repro.kernels.interval_expand.kernel import interval_count_kernel
from repro.launch import serve as ref_serve
from repro.launch.summary_serve import SummaryQueryServer as RefServer
from repro_torch.core import query_batch as PQ
from repro_torch.core.slugger import summarize as port_summarize
from repro_torch.core.summary_ir import PackedSummary as PortPacked
from repro_torch.graphs import generators as PG
from repro_torch.kernels.interval_expand import kernel as interval_kernel
from repro_torch.kernels.interval_expand import ops as port_interval_ops
from repro_torch.kernels.interval_expand import ref as port_interval_ref
from repro_torch.launch import serve as port_serve
from repro_torch.launch.summary_serve import SummaryQueryServer, make_queries

ROOT = Path(__file__).resolve().parents[1]
PACKED_FIELDS = ("parent", "first", "last", "order", "inc_ptr", "inc_eid",
                 "edge_x", "edge_y", "sign_bits", "pos_of", "inc_lo",
                 "inc_hi", "inc_sign")


def _port_artifact(ps):
    """The port's `PackedSummary` over the reference artifact's arrays."""
    return PortPacked(ps.n_leaves, ps.parent, ps.first, ps.last, ps.order,
                      ps.inc_ptr, ps.inc_eid, ps.edge_x, ps.edge_y,
                      ps.sign_bits)


def _neighbors_everywhere(ps, vs):
    """(indptr, ids) from every reference and every port backend."""
    pps = _port_artifact(ps)
    out = {f"ref-{b}": RQ.neighbors_batch(ps, vs, backend=b)
           for b in RQ.BACKENDS}
    out.update({f"port-{b}": PQ.neighbors_batch(pps, vs, backend=b,
                                                device="cpu")
                for b in PQ.BACKENDS})
    return out


def _edges_everywhere(ps, us, vs):
    pps = _port_artifact(ps)
    out = {f"ref-{b}": RQ.edge_exists_batch(ps, us, vs, backend=b)
           for b in RQ.BACKENDS}
    out.update({f"port-{b}": PQ.edge_exists_batch(pps, us, vs, backend=b,
                                                  device="cpu")
                for b in PQ.BACKENDS})
    return out


def _assert_neighbors_agree(s, ps, vs):
    got = _neighbors_everywhere(ps, vs)
    indptr, ids = got["ref-numpy"]
    for name, (ip, ii) in got.items():
        assert ii.dtype == np.int64, name
        np.testing.assert_array_equal(ip, indptr, err_msg=name)
        np.testing.assert_array_equal(ii, ids, err_msg=name)
    for i, v in enumerate(vs):
        np.testing.assert_array_equal(ids[indptr[i]:indptr[i + 1]],
                                      s.neighbors(int(v)))


def _assert_edges_agree(ps, us, vs, want):
    for name, got in _edges_everywhere(ps, us, vs).items():
        assert got.dtype == bool, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _random_graph(rng, n, density):
    k = int(n * n * density)
    e = (rng.integers(0, n, size=(k, 2)) if k
         else np.zeros((0, 2), dtype=np.int64))
    return Graph.from_edges(n, e)


def _named_graphs():
    return {"er": lambda: GG.erdos_renyi(120, 0.05, seed=21),
            "caveman": lambda: GG.caveman(12, 6, 0.05, seed=23),
            "star": lambda: GG.star_of_cliques(16, 5, seed=25)}


# ------------------------------------------------------------ interval counts
def _interval_case(B, E, P, seed, pad_frac=0.25):
    """Random intervals and probes with padded slots: intervals lo == hi ==
    0 with sign 0, probes -1."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 60, size=(B, E)).astype(np.int32)
    hi = lo + rng.integers(0, 25, size=(B, E)).astype(np.int32)
    sg = rng.choice([-1, 0, 1], size=(B, E)).astype(np.int32)
    pad = rng.random((B, E)) < pad_frac
    lo[pad] = hi[pad] = sg[pad] = 0
    pos = rng.integers(-1, 90, size=(B, P)).astype(np.int32)
    pos[rng.random((B, P)) < pad_frac] = -1
    return lo, hi, sg, pos


INTERVAL_CASES = [
    # (B, E, P, block_p, block_e)
    (1, 1, 1, 512, 1024),
    (4, 33, 17, 512, 1024),
    (8, 200, 513, 512, 1024),    # P past one probe block
    (5, 1030, 1, 512, 1024),     # one probe, E not a multiple of the block
    (16, 70, 1, 8, 16),          # one probe, several interval blocks
    (3, 29, 23, 7, 5),           # neither axis a multiple of its block
]


@pytest.mark.parametrize("B,E,P,block_p,block_e", INTERVAL_CASES)
def test_plain_interval_counts_match_pallas(B, E, P, block_p, block_e):
    lo, hi, sg, pos = _interval_case(B, E, P, seed=B * E + P)
    want = np.asarray(interval_count_kernel(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(sg), jnp.asarray(pos),
        block_p=block_p, block_e=block_e, interpret=True))
    got = interval_kernel.interval_counts(*(torch.from_numpy(a) for a in
                                            (lo, hi, sg, pos)))
    assert got.dtype == torch.int32 and got.shape == (B, P)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_interval_ref.interval_counts(lo, hi, sg,
                                                                 pos)))


def test_plain_interval_counts_chunk_rows(monkeypatch):
    """A small temporary budget splits the rows; the answer is unchanged."""
    lo, hi, sg, pos = _interval_case(9, 40, 30, seed=4)
    t = [torch.from_numpy(a) for a in (lo, hi, sg, pos)]
    whole = port_interval_ref.interval_counts(*t)
    monkeypatch.setattr(port_interval_ref, "_BUDGET", 40 * 30 * 2)
    np.testing.assert_array_equal(port_interval_ref.interval_counts(*t).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("B,E,P", [(1, 1, 1), (3, 17, 9), (8, 130, 257),
                                   (6, 12, 1), (0, 4, 3), (2, 5, 0)])
def test_batch_interval_counts_match_reference(B, E, P):
    lo, hi, sg, pos = _interval_case(B, E, P, seed=100 + B + E + P)
    want = ref_interval_ops.batch_interval_counts(lo, hi, sg, pos,
                                                  backend="numpy")
    if B and P:
        np.testing.assert_array_equal(
            ref_interval_ops.batch_interval_counts(lo, hi, sg, pos,
                                                   backend="pallas"), want)
    for backend in ("numpy", "kernel"):
        got = port_interval_ops.batch_interval_counts(
            lo, hi, sg, pos, backend=backend, device="cpu")
        assert got.dtype == np.int64 and got.shape == (B, P)
        np.testing.assert_array_equal(got, want)


def test_batch_interval_counts_rejects_bad_arguments():
    lo, hi, sg, pos = _interval_case(2, 3, 4, seed=0)
    with pytest.raises(ValueError, match="unknown backend"):
        port_interval_ops.batch_interval_counts(lo, hi, sg, pos,
                                                backend="pallas")
    with pytest.raises(ValueError, match="device"):
        port_interval_ops.batch_interval_counts(lo, hi, sg, pos,
                                                backend="kernel")
    with pytest.raises(ValueError, match="int32"):
        interval_kernel.interval_counts(*(torch.from_numpy(a).long() for a in
                                          (lo, hi, sg, pos)))


# --------------------------------------------------------------- batch queries
@pytest.mark.parametrize("steps", [(), (1, 2, 3)], ids=["unpruned", "pruned"])
@pytest.mark.parametrize("name", sorted(_named_graphs()))
def test_neighbors_batch_matches_reference(name, steps):
    g = _named_graphs()[name]()
    s = ref_summarize(g, T=5, seed=7, prune_steps=steps)
    _assert_neighbors_agree(s, s.pack_for_serving(),
                            np.arange(s.n_leaves, dtype=np.int64))


@pytest.mark.parametrize("name", sorted(_named_graphs()))
def test_edge_exists_matches_reference(name):
    g = _named_graphs()[name]()
    s = ref_summarize(g, T=5, seed=9)
    dec = s.decompress()
    rng = np.random.default_rng(5)
    us = rng.integers(0, g.n, size=120)
    vs = rng.integers(0, g.n, size=120)
    us[:4] = vs[:4]  # u == v never is an edge
    want = np.array([dec.has_edge(int(u), int(v)) for u, v in zip(us, vs)])
    _assert_edges_agree(s.pack_for_serving(), us, vs, want)


@pytest.mark.parametrize("trial", range(8))
def test_query_batch_random_graphs(trial):
    rng = np.random.default_rng(11 + trial)
    g = _random_graph(rng, int(rng.integers(2, 32)), rng.random() * 0.5)
    s = ref_summarize(g, T=4, seed=trial)
    ps = s.pack_for_serving()
    _assert_neighbors_agree(s, ps, np.arange(g.n, dtype=np.int64))
    us = rng.integers(0, g.n, size=2 * g.n)
    vs = rng.integers(0, g.n, size=2 * g.n)
    dec = s.decompress()
    _assert_edges_agree(ps, us, vs, np.array(
        [dec.has_edge(int(u), int(v)) for u, v in zip(us, vs)]))


@pytest.mark.parametrize("n", [5, 1], ids=["edgeless", "singleton"])
def test_query_batch_edgeless_and_singleton(n):
    g = Graph.from_edges(n, np.zeros((0, 2), dtype=np.int64))
    ps = ref_summarize(g, T=2, seed=0).pack_for_serving()
    for name, (indptr, ids) in _neighbors_everywhere(ps, np.arange(n)).items():
        assert ids.size == 0 and indptr[-1] == 0 and indptr.size == n + 1, name
    zeros = np.zeros(3, dtype=np.int64)
    for name, got in _edges_everywhere(ps, zeros, zeros).items():
        assert got.shape == (3,) and not got.any(), name


def test_query_batch_property_hypothesis():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(n=st.integers(min_value=1, max_value=20),
           density=st.floats(min_value=0.0, max_value=0.7),
           seed=st.integers(min_value=0, max_value=2 ** 31 - 1))
    def inner(n, density, seed):
        rng = np.random.default_rng(seed)
        g = _random_graph(rng, n, density)
        s = ref_summarize(g, T=3, seed=seed % 89)
        ps = s.pack_for_serving()
        _assert_neighbors_agree(s, ps, np.arange(n, dtype=np.int64))
        us = rng.integers(0, n, size=2 * n)
        ws = rng.integers(0, n, size=2 * n)
        dec = s.decompress()
        _assert_edges_agree(ps, us, ws, np.array(
            [dec.has_edge(int(u), int(w)) for u, w in zip(us, ws)]))

    inner()


def test_gather_and_padding_match_reference():
    """The gather phase and the padded tiles of the fixed-shape backends
    are the reference's, array for array."""
    s = ref_summarize(GG.caveman(12, 6, 0.05, seed=23), T=5, seed=7)
    ps = s.pack_for_serving()
    vs = np.arange(0, s.n_leaves, 3, dtype=np.int64)
    ref_g = RQ._gather_chain_intervals(ps, vs)
    port_g = PQ._gather_chain_intervals(_port_artifact(ps), vs)
    for a, b in zip(ref_g, port_g):
        np.testing.assert_array_equal(a, b)
    ref_p = RQ._padded_batch(*ref_g, vs.size)
    port_p = PQ._padded_batch(*port_g, vs.size)
    for a, b in zip(ref_p, port_p):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["torch", "kernel", "bogus"])
def test_backends_need_a_known_backend_and_a_device(monkeypatch, backend):
    ps = ref_summarize(GG.caveman(4, 4, 0.0, seed=0), T=2,
                       seed=0).pack_for_serving()
    pps = _port_artifact(ps)
    if backend == "bogus":
        with pytest.raises(ValueError, match="unknown backend"):
            PQ.neighbors_batch(pps, np.array([0]), backend=backend)
        with pytest.raises(ValueError, match="unknown backend"):
            SummaryQueryServer(pps, backend=backend, device="cpu")
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PQ.neighbors_batch(pps, np.array([0]), backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        PQ.edge_exists_batch(pps, np.array([0]), np.array([1]),
                             backend=backend)


# ------------------------------------------------------------------ artifacts
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_npz_cross_load(tmp_path, writer):
    """An artifact written by either package loads in the other with every
    serialized and derived array equal, and answers the same."""
    g = GG.caveman(10, 6, 0.05, seed=3)
    s = ref_summarize(g, T=5, seed=3)
    ref_ps = s.pack_for_serving()
    port_ps = port_summarize(PG.caveman(10, 6, 0.05, seed=3), T=5, seed=3,
                             backend="numpy", device="cpu").pack_for_serving()
    path = str(tmp_path / "packed")
    if writer == "reference":
        loaded = PortPacked.load(ref_ps.save(path))
    else:
        loaded = RefPacked.load(port_ps.save(path))
    assert path + ".npz" == str(tmp_path / "packed.npz")
    for f in PACKED_FIELDS:
        np.testing.assert_array_equal(getattr(loaded, f), getattr(ref_ps, f),
                                      err_msg=f)
        assert getattr(loaded, f).dtype == getattr(ref_ps, f).dtype, f
    assert (loaded.n_leaves, loaded.n_ids, loaded.max_depth) == (
        ref_ps.n_leaves, ref_ps.n_ids, ref_ps.max_depth)
    vs = np.arange(g.n, dtype=np.int64)
    want = RQ.neighbors_batch(ref_ps, vs)
    if writer == "reference":
        got = PQ.neighbors_batch(loaded, vs, backend="kernel", device="cpu")
    else:
        got = RQ.neighbors_batch(loaded, vs, backend="numpy")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- server
def _ref_artifact(ps):
    """The reference's `PackedSummary` over a port artifact's arrays."""
    return RefPacked(ps.n_leaves, ps.parent, ps.first, ps.last, ps.order,
                     ps.inc_ptr, ps.inc_eid, ps.edge_x, ps.edge_y,
                     ps.sign_bits)


def _served_summary():
    g = PG.caveman(12, 6, 0.05, seed=1)
    s = port_summarize(g, T=5, seed=1, backend="numpy", device="cpu")
    return g, s, s.pack_for_serving()


@pytest.mark.parametrize("backend", PQ.BACKENDS)
def test_query_server_mixed_queries_in_order(backend):
    g, s, ps = _served_summary()
    queries = make_queries(g.n, 101, edge_frac=0.4, seed=4)  # 101 % slots != 0
    answers = SummaryQueryServer(ps, batch_slots=16, backend=backend,
                                 device="cpu").run(queries)
    want = RefServer(_ref_artifact(ps), batch_slots=16,
                     backend="numpy").run(queries)
    assert len(answers) == len(queries)
    for q, a, w in zip(queries, answers, want):
        if q[0] == "neighbors":
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(a, s.neighbors(q[1]))
        else:
            assert a is w or a == w
            assert a == bool(np.isin(q[2], s.neighbors(q[1]))), q
    assert SummaryQueryServer(ps, device="cpu").run([]) == []


def test_query_server_malformed_queries_get_error_records():
    """A bad query comes back as a `RequestError` in its slot, with the
    reference's reason, and every other query is still answered."""
    _, s, ps = _served_summary()
    bad = [("bfs", 0),                      # unknown kind
           ("neighbors", 1, 2),             # wrong arity
           ("neighbors", ps.n_leaves + 5),  # out of range
           ("edge", 0, "x"),                # non-integer id
           "neighbors",                     # not a tuple at all
           ("edge", 0, -1)]                 # negative id
    good = ("neighbors", 0)
    queries = bad[:3] + [good] + bad[3:]
    answers = SummaryQueryServer(ps, batch_slots=4, device="cpu").run(queries)
    want = RefServer(_ref_artifact(ps), batch_slots=4).run(queries)
    assert len(answers) == len(queries)
    for q, a, w in zip(queries, answers, want):
        if q == good:
            np.testing.assert_array_equal(a, s.neighbors(0))
        else:
            assert isinstance(a, port_serve.RequestError)
            assert a.request == q and a.reason == w.reason
    assert "unknown query kind" in answers[0].reason
    assert "out of range" in answers[2].reason


def test_query_server_timeout_flushes_partial_results():
    g, s, ps = _served_summary()
    queries = [("neighbors", int(v) % g.n) for v in range(40)]
    server = SummaryQueryServer(ps, batch_slots=8, device="cpu")
    # deadline already expired: the FIRST batch still runs (no starvation),
    # later batches are cut off and marked with timeout records
    answers = server.run(queries, timeout=0.0)
    assert not any(isinstance(a, port_serve.RequestError) for a in answers[:8])
    assert all(isinstance(a, port_serve.RequestError) for a in answers[8:])
    assert "timed out" in answers[-1].reason
    for q, a in zip(queries[:8], answers[:8]):
        np.testing.assert_array_equal(a, s.neighbors(q[1]))
    answers = server.run(queries, timeout=60.0)
    assert not any(isinstance(a, port_serve.RequestError) for a in answers)


def test_query_server_defaults_to_the_kernel_on_the_card(monkeypatch):
    _, _, ps = _served_summary()
    assert SummaryQueryServer(ps, device="cpu").backend == "kernel"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SummaryQueryServer(ps)


@pytest.mark.parametrize("chunk,slots", [([1], 3), ([1, 2, 3], 3),
                                         ([("e", 1, 2), ("e", 4, 5)], 5)])
def test_pad_to_slots_matches_reference(chunk, slots):
    assert port_serve.pad_to_slots(chunk, slots) == ref_serve.pad_to_slots(
        chunk, slots)


def test_pad_to_slots_refuses_an_empty_chunk():
    with pytest.raises(ValueError, match="empty"):
        port_serve.pad_to_slots([], 4)


def test_make_queries_matches_reference():
    from repro.launch.summary_serve import make_queries as ref_make_queries

    assert make_queries(50, 77, edge_frac=0.3, seed=2) == ref_make_queries(
        50, 77, edge_frac=0.3, seed=2)


def test_summary_serve_smoke_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.summary_serve", "--smoke",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "smoke OK: 256 answers" in out.stdout
    assert "device=cpu" in out.stdout
