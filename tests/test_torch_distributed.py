"""Slice E5 of the port, the summarizer's mesh path (`core/distributed.py`,
`launch/mesh.py`, `SummarizerEngine(mesh=)`), against the JAX package.

Single-process cases hold each function to the reference's on the same
numpy-seeded inputs: the dense shingles, the greedy matching, the einsum
Jaccard, both histogram modes of the dry-run step and `summarize_jax`,
bit for bit; and the per-rank bodies, run shard by shard, to the
unsharded results. The multi-rank cases run the port SPMD in gloo
process groups of 2, 3 and 4 CPU ranks (`torch_dist.spawn`, one spawn a
group, shared by the cases that read it): the reference's ``MESH_EQUIV``
at world 4 (`tests/test_engine_partitioned.py`), the sharded shingles,
the intersection dispatch at world 3 on batches 3 does not divide with
its transfer ledger against the reference's at 3 host devices (a
subprocess, as the reference's own mesh tests run), and injected faults
at world 2.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.core.engine import SummarizerEngine as RefEngine
from repro.graphs import generators as RG
from repro_torch.core import distributed as D
from repro_torch.core.engine import SummarizerEngine
from repro_torch.graphs import generators as PG
from repro_torch.kernels.bitset_jaccard.ops import \
    batched_pairwise_intersections
from repro_torch.launch import mesh as M

from torch_dist import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
T_MESH, SEED_MESH = 4, 2  # the reference's MESH_EQUIV run


def _edges(g):
    src = np.repeat(np.arange(g.n), np.diff(g.indptr)).astype(np.int64)
    return src, g.indices.astype(np.int64)


def _same(a, b):
    return (np.array_equal(a.parent if hasattr(a, "parent") else a["parent"],
                           b.parent)
            and np.array_equal(a.edges if hasattr(a, "edges")
                               else a["edges"], b.edges))


# ------------------------------------------------------ single process
@pytest.mark.parametrize("ab", [(123457, 99), (2654435761, 0x9E3779B9),
                                (0xFFFFFFFF, 0xFFFFFFFF)])
@pytest.mark.parametrize("graph", ["ba", "caveman", "edgeless"])
def test_dense_shingles_equal_the_reference(graph, ab):
    make = {"ba": lambda m: m.barabasi_albert(100, 3, seed=0),
            "caveman": lambda m: m.caveman(9, 5, 0.1, seed=2),
            "edgeless": lambda m: m.barabasi_albert(1, 1, seed=0)}[graph]
    g = make(PG)
    src, dst = _edges(g)
    a, b = ab
    got = D.node_shingles_dense(torch.from_numpy(src), torch.from_numpy(dst),
                                g.n, a, b)
    want = RD.node_shingles_dense(jnp.asarray(src, jnp.int32),
                                  jnp.asarray(dst, jnp.int32), g.n,
                                  np.uint32(a), np.uint32(b))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("G,K,thr,mm", [(4, 16, 0.0, None), (3, 9, 0.5, 4),
                                        (2, 5, 0.3, 1), (5, 8, 2.0, None)])
def test_greedy_matching_equals_the_reference(G, K, thr, mm):
    rng = np.random.default_rng(G * 100 + K)
    s = rng.random((G, K, K)).astype(np.float32)
    s = (s + s.transpose(0, 2, 1)) / 2
    s[0, 1, 2] = s[0, 2, 1] = s[0, 0, 3] = s[0, 3, 0] = 0.999  # a tie
    got = D.greedy_group_matching(torch.from_numpy(s), thr, max_merges=mm)
    want = RD.greedy_group_matching(jnp.asarray(s), thr, max_merges=mm)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_greedy_matching_respects_threshold():
    s = torch.tensor([[[0, 0.9, 0.1], [0.9, 0, 0.2], [0.1, 0.2, 0]]])
    pairs = D.greedy_group_matching(s, threshold=0.5).numpy()
    assert {tuple(sorted(p)) for p in pairs[0] if p[0] >= 0} == {(0, 1)}


@pytest.mark.parametrize("shape", [(3, 6, 40), (1, 1, 5), (2, 8, 1)])
def test_group_jaccard_scores_equal_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    onehot = rng.random(shape) < 0.3
    got = D.group_jaccard_scores(torch.from_numpy(onehot))
    want = RD.group_jaccard_scores(jnp.asarray(onehot))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hist", ["sort", "scatter"])
@pytest.mark.parametrize("seed", [0, 3, 0xFFFFFFFF])
def test_summarize_step_fn_equals_the_reference(hist, seed):
    g = PG.barabasi_albert(1200, 3, seed=5)
    src, dst = _edges(g)
    root_of = np.arange(g.n) // 3  # a coarsened root map
    sh, counts = D.summarize_step_fn(g.n, hist)(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(root_of), seed)
    step = jax.jit(RD.summarize_step_fn(g.n, hist))
    rsh, rcounts = step(jnp.asarray(src, jnp.int32),
                        jnp.asarray(dst, jnp.int32),
                        jnp.asarray(root_of, jnp.int32), jnp.uint32(seed))
    assert np.array_equal(sh.numpy(), np.asarray(rsh).astype(np.int64))
    assert np.array_equal(counts.numpy(), np.asarray(rcounts))


@pytest.mark.parametrize("graph,T", [("hier", 4), ("caveman", 3), ("ba", 2)])
def test_summarize_jax_equals_the_reference(graph, T):
    make = {"hier": lambda m: m.planted_hierarchy((3, 3), 6,
                                                  (0.02, 0.3, 0.95), seed=1),
            "caveman": lambda m: m.caveman(10, 6, 0.05, seed=4),
            "ba": lambda m: m.barabasi_albert(90, 3, seed=7)}[graph]
    g = make(PG)
    got = D.summarize_jax(g, T=T, seed=1, device=CPU)
    want = RD.summarize_jax(make(RG), T=T, seed=1)
    assert got.validate_lossless(g)
    assert _same(got, want)


@pytest.mark.parametrize("world", [1, 3, 4])
def test_per_rank_shingle_bodies_cover_the_dense_shingles(world):
    g = PG.caveman(20, 7, 0.1, seed=9)
    src, dst = _edges(g)
    pad = (-src.size) % world
    src_p = torch.from_numpy(np.concatenate([src, np.full(pad, g.n)]))
    dst_p = torch.from_numpy(np.concatenate([dst, np.zeros(pad, np.int64)]))
    parts = [D.shingles_local(src_p[M.block(src_p.numel(), r, world)],
                              dst_p[M.block(dst_p.numel(), r, world)],
                              g.n, 77, 5) for r in range(world)]
    got = torch.stack(parts).amin(0)
    want = D.node_shingles_dense(torch.from_numpy(src),
                                 torch.from_numpy(dst), g.n, 77, 5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,G,W,world", [(5, 8, 3, 3), (70, 16, 9, 4),
                                         (2, 8, 1, 4)])
def test_per_rank_intersection_bodies_equal_the_unsharded_dispatch(B, G, W,
                                                                    world):
    rng = np.random.default_rng(B + G + W)
    bits = rng.integers(0, 1 << 32, size=(B, G, W), dtype=np.uint64).astype(
        np.uint32)
    Bs = -(-B // world)
    batch = np.zeros((world * Bs, G, 16), dtype=np.uint32)
    batch[:B, :, :W] = bits
    got = torch.cat([D.intersections_rank(batch, B, r, world, CPU)
                     for r in range(world)])
    want = batched_pairwise_intersections(bits, device=CPU)
    assert np.array_equal(got.numpy()[:B].astype(np.int64), want)
    assert not got[B:].any()  # padding rows do no work


def test_a_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()  # groups live in spawns
    with pytest.raises(RuntimeError, match="process group"):
        M.make_data_mesh()
    assert M.mesh_sizes({"data": 4, "model": 2}) == {"data": 4, "model": 2}
    assert M.dp_axes_of({"pod": 2, "data": 4, "model": 2}) == ("pod", "data")


def test_engine_refuses_a_mesh_of_another_device_type():
    class CardMesh:
        device_type = "cuda"

    eng = SummarizerEngine(backend="batched", T=2, mesh=CardMesh(),
                           device=CPU)
    with pytest.raises(RuntimeError, match="NCCL"):
        eng.run(PG.caveman(4, 4, 0.0, seed=0))
    # the host backends never shard
    s = SummarizerEngine(backend="numpy", T=2, mesh=CardMesh(),
                         device=CPU).run(PG.caveman(4, 4, 0.0, seed=0))
    assert s.validate_lossless(PG.caveman(4, 4, 0.0, seed=0))


# --------------------------------------------------------- world 4
MESH_RUNS = [("batched", 1, True), ("batched", 2, True),
             ("batched", 4, True), ("resident", 1, True),
             ("resident", 2, True), ("batched", 2, False)]
SHINGLE_SEEDS = (0, 1, 12345)


def _mesh_graph(m):
    return m.caveman(12, 6, 0.05, seed=3)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(4, "summarizer_world", tmp_path_factory.mktemp("w4"),
                 _mesh_graph(PG), MESH_RUNS, T_MESH, SEED_MESH,
                 PG.barabasi_albert(96, 3, seed=7), SHINGLE_SEEDS)


@pytest.fixture(scope="module")
def mesh_reference():
    g = _mesh_graph(RG)
    return RefEngine(backend="numpy", T=T_MESH, seed=SEED_MESH).run(g)


@pytest.mark.parametrize("i", range(len(MESH_RUNS)),
                         ids=[f"{b}-p{k}-{'mesh' if e else 'auto'}"
                              for b, k, e in MESH_RUNS])
def test_mesh_engine_at_world4_equals_numpy_and_no_mesh(world4,
                                                        mesh_reference, i):
    backend, k, _ = MESH_RUNS[i]
    g = _mesh_graph(PG)
    plain = SummarizerEngine(partitions=k, backend=backend, T=T_MESH,
                             seed=SEED_MESH, device=CPU).run(g)
    for rank, res in enumerate(world4):
        run = res["runs"][i]
        assert run["lossless"], rank
        assert run["workers"] == min(k, os.cpu_count() or 1)  # the default
        assert run["degradations"] == 0
        assert _same(run, mesh_reference), (rank, backend, k)
        assert _same(run, plain), (rank, backend, k)


@pytest.mark.parametrize("j", range(len(SHINGLE_SEEDS)))
def test_sharded_shingles_at_world4_equal_the_dense(world4, j):
    for res in world4:
        got, want = res["shingles"][j]
        assert np.array_equal(got, want)
    assert all(np.array_equal(r["shingles"][j][0], world4[0]["shingles"][j][0])
               for r in world4)


# --------------------------------------------------------- world 3
INTER_BATCHES = [(5, 8, 3), (7, 16, 5), (1, 8, 2)]  # B not divisible by 3

REF_LEDGER = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
    import numpy as np
    from repro.core import distributed as D
    from repro.core.transfer import GLOBAL as TRANSFER
    from repro.launch.mesh import make_data_mesh

    shapes = json.loads(sys.argv[1])
    fn = D.batched_intersections_mesh(make_data_mesh())
    TRANSFER.reset()
    out = {}
    for i, (B, G, W) in enumerate(shapes):
        rng = np.random.default_rng(i)
        bits = rng.integers(0, 1 << 32, size=(B, G, W),
                            dtype=np.uint64).astype(np.uint32)
        inter = fn(bits)
        snap = TRANSFER.snapshot()
        np.save(os.path.join(sys.argv[2], f"inter{i}.npy"), inter)
        out[i] = {k: snap[k] for k in ("bytes_h2d", "bytes_d2h", "rounds")}
    print("LEDGER" + json.dumps(out))
""")


def _inter_bits():
    out = []
    for i, (B, G, W) in enumerate(INTER_BATCHES):
        rng = np.random.default_rng(i)
        out.append(rng.integers(0, 1 << 32, size=(B, G, W),
                                dtype=np.uint64).astype(np.uint32))
    return out


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return spawn(3, "intersections_world", tmp_path_factory.mktemp("w3"),
                 _inter_bits())


@pytest.fixture(scope="module")
def ref_ledger3(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref3")
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", REF_LEDGER,
                        json.dumps(INTER_BATCHES), str(d)],
                       capture_output=True, text=True, env=env, cwd=ROOT)
    line = [x for x in r.stdout.splitlines() if x.startswith("LEDGER")]
    assert line, r.stderr[-2000:]
    ledger = json.loads(line[0][len("LEDGER"):])
    return ledger, [np.load(d / f"inter{i}.npy")
                    for i in range(len(INTER_BATCHES))]


@pytest.mark.parametrize("i", range(len(INTER_BATCHES)))
def test_mesh_intersections_at_world3_equal_the_unsharded_dispatch(world3,
                                                                   i):
    bits = _inter_bits()[i]
    want = batched_pairwise_intersections(bits, device=CPU)
    for res in world3:
        assert np.array_equal(res[i][0], want)


@pytest.mark.parametrize("i", range(len(INTER_BATCHES)))
def test_mesh_intersection_ledger_equals_the_reference_at_3_devices(
        world3, ref_ledger3, i):
    ledger, ref_inter = ref_ledger3
    assert np.array_equal(world3[0][i][0], ref_inter[i])
    for res in world3:
        assert res[i][1] == ledger[str(i)], i


# --------------------------------------------------------- world 2
FAULT_CASES = [("batched", "kernel.bitset_jaccard.intersections", 2),
               ("resident", "kernel.bitset_fold.round", 2),
               ("resident", "kernel.bitset_fold.fold_counts", 3)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn(2, "world2_cases", tmp_path_factory.mktemp("w2"),
                 _mesh_graph(PG), T_MESH, SEED_MESH, FAULT_CASES)


@pytest.mark.parametrize("i", range(len(FAULT_CASES)),
                         ids=[c[1] for c in FAULT_CASES])
def test_injected_fault_at_world2_degrades_alike_on_both_ranks(
        world2, mesh_reference, i):
    for rank, res in enumerate(world2):
        run = res["faults"]
        assert run[i]["degradations"] == 1, (rank, FAULT_CASES[i])
        assert run[i]["lossless"]
        assert _same(run[i], mesh_reference), (rank, FAULT_CASES[i])


@pytest.mark.parametrize("key", ["ranked", "accept", "partner", "bits",
                                 "alive", "counts", "rows"])
def test_arena_split_at_world2_equals_the_whole_arena(world2, key):
    """The arena's v1 ranking and fold, the proposal round and the
    downloads of an arena split over 2 ranks equal the whole arena's."""
    for res in world2:
        whole, split = res["arena"]["whole"], res["arena"]["split"]
        assert whole["shards"] == 1 and split["shards"] == 2
        a, b = whole[key], split[key]
        if key == "counts":
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b)
    assert world2[0]["arena"]["whole"]["accept"].any()
