"""The port stands alone: `src/repro_torch`, `chip_smoke.py`,
`flash_bench.py`, `popc_bench.py`, `rank_count_bench.py`,
`serve_bench.py`, `multi_rank_smoke.py` and `examples/torch_*.py` import
neither jax nor the JAX package (nor
``ml_dtypes``, which the card's machine does
not have), entry points default to the CUDA card and refuse to fall back
to the CPU, and the unported paths say so."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.graphs import generators as PG

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "summarize_and_query", "moe_routing_graph",
            "serve_lm", "train_lm")
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flash_bench.py", ROOT / "popc_bench.py",
    ROOT / "rank_count_bench.py", ROOT / "multi_rank_smoke.py",
    ROOT / "serve_bench.py"] + [
    ROOT / "examples" / f"torch_{name}.py" for name in EXAMPLES]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("src/repro_torch/core/engine.py",
                 "src/repro_torch/core/resident.py",
                 "src/repro_torch/kernels/bitset_jaccard/kernel.py",
                 "src/repro_torch/kernels/bitset_fold/kernel.py",
                 "src/repro_torch/kernels/bitset_fold/carry.py",
                 "src/repro_torch/kernels/seghist/kernel.py",
                 "src/repro_torch/core/query_batch.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/local_ranks.py",
                 "src/repro_torch/launch/summary_serve.py",
                 "src/repro_torch/kernels/interval_expand/kernel.py",
                 "src/repro_torch/kernels/interval_expand/ops.py",
                 "src/repro_torch/kernels/interval_expand/ref.py",
                 "src/repro_torch/kernels/minhash/kernel.py",
                 "src/repro_torch/kernels/minhash/ops.py",
                 "src/repro_torch/kernels/minhash/ref.py",
                 "src/repro_torch/kernels/bitset_jaccard/ops.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/registry.py",
                 "src/repro_torch/configs/qwen2_5_3b.py",
                 "src/repro_torch/models/layers.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/models/encdec.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/models/api.py",
                 "src/repro_torch/kernels/flash_attn/kernel.py",
                 "src/repro_torch/kernels/flash_attn/ops.py",
                 "src/repro_torch/kernels/flash_attn/ref.py",
                 "src/repro_torch/interop.py",
                 "src/repro_torch/graphs/partitioned.py",
                 "src/repro_torch/core/checkpoint.py",
                 "src/repro_torch/faults.py",
                 "src/repro_torch/launch/chaos.py",
                 "src/repro_torch/graphs/datasets.py",
                 "src/repro_torch/data/pipeline.py",
                 "src/repro_torch/optim/adamw.py",
                 "src/repro_torch/optim/schedules.py",
                 "src/repro_torch/optim/grad_compression.py",
                 "src/repro_torch/train/train_step.py",
                 "src/repro_torch/train/checkpoint.py",
                 "src/repro_torch/train/fault_tolerance.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/core/distributed.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/models/sharding.py",
                 "src/repro_torch/train/elastic.py",
                 "chip_smoke.py", "flash_bench.py", "popc_bench.py",
                 "rank_count_bench.py", "multi_rank_smoke.py",
                 "serve_bench.py", "src/repro_torch/analysis/core.py",
                 "src/repro_torch/analysis/rules.py",
                 "src/repro_torch/analysis/baseline.py",
                 "src/repro_torch/analysis/lint.py",
                 *(f"examples/torch_{name}.py" for name in EXAMPLES)):
        assert want in names
        assert (ROOT / want).is_file()
    csrc = {p.name for p in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu")}
    assert {"interval_count.cu", "rowmin_hash.cu",
            "pairwise_intersections.cu", "flash_attention.cu"} <= csrc


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_summarize_runs_without_jax_or_reference_loaded():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.graphs import generators as G\n"
        "g = G.caveman(6, 5, 0.1, seed=0)\n"
        "s = repro_torch.summarize(g, T=2, device='cpu')\n"
        "assert s.validate_lossless(g)\n"
        "r = repro_torch.summarize(g, T=2, device='cpu', backend='resident')\n"
        "assert (r.edges == s.edges).all()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_training_runs_without_jax_or_ml_dtypes_loaded(tmp_path):
    """`launch.train` trains, checkpoints bf16 leaves and resumes from them
    with neither jax, the JAX package nor ml_dtypes in the process."""
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        f"args = ['--smoke', '--device', 'cpu', '--batch', '2', '--seq', "
        f"'24', '--ckpt-every', '2', '--ckpt-dir', {str(tmp_path)!r}]\n"
        "train.main(args + ['--steps', '2'])\n"
        "train.main(args + ['--steps', '4', '--resume'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "resumed from step 2" in out.stdout
    assert "LOADED []" in out.stdout


def test_mesh_paths_run_without_jax_or_reference_loaded(tmp_path):
    """Two gloo ranks summarize under a data mesh and take a data-parallel
    train step with neither jax nor the JAX package in either process."""
    from torch_dist import spawn

    for loaded in spawn(2, "isolation_world", tmp_path):
        assert loaded == []


def test_model_axis_serving_runs_without_jax_or_reference_loaded(tmp_path):
    """Two gloo ranks serve the MoE smoke model tensor- and
    expert-parallel through `build_serve_step`, each drawing its own
    blocks, with neither jax nor the JAX package in either process."""
    from torch_dist import spawn

    for loaded in spawn(2, "isolation_serve", tmp_path):
        assert loaded == []


def test_model_axis_training_runs_without_jax_or_reference_loaded(tmp_path):
    """Two gloo ranks train the MoE smoke model tensor- and
    expert-parallel through `build_train_step`, each drawing its own
    blocks, and save and restore a whole-array checkpoint, with neither
    jax nor the JAX package in either process."""
    from torch_dist import spawn

    for loaded in spawn(2, "isolation_train", tmp_path,
                        str(tmp_path / "ckpt")):
        assert loaded == []


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = PG.caveman(4, 4, 0.0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.summarize(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.SummarizerEngine(backend="numpy")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.summarize(g, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.summarize(g, backend="resident")
    from repro_torch.core.distributed import summarize_jax
    with pytest.raises(RuntimeError, match="CUDA"):
        summarize_jax(g, T=1)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_the_card_unless_told_cpu(name, monkeypatch):
    """Each example defaults to the CUDA card and, without one, fails
    before it computes anything; ``--device cpu`` is the only way onto
    the CPU (`tests/test_torch_examples.py` runs them so)."""
    from test_torch_examples import load_example

    mod = load_example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--device", "cuda"])


def test_default_backend_is_batched():
    engine = repro_torch.SummarizerEngine(device="cpu")
    assert engine.backend == "batched"
    assert engine.device == torch.device("cpu")


@pytest.mark.parametrize("kwargs", [
    {"backend": "resident", "partitions": 2},
    {"partitions": 2},
])
def test_partitions_construct(kwargs):
    engine = repro_torch.SummarizerEngine(device="cpu", **kwargs)
    assert engine.partitions == 2


@pytest.mark.parametrize("kwargs,exc,match", [
    ({"backend": "bogus"}, ValueError, "unknown backend"),
    ({"partitions": 0}, ValueError, "partitions"),
    ({"stages": {"bogus": lambda engine, ctx: None}}, ValueError,
     "unknown stages"),
])
def test_unported_and_invalid_options_raise(kwargs, exc, match):
    with pytest.raises(exc, match=match):
        repro_torch.SummarizerEngine(device="cpu", **kwargs)


def test_engine_times_the_five_stages():
    from repro_torch.core.engine import STAGE_ORDER

    g = PG.caveman(8, 5, 0.05, seed=3)
    engine = repro_torch.SummarizerEngine(T=3, device="cpu")
    s = engine.run(g)
    assert s.validate_lossless(g)
    assert STAGE_ORDER == ("shingle", "group", "pack", "merge_round",
                           "exchange")
    for name in STAGE_ORDER + ("emit", "prune"):
        assert engine.stats[name] >= 0.0, name
    assert len(engine.stats["transfer_iters"]) == 3
    assert engine.stats["merges"] > 0


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_flash_bench_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: flash_bench.py would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "flash_bench.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "kernel_ms" not in out.stdout


def test_popc_bench_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: popc_bench.py would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "popc_bench.py", "--probe"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "kernel_ms" not in out.stdout


@pytest.mark.parametrize("args", [
    [], ["--split"], ["--kernels", "fold_hist"], ["--resident", "--emit"]],
    ids=["ab", "split", "fold_hist", "stages"])
def test_rank_count_bench_fails_without_a_card(args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: rank_count_bench.py would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "rank_count_bench.py", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "kernel_ms" not in out.stdout and "split" not in out.stdout
    assert "stage" not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("backend", ["batched", "resident"])
def test_cpu_path_launches_no_kernel(backend):
    from repro_torch.kernels.bitset_fold import kernel as K3
    from repro_torch.kernels.bitset_jaccard import kernel as K1
    from repro_torch.kernels.seghist import kernel as K2

    def counts():
        return (K1.LAUNCHES, K2.LAUNCHES, K3.TOPJ_LAUNCHES, K3.FOLD_LAUNCHES)

    before = counts()
    g = PG.caveman(10, 6, 0.05, seed=1)
    s = repro_torch.summarize(g, T=3, device="cpu", backend=backend)
    assert s.validate_lossless(g)
    assert counts() == before
    assert np.all(s.edges[:, 0] <= s.edges[:, 1])


def _new_kernel_counts():
    from repro_torch.kernels.bitset_jaccard import kernel as K1
    from repro_torch.kernels.interval_expand import kernel as KI
    from repro_torch.kernels.minhash import kernel as KM

    return (KI.LAUNCHES, KM.LAUNCHES, K1.PAIRWISE_LAUNCHES)


@pytest.mark.parametrize("backend", ["kernel", "torch", "numpy"])
def test_cpu_serving_and_shingles_launch_no_kernel(backend):
    from repro_torch.core import minhash as core_minhash
    from repro_torch.kernels.bitset_jaccard import ops as O1
    from repro_torch.kernels.minhash import ops as OM
    from repro_torch.launch.summary_serve import (SummaryQueryServer,
                                                  make_queries)

    before = _new_kernel_counts()
    g = PG.caveman(10, 6, 0.05, seed=1)
    ps = repro_torch.summarize(g, T=3, device="cpu").pack_for_serving()
    queries = make_queries(g.n, 50, edge_frac=0.5, seed=0)
    answers = SummaryQueryServer(ps, batch_slots=16, backend=backend,
                                 device="cpu").run(queries)
    for q, a in zip(queries, answers):
        if q[0] == "neighbors":
            assert np.array_equal(a, g.neighbors(q[1]))
        else:
            assert a == g.has_edge(q[1], q[2])
    rows, owners = OM.pack_adjacency(g.indptr, g.indices, 8)
    a, b = core_minhash.u32_seed_consts(3)
    sh = OM.node_shingles(torch.from_numpy(rows.view(np.int32)),
                          torch.from_numpy(owners), g.n, int(a), int(b))
    assert np.array_equal(sh.numpy(), core_minhash.node_shingles_u32(g, 3))
    O1.group_jaccard(O1.pack_bitsets([[1, 2], [2, 3]], g.n), device="cpu")
    assert _new_kernel_counts() == before


def test_summary_server_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.summary_serve import SummaryQueryServer

    g = PG.caveman(4, 4, 0.0, seed=0)
    ps = repro_torch.summarize(g, T=2, device="cpu").pack_for_serving()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("kernel", "torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            SummaryQueryServer(ps, backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        SummaryQueryServer(ps)
    assert SummaryQueryServer(ps, backend="numpy").device is None
