"""The port's dry run (`launch/dryrun.py`): the unchanged step on meta
tensors in a fake world of many ranks, counted by `launch.step_analysis`.

A mini dry run on a fake world of 8 at a ``(2, 4)`` mesh — smoke configs
of a dense, an MLA + MoE, a hybrid and an encoder-decoder model, train,
prefill and decode — must count
what a real gloo run of the same step on the same mesh counts on the CPU
(`tests/torch_dist.py`, rank 0): FLOPs, bytes, collective bytes and counts
by category, and the flash kernel's launches. The CLI's records carry the
reference's keys; a full-attention arch's ``long_500k`` is skipped; the
summarize cell runs on a production mesh. The card's tests (marked
``cuda``) hold a real qwen2.5-3b prefill's counts on the card to the dry
run's on meta, and the analytic memory of its train state to its tensors.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dp_axes_of, make_host_mesh
from torch_dist import spawn

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"train": ShapeConfig("t", 16, 4, "train"),
          "prefill": ShapeConfig("p", 16, 4, "prefill"),
          "decode": ShapeConfig("d", 16, 4, "decode")}
CASES = [(arch, SHAPES[kind]) for arch in ("qwen2.5-3b",
                                           "deepseek-v2-lite-16b",
                                           "zamba2-7b", "whisper-small")
         for kind in SHAPES]
IDS = [f"{a}-{s.kind}" for a, s in CASES]
KEYS = ("flops", "bytes", "coll_bytes", "coll", "coll_count", "kernels")


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    return spawn(8, "dryrun_counts", tmp_path_factory.mktemp("dry8"), (2, 4),
                 CASES)[0]


@pytest.fixture(scope="module")
def fake_counts():
    with dryrun.fake_world(8):
        mesh = make_host_mesh(2, 4)
        return [dryrun.count_step(get_config(a, smoke=True), s, mesh,
                                  dp_axes_of(mesh)) for a, s in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_mini_dry_run_counts_what_a_gloo_run_counts(i, gloo_counts,
                                                    fake_counts):
    real, dry = gloo_counts[i], fake_counts[i]
    for key in KEYS:
        assert dry[key] == real[key], key
    assert dry["coll_bytes"] > 0  # the model axis communicates
    # training attends through the chunked twin, serving through the kernel
    if CASES[i][1].kind == "train":
        assert "flash_attention" not in dry["kernels"]
    elif CASES[i][1].kind == "prefill":
        assert dry["kernels"]["flash_attention"]["launches"] > 0


def test_a_fake_world_holds_the_production_meshes():
    from repro_torch.launch.mesh import make_production_mesh, model_group

    import torch.distributed as dist

    for multi, world in ((False, 256), (True, 512)):
        with dryrun.fake_world(world):
            mesh = make_production_mesh(multi_pod=multi)
            assert dist.get_world_size(model_group(mesh)) == 16
            assert dp_axes_of(mesh) == (("pod", "data") if multi
                                        else ("data",))
        assert not dist.is_initialized()


def test_cli_records_a_decode_cell_a_skip_and_the_summarize_step(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
            str(tmp_path), "--mesh", "single"]
    runs = [["--arch", "mamba2-130m", "--shape", "decode_32k"],
            ["--arch", "qwen2.5-3b", "--shape", "long_500k"],
            ["--summarize-step", "--hist", "scatter"]]
    for extra in runs:
        out = subprocess.run(base + extra, env=env, capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr
    rec = json.loads((tmp_path / "mamba2-130m__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    for key in ("hlo_flops", "hlo_bytes", "coll_bytes", "coll_breakdown",
                "t_compute", "t_memory", "t_collective", "bottleneck",
                "roofline_fraction", "per_device_hbm", "analytic_hbm",
                "traced_peak_bytes", "model_bytes"):
        assert key in rec, key
    assert rec["per_device_hbm"] == rec["traced_peak_bytes"] > 0
    assert rec["model_bytes"] > 0 and rec["t_memory"] > 0
    skip = json.loads((tmp_path / "qwen2.5-3b__long_500k__single.json")
                      .read_text())
    assert skip["status"] == "skipped"
    summ = json.loads((tmp_path / "slugger-summarize__edges_1b__single.json")
                      .read_text())
    assert summ["status"] == "ok"
    assert summ["coll_breakdown"]["count"]["all-reduce"] == 1
    assert summ["coll_breakdown"]["all-reduce"] == 64_000_000 * 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")


@pytest.mark.cuda
def test_cuda_prefill_counts_equal_the_dry_run_on_meta():
    """qwen2.5-3b cut to 2 layers, one bf16 prefill of 2 × 256 on the card
    through the flash kernel, counted; the same step on meta counts
    alike, the kernel launched once a layer."""
    import dataclasses

    from repro_torch.kernels.flash_attn import kernel as KF
    from repro_torch.models import transformer as T

    _need_card()
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=2)
    shape = ShapeConfig("p", 256, 2, "prefill")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 256), device="cuda",
                         dtype=torch.int32)
    before = KF.LAUNCHES
    card = dryrun.count_one_rank(cfg, shape, device="cuda", params=params,
                                 inputs={"tokens": toks})
    assert KF.LAUNCHES - before == cfg.n_layers
    meta = dryrun.count_one_rank(cfg, shape)
    for key in ("flops", "bytes", "kernels"):
        assert card[key] == meta[key], key


@pytest.mark.cuda
def test_cuda_one_device_terms_are_the_state_bytes():
    """`analytic_hbm`'s ``params`` and ``opt_moments`` on one card are the
    bytes of a real train state's tensors there."""
    from repro_torch.configs.base import SHAPES as PROD
    from repro_torch.launch.memory_model import analytic_hbm
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    _need_card()
    cfg = get_config("qwen2.5-3b", smoke=True)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    state = TS.init_state(params)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    got = analytic_hbm(cfg, PROD["train_4k"], {"data": 1, "model": 1},
                       ("data",))
    assert got["params"] == nbytes(state["params"])
    assert got["opt_moments"] == nbytes(state["opt"]["m"]) + nbytes(
        state["opt"]["v"])


def test_summarize_step_with_sharded_outputs_holds_the_blocks(tmp_path):
    """``sharded_out`` (the reference's §Perf iteration): on two gloo
    ranks each holds its block of the root shingles and of the group
    sizes, and the blocks make up the replicated outputs and the one-
    device step's."""
    import numpy as np

    from repro_torch.core.distributed import summarize_step_fn
    from repro_torch.graphs import generators as PG

    g = PG.caveman(10, 6, 0.1, seed=3)
    el = g.edge_list()
    src = np.concatenate([el[:, 0], el[:, 1]]).astype(np.int64)
    dst = np.concatenate([el[:, 1], el[:, 0]]).astype(np.int64)
    root_of = np.random.default_rng(0).integers(0, g.n // 2, size=g.n)
    ranks = spawn(2, "summarize_step_world", tmp_path, src, dst, root_of,
                  g.n, 7)
    for hist in ("sort", "scatter"):
        one = [t.numpy() for t in summarize_step_fn(g.n, hist)(
            torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(root_of), 7)]
        for r in ranks:
            for got, want in zip(r[hist, False], one):
                np.testing.assert_array_equal(got, want)
        for i in range(2):
            whole = np.concatenate([r[hist, True][i] for r in ranks])
            np.testing.assert_array_equal(whole, one[i])
