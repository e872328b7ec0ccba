"""Slice E5 of the port: data-parallel training with ZeRO-1
(`train/train_step.py` under a mesh), the compressed all-reduce
(`optim/grad_compression.compressed_psum`), the sharded batches
(`data/pipeline.py`), checkpoints across rank counts
(`train/checkpoint.py`) and the driver under a process group
(`launch/train.py`).

The ranks run in gloo process groups on the CPU (`torch_dist.spawn`, one
spawn a group, shared by the cases that read it). On all six families'
smoke models in f32, three data-parallel steps at world 2 equal the
single-device step on the whole batch at the reference's tolerance (atol
2e-4, rtol 1e-3), MoE's load-balancing loss taken over the global batch;
at world 1 they are equal bit for bit. `compressed_psum` at world 4 is
held bit for bit to the reference's in ``shard_map`` over 4 host devices
(a subprocess, as the reference's own test runs).
"""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.launch import train as LT
from repro_torch.models import sharding as SH

from torch_dist import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["qwen2.5-3b", "internvl2-26b", "mamba2-130m",
            "deepseek-v2-lite-16b", "zamba2-7b", "whisper-small"]
ATOL, RTOL = 2e-4, 1e-3
STEPS, BATCH, SEQ = 3, 4, 32
CKPT_ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dp_ckpt"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, ckpt_dir):
    return spawn(2, "dp_train", tmp_path_factory.mktemp("dp2"), FAMILIES,
                 STEPS, BATCH, SEQ, ckpt_dir, CKPT_ARCH)[0:2]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return spawn(1, "dp_train", tmp_path_factory.mktemp("dp1"), FAMILIES,
                 STEPS, BATCH, SEQ, str(tmp_path_factory.mktemp("unused")),
                 None)[0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_step_at_world2_equals_the_single_device_step(world2, arch):
    for rank, res in enumerate(world2):
        r = res[arch]
        for s, (a, b) in enumerate(zip(r["md"], r["m1"])):
            for k in ("loss", "grad_norm", "lr"):
                assert math.isclose(a[k], b[k], rel_tol=RTOL,
                                    abs_tol=ATOL), (rank, s, k, a[k], b[k])
        for i, (a, b) in enumerate(zip(r["pd"], r["p1"])):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{arch} leaf {i}")
        for i, (a, b) in enumerate(zip(r["momd"], r["mom1"])):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{arch} moment {i}")
    # every rank ends with the same parameters, bit for bit
    for a, b in zip(world2[0][arch]["pd"], world2[1][arch]["pd"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_step_at_world1_is_the_single_device_step_bit_for_bit(world1,
                                                                 arch):
    r = world1[arch]
    assert r["md"] == r["m1"]
    for a, b in zip(r["pd"], r["p1"]):
        assert np.array_equal(a, b)
    for a, b in zip(r["momd"], r["mom1"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_zero1_moment_slices_follow_zero1_spec(world2, arch):
    from repro_torch.optim.adamw import leaves

    for rank, res in enumerate(world2):
        r = res[arch]
        specs = leaves(r["specs"])
        for p, spec, shard, local in zip(r["pd"], specs, r["shards"],
                                         r["m_local"]):
            dims = [i for i, ax in enumerate(spec) if ax == "data"]
            if not dims:
                assert shard is None and tuple(local) == p.shape
                continue
            d = dims[0]
            assert shard == (d, rank * p.shape[d] // 2, p.shape[d] // 2)
            want = list(p.shape)
            want[d] //= 2
            assert tuple(local) == tuple(want)
        assert any(s is not None for s in r["shards"])


def test_moe_aux_is_the_global_batch_loss():
    """Under a data mesh context the two per-expert means reduce over the
    ranks: `_global_mean` with no group is the identity, and the world-2
    MoE step (above) matches the whole-batch step only because of it."""
    import torch

    from repro_torch.models import moe

    x = torch.rand(3, 4)
    assert moe._global_mean(x, None) is x
    with SH.mesh_context({"data": 1}, ("data",)):
        assert SH.data_group() is None


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-26b",
                                  "whisper-small"])
def test_batch_sharded_rows_equal_batch_np(world2, arch):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import TokenStream, make_batch

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    stream = TokenStream(cfg.vocab, BATCH, SEQ, seed=0)
    for s in range(STEPS):
        whole = make_batch(cfg, stream, s, device="cpu")
        for rank, res in enumerate(world2):
            rows = res[arch]["rows"][s]
            assert set(rows) == set(whole)
            for k, v in whole.items():
                want = v.float().numpy()[rank * 2:(rank + 1) * 2]
                assert np.array_equal(rows[k], want), (k, s, rank)
        want = stream.batch_np(s)
        assert np.array_equal(world2[0][arch]["rows"][s]["tokens"],
                              want[:2].astype(np.float32))


@pytest.fixture(scope="module")
def restored1(tmp_path_factory, world2, ckpt_dir):
    return spawn(1, "dp_restore", tmp_path_factory.mktemp("rs1"), CKPT_ARCH,
                 ckpt_dir)[0]


def test_checkpoint_saved_at_world2_restores_at_world1(world2, restored1):
    saved = world2[0][CKPT_ARCH]["saved"]
    assert restored1["at"] == STEPS and restored1["step"] == saved["step"]
    for key in ("p", "m", "v"):
        for a, b in zip(restored1[key], saved[key]):
            assert np.array_equal(a, b)
    # world 1 holds whole moments
    assert [tuple(s) for s in restored1["m_local"]] == \
        [a.shape for a in saved["m"]]


# ------------------------------------------------------------ the driver
CLI = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
       "--ckpt-every", "2", "--log-every", "100"]
BF16 = dict(rel_tol=2e-2, abs_tol=2e-2)  # the smoke model trains in bf16


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_ckpt"))
    two = spawn(2, "dp_cli", tmp_path_factory.mktemp("cli2"),
                CLI + ["--data-parallel", "2", "--steps", "4",
                       "--ckpt-dir", d])
    one = spawn(1, "dp_cli", tmp_path_factory.mktemp("cli1"),
                CLI + ["--steps", "6", "--resume", "--ckpt-dir", d])[0]
    plain = LT.main(CLI + ["--steps", "6", "--ckpt-dir",
                           str(tmp_path_factory.mktemp("cli0"))])
    return two, one, plain


def test_driver_trains_data_parallel_and_resumes_on_fewer_ranks(cli_runs):
    two, one, plain = cli_runs
    assert len(two[0]) == len(two[1]) == 4 and two[0] == two[1]
    assert len(one) == 2 and len(plain) == 6
    for a, b in zip(two[0] + one, plain):
        assert math.isfinite(a) and math.isclose(a, b, **BF16), (a, b)


def test_driver_refuses_a_world_that_is_not_its_data_axis(tmp_path):
    with pytest.raises(ValueError, match="world of 2"):
        LT.main(CLI + ["--data-parallel", "2", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="world of 2"):
        LT.main(CLI + ["--model-parallel", "2", "--ckpt-dir",
                       str(tmp_path)])


# ------------------------------------------------------- compressed psum
N_COMP, REPS = 4096, 64

REF_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.optim.grad_compression import compressed_psum

    try:
        mesh = jax.make_mesh((4,), ("data",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    except AttributeError:
        mesh = jax.make_mesh((4,), ("data",))
    try:
        shard_map = jax.shard_map
    except AttributeError:
        from jax.experimental.shard_map import shard_map
    g = jnp.asarray(np.load(sys.argv[1]))

    def body(gg, ee):
        out, ne = compressed_psum(gg[0], ee[0], ("data",))
        return out[None], ne[None]

    out, err = shard_map(body, mesh=mesh,
                         in_specs=(P("data", None), P("data", None)),
                         out_specs=(P("data", None), P("data", None)))(
        g, jnp.zeros_like(g))
    np.save(sys.argv[2], np.asarray(out))
    np.save(sys.argv[3], np.asarray(err))
    print("PSUM_OK")
""")


def _grads():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(4, N_COMP)).astype(np.float32)
    g[:, :256] *= 1e-3  # a block of small values
    g[2, 300] = 40.0    # one rank's outlier sets its block's scale
    return g


@pytest.fixture(scope="module")
def world4_psum(tmp_path_factory):
    return spawn(4, "compress_world", tmp_path_factory.mktemp("cp4"),
                 _grads(), REPS)


def test_compressed_psum_at_world4_equals_the_reference_bit_for_bit(
        world4_psum, tmp_path):
    g = _grads()
    np.save(tmp_path / "g.npy", g)
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", REF_PSUM,
                        str(tmp_path / "g.npy"), str(tmp_path / "out.npy"),
                        str(tmp_path / "err.npy")],
                       capture_output=True, text=True, env=env, cwd=ROOT)
    assert "PSUM_OK" in r.stdout, r.stderr[-2000:]
    out, err = np.load(tmp_path / "out.npy"), np.load(tmp_path / "err.npy")
    for rank, (mean, new_err, _) in enumerate(world4_psum):
        assert np.array_equal(mean, out[rank]), rank
        assert np.array_equal(new_err, err[rank]), rank


def test_compressed_psum_with_a_generator_is_unbiased(world4_psum):
    g = _grads()
    exact = g.mean(0)
    xb = np.pad(g, ((0, 0), (0, (-N_COMP) % 256))).reshape(4, -1, 256)
    step = np.repeat(np.abs(xb).max(axis=(0, 2)) / 127.0, 256)[:N_COMP]
    for _, _, avg in world4_psum:
        # each draw's rounding error per entry is under one step; the
        # average of REPS unbiased draws sits within a few steps/sqrt(REPS)
        assert (np.abs(avg - exact) <= 6 * step / np.sqrt(REPS) + 1e-7).all()
    assert np.array_equal(world4_psum[0][2], world4_psum[3][2])
