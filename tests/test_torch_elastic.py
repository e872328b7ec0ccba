"""Elastic re-meshing of a live train state (`train/elastic.py`) and the
rule that places its blocks (`launch/mesh.rank_device`).

A gloo world of 4 CPU ranks runs `multi_rank_smoke.py`'s elastic part as
its ``--cpu`` rehearsal does: the qwen2.5-3b smoke model's train state
under `train_step.state_specs`, two steps on `make_host_mesh(1, 4)`, then
`remesh_state` with no device named onto (2, 2), back to (1, 4), down to
(1, 2) on ranks 0 and 1 (2 and 3 holding no block), to (2, 1) and back
to (1, 2). At every move the moved blocks equal bit for bit
`checkpoint.restore(mesh=, specs=)` of the state saved before it, on the
same target mesh, and one step from each gives the same loss — the CPU
twin of the four-card run.

The same start state, moved through the same meshes under the same
specs, is then held to the JAX package's ``remesh_state`` in a
subprocess with 8 host devices (as `test_torch_sharding.py` runs the
reference's meshes): each member's blocks equal bit for bit the
addressable shard of the reference's array on the device of its rank.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as M
from repro_torch.train import elastic as EL
from torch_dist import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOVES = ((range(4), 2), (range(4), 4), ((0, 1), 2), ((0, 1), 1), ((0, 1), 2))
SHAPES = [[2, 2], [1, 4], [1, 2], [2, 1], [1, 2]]
IDS = ["to_2x2", "back_1x4", "shrink_1x2", "to_2x1", "back_1x2"]
WORLD = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    return spawn(WORLD, "elastic_train_world", tmp, str(tmp / "ckpt"), MOVES)


@pytest.mark.parametrize("move", range(len(MOVES)), ids=IDS)
def test_remeshed_state_equals_the_restored_checkpoint(world, move):
    ranks = list(MOVES[move][0])
    for rank, res in enumerate(world):
        rec = res["records"][move]
        assert rec["to"] == SHAPES[move]
        assert rec["ok"], rec
        if rank not in ranks:
            assert not rec["member"] and "digests" not in rec  # no block
            continue
        assert rec["member"] and rec["bit_equal"] and rec["digests"]
        assert rec["loss"] == rec["loss_restored"]
        assert np.isfinite(rec["loss"])


def test_remeshed_blocks_cut_the_state_by_the_target_mesh(world):
    """Each member's blocks are its cut of the same global state: a rank
    holds more at (1, 2) than at (1, 4), and the two ranks of one model
    block at (2, 2) hold the same parameters."""
    recs = [[res["records"][m] for res in world] for m in range(len(MOVES))]
    sizes = [[r["bytes_a_rank"] for r in rs if r["member"]] for rs in recs]
    assert sizes[2][0] > sizes[1][0]  # (1, 2) holds more than (1, 4)
    n_params = len(recs[0][0]["digests"]) // 3  # m, step, v, then params
    assert n_params > 0
    for rank in (0, 1):  # (data 0, model r) and (data 1, model r)
        assert (recs[0][rank]["digests"][-n_params:]
                == recs[0][rank + 2]["digests"][-n_params:])


def test_gloo_remesh_keeps_blocks_on_the_cpu(world):
    """With no device named, a gloo group's blocks travel and stay on the
    CPU (what `elastic_world` in `test_torch_sharding.py` reads)."""
    assert inspect.signature(EL.remesh_state).parameters["device"].default \
        is None
    assert inspect.signature(EL.gather_full).parameters["device"].default \
        is None
    for res in world:
        for rec in res["records"]:
            if rec["member"]:
                assert rec["devices"] == ["cpu"] and rec["on_rank_device"]


# ------------------------------------------------ the reference's moves
REF_REMESH = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_enable_x64", True)  # keep every dtype as given
    import ml_dtypes
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.train.elastic import make_mesh_for, remesh_state

    leaves = np.load(sys.argv[1])
    with open(sys.argv[2]) as f:
        plan = json.load(f)
    devs = jax.devices()

    def tree(specs):  # leaf i under a key that sorts as i
        return {f"{i:04d}": P(*[tuple(e) if isinstance(e, list) else e
                                 for e in s]) for i, s in enumerate(specs)}

    def dtype(name):
        return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)

    state = {f"{i:04d}": np.frombuffer(leaves[str(i)].tobytes(), dtype(d))
             .reshape(s) for i, (d, s) in enumerate(plan["leaves"])}
    state = remesh_state(state, make_mesh_for(devs[:4], 4),
                         lambda st, m: tree(plan["specs"][0]))
    out = {}
    for k, (ranks, mp) in enumerate(plan["moves"]):
        mesh = make_mesh_for([devs[r] for r in ranks], mp)
        state = remesh_state(state, mesh,
                             lambda st, m: tree(plan["specs"][k + 1]))
        out[f"{k}/shape"] = np.array(mesh.devices.shape)
        for i, key in enumerate(sorted(state)):
            for sh in state[key].addressable_shards:
                data = np.array(sh.data)  # a C-ordered copy, 0-d kept
                out[f"{k}/{sh.device.id}/{i}"] = data.reshape(-1).view(
                    np.uint8)
                out[f"{k}/{sh.device.id}/{i}/shape"] = np.array(data.shape)
    np.savez(sys.argv[3], **out)
    print("REMESHED", len(out))
""")


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference(world, tmp_path_factory):
    """The reference's blocks: `repro.train.elastic.remesh_state` of the
    port's start state, placed on (1, 4) and moved through ``MOVES`` under
    the port's specs, on 8 host devices."""
    tmp = tmp_path_factory.mktemp("elastic_ref")
    start, specs = world[0]["start"], world[0]["specs"]
    np.savez(tmp / "leaves.npz", **{str(i): b for i, (_, _, b) in
                                    enumerate(start)})
    plan = {"leaves": [[d, list(s)] for d, s, _ in start],
            "specs": [[_spec_json(s) for s in ss] for ss in specs],
            "moves": [[list(r), mp] for r, mp in MOVES]}
    (tmp / "plan.json").write_text(json.dumps(plan))
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", REF_REMESH,
                        str(tmp / "leaves.npz"), str(tmp / "plan.json"),
                        str(tmp / "out.npz")],
                       capture_output=True, text=True, env=env, cwd=ROOT)
    assert "REMESHED" in r.stdout, r.stderr[-2000:]
    with np.load(tmp / "out.npz") as f:
        return dict(f)


@pytest.mark.parametrize("move", range(len(MOVES)), ids=IDS)
def test_remeshed_blocks_equal_the_reference_shards(world, reference,
                                                    move):
    """Every member's block of every leaf equals, bit for bit, the shard
    that the reference's ``device_put`` leaves on the device of the same
    index; ranks off the target mesh hold none, and the reference puts
    nothing on their devices."""
    assert list(reference[f"{move}/shape"]) == SHAPES[move]
    ranks = list(MOVES[move][0])
    for rank, res in enumerate(world):
        blocks = res["blocks"][move]
        assert res["specs"][move + 1] == world[0]["specs"][move + 1]
        if rank not in ranks:
            assert blocks is None and f"{move}/{rank}/0" not in reference
            continue
        assert len(blocks) == len(res["specs"][move + 1]) > 0
        for i, (_, shape, got) in enumerate(blocks):
            assert list(shape) == list(reference[f"{move}/{rank}/{i}/shape"])
            np.testing.assert_array_equal(got, reference[f"{move}/{rank}/{i}"])


class _Mesh:
    def __init__(self, device_type):
        self.device_type = device_type


@pytest.mark.parametrize("kind,device,want", [
    ("cuda", None, torch.device("cuda", 3)),
    ("cpu", None, torch.device("cpu")),
    ("cuda", "cpu", torch.device("cpu")),
    ("cpu", "cuda:1", torch.device("cuda", 1)),
    ("cuda", torch.device("cuda", 0), torch.device("cuda", 0)),
], ids=["nccl-card", "gloo-cpu", "explicit-cpu", "explicit-card",
        "explicit-device"])
def test_rank_device_follows_the_mesh_unless_told(kind, device, want,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert M.rank_device(_Mesh(kind), device) == want
