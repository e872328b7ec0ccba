"""The port's analytic per-device memory (`launch/memory_model.py`).

Every term of ``analytic_hbm`` must equal the JAX package's exactly, for
all 10 architectures × 4 shapes at the ``(1, 1)``, ``(16, 16)`` and
``(2, 16, 16)`` meshes: the port reads a plain ``{axis: size}`` mapping,
the reference a duck-typed mesh with the same ``shape`` (its model reads
only ``mesh.shape``), so no devices are needed. On one device the
``params`` and ``opt_moments`` terms are the bytes of a real train
state's tensors (on the card too: the ``cuda`` test in
`tests/test_torch_dryrun.py`, a file without jax).
"""
import types

import pytest
import torch

from repro.configs.base import SHAPES as RSHAPES
from repro.configs.registry import ARCH_NAMES
from repro.configs.registry import get_config as ref_config
from repro.launch import memory_model as RMM
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import memory_model as MM

MESHES = {"1x1": ({"data": 1, "model": 1}, ("data",)),
          "16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_term_equals_the_reference(arch, mesh):
    sizes, dp = MESHES[mesh]
    duck = types.SimpleNamespace(shape=dict(sizes))
    for shape in SHAPES:
        want = RMM.analytic_hbm(ref_config(arch), RSHAPES[shape], duck, dp)
        got = MM.analytic_hbm(get_config(arch), SHAPES[shape], sizes, dp)
        assert got == want, (shape, got, want)


@pytest.mark.parametrize("micro", [None, 32, 4])
def test_microbatch_and_moment_bytes_equal_the_reference(micro):
    sizes, dp = MESHES["2x16x16"]
    duck = types.SimpleNamespace(shape=dict(sizes))
    for arch in ("qwen3-moe-235b-a22b", "zamba2-7b", "whisper-small"):
        want = RMM.analytic_hbm(ref_config(arch), RSHAPES["train_4k"], duck,
                                dp, microbatch=micro, opt_bytes_per_param=4)
        got = MM.analytic_hbm(get_config(arch), SHAPES["train_4k"], sizes,
                              dp, microbatch=micro, opt_bytes_per_param=4)
        assert got == want


def test_shard_factor_and_tree_bytes():
    sizes = {"data": 4, "model": 2}
    assert MM._shard_factor(("data", None), (8, 3), sizes) == 4
    assert MM._shard_factor(("data", "model"), (8, 6), sizes) == 8
    assert MM._shard_factor((("data", "model"),), (16,), sizes) == 8
    assert MM._shard_factor(("data",), (9,), sizes) == 1  # non-divisible
    tree = {"a": torch.empty((8, 6), dtype=torch.bfloat16, device="meta"),
            "b": {"c": torch.empty((5,), device="meta")}}
    specs = {"a": ("data", "model"), "b": {"c": (None,)}}
    assert MM._tree_bytes(tree, specs, sizes) == 8 * 6 * 2 / 8 + 5 * 4
    assert MM._tree_bytes(tree, specs, sizes, dtype_bytes=4) == \
        8 * 6 * 4 / 8 + 5 * 4


def _state_terms(device):
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS

    cfg = get_config("qwen2.5-3b", smoke=True)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    state = TS.init_state(params)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    got = MM.analytic_hbm(cfg, SHAPES["train_4k"], MESHES["1x1"][0],
                          ("data",))
    return got, nbytes(state["params"]), nbytes(state["opt"]["m"]) + nbytes(
        state["opt"]["v"])


def test_one_device_terms_are_the_state_bytes():
    got, params, moments = _state_terms("cpu")
    assert got["params"] == params
    assert got["opt_moments"] == moments

